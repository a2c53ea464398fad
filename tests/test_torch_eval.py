"""The port's eval harness against sift_tpu's on the CPU, on synthetic
images written under the harness's file names (sift_tpu/eval.py:40-42,
70): one warp image (book.jpg) and one pair (scene.jpg, the book
shifted).
eval_mapping is covered by tests/test_torch_mapping.py's whole-slice
comparison, which runs the same run_mapping.
"""

import hashlib
import json

import cv2
import numpy as np
import pytest
import torch

import chip_smoke

from sift_tpu import eval as jeval

from sift_tpu_torch import eval as teval
from sift_tpu_torch.sfm import mapping as tmap

from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def eval_corpus(tmp_path_factory):
    """A directory with the eval harness's book (its one warp image)
    and a scene that shows it (its one pair), as gray image files."""
    d = tmp_path_factory.mktemp("eval_corpus")
    book = chip_smoke.to_gray(chip_smoke.texture(
        200, 160, seed=7, n_blobs=120)).astype(np.uint8)
    # the scene is the book shifted (one frame size: one compile of
    # sift_tpu's detector for both tests)
    scene = np.roll(book, (9, 14), axis=(0, 1))
    cv2.imwrite(str(d / "book.jpg"), book, [cv2.IMWRITE_JPEG_QUALITY, 95])
    cv2.imwrite(str(d / "scene.jpg"), scene, [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(d)


def test_eval_repeatability_matches_jax(eval_corpus):
    # keypoint counts and repeatability within 1 %; match counts may
    # differ on ratio-borderline rows (sift_tpu's default descriptors
    # are bf16-rounded), so they are held within 10 %
    want = jeval.eval_repeatability(eval_corpus, 640,
                                    np.random.default_rng(0))
    got = teval.eval_repeatability(eval_corpus, 640, np.random.default_rng(0),
                                   device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key in ("kpts", "kpts_warped"):
            assert abs(g[key] - w[key]) <= 0.01 * w[key], (g, w)
        assert abs(g["repeatability"] - w["repeatability"]) <= 0.01
        assert abs(g["matches"] - w["matches"]) <= 0.1 * w["matches"] + 1


def test_eval_pairs_match_jax(eval_corpus):
    want = jeval.eval_pairs(eval_corpus, 640)
    got = teval.eval_pairs(eval_corpus, 640, device="cpu")
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    for key in ("scene_kpts", "object_kpts"):
        assert abs(g[key] - w[key]) <= 0.01 * w[key]
    assert abs(g["good_matches"] - w["good_matches"]) \
        <= 0.1 * w["good_matches"] + 1
    assert g["found"] and w["found"]


def test_eval_gates_and_summary():
    assert teval.GATES == jeval.GATES
    report = {"repeatability": [{"repeatability": 0.7,
                                 "match_precision": 0.9}],
              "pairs": [{"found": True}],
              "mapping": {"n_registered": 15, "n_frames": 16,
                          "n_closures": 2, "ate_final": 0.01,
                          "reproj_rmse": 1e-3, "exported": True}}
    assert teval.summarize(report)["gates_failed"] == []
    report["mapping"]["ate_final"] = 0.08
    report["repeatability"][0]["repeatability"] = 0.5
    assert teval.summarize(report)["gates_failed"] == ["repeatability",
                                                       "mapping"]


def test_eval_records_the_attached_oracle_file(tmp_path):
    rows = [{"image": "book.jpg", "angle": 15, "scale": 1.0,
             "oracle_repeatability": 0.8, "pipeline_repeatability": 0.79}]
    path = tmp_path / "oracle.json"
    path.write_text(json.dumps({"summary": {}, "note": "n", "rows": rows}))
    report = {"repeatability": [{"image": "book.jpg", "angle": 15,
                                 "scale": 1.0}]}
    teval.attach_oracle(report, str(path))
    att = report["oracle_repeatability_comparison"]
    assert att["sha256"] == hashlib.sha256(path.read_bytes()).hexdigest()
    assert att["path"].endswith("oracle.json") and att["rows"] == rows
    assert report["repeatability"][0]["oracle_repeatability_reduced_res"] \
        == 0.8


def test_eval_names_sift_tpus_column_as_sift_tpus(tmp_path, monkeypatch):
    # with only sift_tpu's committed ORACLE_REPEAT.json, whose pipeline
    # column was measured on sift_tpu's pipeline, no row carries that
    # number under the pipeline's name
    monkeypatch.setattr(teval, "ORACLE_REPEAT_TORCH",
                        str(tmp_path / "ORACLE_REPEAT_TORCH.json"))
    with open(teval.ORACLE_REPEAT) as f:
        rows = json.load(f)["rows"]
    report = {"repeatability": [{k: r[k] for k in ("image", "angle",
                                                   "scale")}
                                for r in rows]}
    teval.attach_oracle(report)
    att = report["oracle_repeatability_comparison"]
    assert att["pipeline"] == "sift_tpu"
    assert att["path"] == "ORACLE_REPEAT.json"
    for row, orow in zip(report["repeatability"], rows):
        assert not any(k.startswith("pipeline_") for k in row)
        assert row["sift_tpu_repeatability_reduced_res"] == \
            orow["pipeline_repeatability"]
        assert row["oracle_repeatability_reduced_res"] == \
            orow["oracle_repeatability"]


def test_eval_prefers_the_ports_oracle_file(tmp_path, monkeypatch):
    rows = [{"image": "book.jpg", "angle": 15, "scale": 1.0,
             "oracle_repeatability": 0.8, "pipeline_repeatability": 0.79}]
    path = tmp_path / "ORACLE_REPEAT_TORCH.json"
    path.write_text(json.dumps({"pipeline": "sift_tpu_torch", "summary": {},
                                "note": "n", "rows": rows}))
    monkeypatch.setattr(teval, "ORACLE_REPEAT_TORCH", str(path))
    report = {"repeatability": [{"image": "book.jpg", "angle": 15,
                                 "scale": 1.0}]}
    teval.attach_oracle(report)
    att = report["oracle_repeatability_comparison"]
    assert att["pipeline"] == "sift_tpu_torch"
    assert att["sha256"] == hashlib.sha256(path.read_bytes()).hexdigest()
    assert report["repeatability"][0] == {
        "image": "book.jpg", "angle": 15, "scale": 1.0,
        "oracle_repeatability_reduced_res": 0.8,
        "pipeline_repeatability_reduced_res": 0.79}


@pytest.mark.parametrize("main", [tmap.main, teval.main],
                         ids=["mapping", "eval"])
def test_entry_points_default_to_cuda(main, tmp_path, monkeypatch):
    # without a card the default device is refused, not replaced
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path)] if main is tmap.main else ["--data",
                                                        str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
