"""The port's NumPy oracle (sift_tpu_torch/oracle/cpu_sift.py), and the
port's plain path held against it on the CPU.

The oracle is the port's copy of sift_tpu's: on the same image both give
the same arrays, keypoints and matches, exactly. The port's path is held
against it at the tolerances of sift_tpu's own oracle tests
(tests/test_pyramid.py, test_detect.py and test_match.py): at 160x200
(small_image) with the default configuration, and at 480x640 (small_image
tiled, chip_smoke.oracle_frame) with out_caps raised until no octave
saturates, as chip_smoke.py's phase 8 runs both on the card.
tools/torch_oracle_repeatability.py runs on synthetic image files.
"""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from test_detect import _match_oracle

from sift_tpu import oracle as joracle_pkg
from sift_tpu.config import DEFAULT_CONFIG as JCFG
from sift_tpu.oracle import cpu_sift as joracle

from sift_tpu_torch import oracle as toracle_pkg
from sift_tpu_torch import sift as tsift
from sift_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_tpu_torch.eval import WARP_IMAGES, attach_oracle
from sift_tpu_torch.ops import conv as tconv
from sift_tpu_torch.ops import match as tmatch
from sift_tpu_torch.ops import pyramid as tpyr
from sift_tpu_torch.oracle import cpu_sift as oracle

from _torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
RAISED = dataclasses.replace(CFG, out_caps=chip_smoke.ORACLE_OUT_CAPS)
# tests/test_match.py's crop of small_image (the object of its
# end-to-end match test)
CROP = (slice(24, 120), slice(40, 168))


@pytest.fixture(scope="module")
def oracles(small_image):
    """Both packages' oracles on small_image and its crop: each
    (gpyr, dog, keypoints, descriptors, crop keypoints, crop
    descriptors)."""
    out = {}
    for name, mod, cfg in (("port", oracle, CFG), ("sift_tpu", joracle, JCFG)):
        gpyr = mod.build_gaussian_pyramid(small_image, cfg)
        dog = mod.build_dog_pyramid(gpyr, cfg)
        kpts = mod.find_scale_space_extrema(gpyr, dog, cfg)
        desc = mod.calc_descriptors(gpyr, kpts, cfg)
        ko, do = mod.sift_ncl(small_image[CROP], cfg)
        out[name] = (gpyr, dog, kpts, desc, ko, do)
    return out


@pytest.fixture(scope="module")
def frames(small_image, oracles):
    """{frame: (oracle keypoints, oracle descriptors, port keypoints,
    port descriptors, port config)}: the port's plain path on the CPU."""
    out = {}
    _, _, kpts, desc, _, _ = oracles["port"]
    for name, img, cfg, ref in (
            ("160x200", small_image, CFG, (kpts, desc)),
            ("480x640", chip_smoke.oracle_frame(), RAISED, None)):
        kp, d = tsift.detect_and_compute(torch.from_numpy(img), cfg)
        ref = ref or oracle.sift_ncl(img, cfg)
        out[name] = (*ref, kp, d.numpy(), cfg)
    return out


def test_chip_smoke_frames_are_the_tests(small_image):
    # phase 8 runs on a copy of conftest's small_image and its tiling
    np.testing.assert_array_equal(chip_smoke.small_image(), small_image)
    np.testing.assert_array_equal(chip_smoke.oracle_frame(),
                                  np.tile(small_image, (3, 4))[:480, :640])


def test_oracle_has_sift_tpus_functions():
    assert toracle_pkg.__all__ == joracle_pkg.__all__
    for name in toracle_pkg.__all__:
        assert getattr(toracle_pkg, name) is getattr(oracle, name)
    public = {n for n in vars(joracle) if callable(getattr(joracle, n))
              and not n.startswith("_")}
    assert public <= set(vars(oracle))


@pytest.mark.parametrize("part", ["kernel_and_blur", "pyramid", "dog",
                                  "keypoints", "descriptors", "matches"])
def test_oracle_equals_sift_tpus(oracles, small_image, part):
    # both are NumPy: the same image gives the same results, exactly
    got, want = oracles["port"], oracles["sift_tpu"]
    if part == "kernel_and_blur":
        for sigma in (1.6, 2.2, 4.5):
            np.testing.assert_array_equal(oracle.gaussian_kernel_2d(sigma),
                                          joracle.gaussian_kernel_2d(sigma))
            np.testing.assert_array_equal(
                oracle.gaussian_blur(small_image, sigma),
                joracle.gaussian_blur(small_image, sigma))
    elif part in ("pyramid", "dog"):
        i = 0 if part == "pyramid" else 1
        assert len(got[i]) == len(want[i])
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    elif part == "keypoints":
        assert len(got[2]) > 50
        assert got[2] == want[2] and got[4] == want[4]
    elif part == "descriptors":
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[5], want[5])
    else:
        ref = oracle.match_l1_ratio(got[5], got[3], ratio=0.86)
        assert len(ref) >= 10
        assert ref == joracle.match_l1_ratio(want[5], want[3], ratio=0.86)


@pytest.mark.parametrize("stage", ["kernel", "blur", "blur_boundary",
                                   "pyramid", "dog"])
def test_port_stage_matches_oracle(oracles, small_image, stage):
    # tests/test_pyramid.py's cases and tolerances, port against oracle
    gpyr, dog = oracles["port"][:2]
    if stage == "kernel":
        for sigma in (1.6, 2.2, 4.5):
            k1 = tconv.gaussian_kernel_1d(sigma)
            np.testing.assert_allclose(np.outer(k1, k1),
                                       oracle.gaussian_kernel_2d(sigma),
                                       rtol=2e-6, atol=1e-12)
    elif stage == "blur":
        for sigma in (1.6124515, 2.771281):
            ours = tconv.gaussian_blur(torch.from_numpy(small_image), sigma)
            np.testing.assert_allclose(ours.numpy(),
                                       oracle.gaussian_blur(small_image,
                                                            sigma),
                                       rtol=2e-4, atol=2e-3)
    elif stage == "blur_boundary":
        # reads at the last row/col behave as zeros (src/sift.cpp:116)
        img = np.full((12, 12), 100.0, np.float32)
        ours = tconv.gaussian_blur(torch.from_numpy(img), 1.6).numpy()
        np.testing.assert_allclose(ours, oracle.gaussian_blur(img, 1.6),
                                   rtol=1e-5, atol=1e-3)
        assert ours[-1, 5] < ours[5, 5]
    else:
        octs = tpyr.build_gaussian_pyramid(torch.from_numpy(small_image),
                                           CFG)
        ours = octs if stage == "pyramid" else tpyr.build_dog_pyramid(octs)
        ref = gpyr if stage == "pyramid" else dog
        atol = 5e-3 if stage == "pyramid" else 1e-2
        per = ours[0].shape[0]
        for o in range(CFG.n_octaves):
            for i in range(per):
                assert ours[o][i].shape == ref[o * per + i].shape
                np.testing.assert_allclose(ours[o][i].numpy(),
                                           ref[o * per + i], rtol=3e-4,
                                           atol=atol,
                                           err_msg=f"octave {o} layer {i}")


@pytest.mark.parametrize("frame", ["160x200", "480x640"])
def test_keypoint_recall_vs_oracle(frames, frame):
    kpts_ref, _, kp, _, _ = frames[frame]
    assert len(kpts_ref) > 50
    hits = _match_oracle(kpts_ref, kp)
    recall = float((hits >= 0).mean())
    assert recall >= 0.97, f"recall {recall:.3f} ({len(kpts_ref)} ref)"


@pytest.mark.parametrize("frame", ["160x200", "480x640"])
def test_keypoint_precision_vs_oracle(frames, frame):
    kpts_ref, _, kp, _, _ = frames[frame]
    rx = np.array([k["x"] for k in kpts_ref])
    ry = np.array([k["y"] for k in kpts_ref])
    valid = kp.valid.numpy()
    ok = sum(np.min(np.abs(rx - x) + np.abs(ry - y)) < 0.1
             for x, y in zip(kp.x.numpy()[valid], kp.y.numpy()[valid]))
    precision = ok / max(int(valid.sum()), 1)
    assert precision >= 0.97, f"precision {precision:.3f}"


@pytest.mark.parametrize("frame", ["160x200", "480x640"])
def test_descriptors_match_oracle(frames, frame):
    kpts_ref, desc_ref, kp, desc, _ = frames[frame]
    hits = _match_oracle(kpts_ref, kp)
    matched = np.where(hits >= 0)[0]
    assert len(matched) > 30
    l1 = np.array([np.abs(desc_ref[i] - desc[hits[i]]).sum()
                   for i in matched])
    assert np.median(l1) < 0.05, float(np.median(l1))
    assert np.quantile(l1, 0.9) < 0.2, float(np.quantile(l1, 0.9))


def test_raised_caps_leave_no_octave_saturated(frames):
    # the 480x640 comparison is uncapped, as the reference is: the
    # default out_caps[0] = 1024 would truncate octave 0
    kpts_ref, _, kp, _, cfg = frames["480x640"]
    assert not tsift.octave_saturation(kp, cfg).any()
    per_octave = np.bincount([k["octave"] for k in kpts_ref],
                             minlength=CFG.n_octaves)
    assert per_octave[0] > CFG.out_caps[0]


@pytest.mark.parametrize("frame", ["160x200", "480x640"])
def test_chip_smoke_gates_are_test_detects(frames, frame):
    # phase 8 computes the gates with its own copy of this file's
    # matcher, precision and L1: the same numbers
    kpts_ref, desc_ref, kp, desc, _ = frames[frame]
    g = chip_smoke.oracle_gates(kpts_ref, desc_ref, kp, desc)
    hits = _match_oracle(kpts_ref, kp)
    np.testing.assert_array_equal(g["hits"], hits)
    matched = np.where(hits >= 0)[0]
    l1 = np.array([np.abs(desc_ref[i] - desc[hits[i]]).sum()
                   for i in matched])
    np.testing.assert_allclose(g["l1"], (np.median(l1),
                                         np.quantile(l1, 0.9), l1.max()),
                               rtol=1e-5, atol=1e-7)
    assert g["recall"] == float((hits >= 0).mean())
    assert g["port"] == int(kp.valid.sum()) and g["oracle"] == len(kpts_ref)
    chip_smoke.check_oracle_gates(frame, g)


def _descs(n, rng):
    d = rng.random((n, 128)).astype(np.float32) ** 2
    d /= d.sum(axis=1, keepdims=True)
    return np.sqrt(d)


def _brute_knn2(q, t):
    d = np.abs(q[:, None, :] - t[None, :, :]).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    i1 = order[:, 0]
    return i1, d[np.arange(len(q)), i1], d[np.arange(len(q)), order[:, 1]]


@pytest.mark.parametrize("case", ["knn2", "train_mask", "ratio"])
def test_matcher_matches_oracle(case):
    # tests/test_match.py's cases against the port's matcher
    rng = np.random.default_rng(0)
    q, t = _descs(300, rng), _descs(450, rng)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    if case == "knn2":
        r = tmatch.knn2_l1(tq, tt)
        i1, d1, d2 = _brute_knn2(q, t)
        np.testing.assert_array_equal(r.idx.numpy(), i1)
        np.testing.assert_allclose(r.d1.numpy(), d1, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r.d2.numpy(), d2, rtol=2e-5, atol=2e-5)
    elif case == "train_mask":
        t_valid = np.ones(len(t), bool)
        t_valid[::3] = False
        r = tmatch.knn2_l1(tq, tt, torch.from_numpy(t_valid))
        i1, d1, _ = _brute_knn2(q, t[t_valid])
        np.testing.assert_array_equal(r.idx.numpy(),
                                      np.where(t_valid)[0][i1])
        np.testing.assert_allclose(r.d1.numpy(), d1, rtol=2e-5, atol=2e-5)
    else:
        res = tmatch.match_ratio(tq, tt, ratio=0.86)
        good, tidx = res.good.numpy(), res.train_idx.numpy()
        ref = oracle.match_l1_ratio(q, t, ratio=0.86)
        assert {(qi, ti) for qi, ti, _ in ref} == {
            (int(i), int(tidx[i])) for i in np.where(good)[0]}


def test_end_to_end_match_recall(oracles, frames, small_image):
    # tests/test_match.py's end-to-end case: the oracle's good matches
    # of the crop against small_image, reproduced by the port's with
    # both endpoints within 0.5 px
    _, _, ks_ref, ds_ref, ko_ref, do_ref = oracles["port"]
    kps = frames["160x200"][2]
    ds = torch.from_numpy(frames["160x200"][3])
    kpo, do = tsift.detect_and_compute(torch.from_numpy(small_image[CROP]),
                                       CFG)
    res = tmatch.match_ratio(do, ds, q_valid=kpo.valid, t_valid=kps.valid)
    ref = oracle.match_l1_ratio(do_ref, ds_ref, ratio=0.86)
    assert len(ref) >= 10
    good = np.where(res.good.numpy())[0]
    ti = res.train_idx.numpy()
    got = [(kpo.x[q].item(), kpo.y[q].item(), kps.x[ti[q]].item(),
            kps.y[ti[q]].item()) for q in good]
    hits = 0
    for qi, tj, _ in ref:
        qr, tr = ko_ref[qi], ks_ref[tj]
        hits += any(abs(a - qr["x"]) < .5 and abs(b - qr["y"]) < .5
                    and abs(c - tr["x"]) < .5 and abs(d - tr["y"]) < .5
                    for a, b, c, d in got)
    recall = hits / len(ref)
    assert recall >= 0.9, f"match recall {recall:.3f} over {len(ref)} ref"
    # phase 8c's copy of this recall gives the same number
    assert chip_smoke.oracle_match_recall(ref, ko_ref, ks_ref, kpo, kps,
                                          res) == pytest.approx(recall)


def _tool():
    path = ROOT / "tools" / "torch_oracle_repeatability.py"
    spec = importlib.util.spec_from_file_location(
        "torch_oracle_repeatability", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_repeatability_tool_writes_its_json(tmp_path):
    cv2 = pytest.importorskip("cv2")
    data = tmp_path / "corpus"
    data.mkdir()
    # two of the four names, a .jpg and a .png (the others are skipped,
    # as absent corpus images are)
    names = WARP_IMAGES[:2]
    for i, name in enumerate(names):
        img = chip_smoke.to_gray(chip_smoke.texture(
            80, 96, seed=20 + i, n_blobs=40)).astype(np.uint8)
        ok, png = cv2.imencode(".png", img)
        assert ok
        (data / name).write_bytes(png.tobytes())
    out = tmp_path / "ORACLE_REPEAT_TORCH.json"
    rc = _tool().main(["--data", str(data), "--device", "cpu",
                       "--max-side", "64", "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "ORACLE_REPEAT.json").read_text())
    assert got["pipeline"] == "sift_tpu_torch" and got["max_side"] == 64
    assert set(want) <= set(got) and set(got["summary"]) == set(
        want["summary"])
    assert [r["image"] for r in got["rows"]] == [n for n in names
                                                  for _ in range(4)]
    assert all(set(r) == set(want["rows"][0]) for r in got["rows"])
    assert all(0.0 <= r["oracle_repeatability"] <= 1.0 for r in got["rows"])
    # the eval report attaches it as the port's own column
    report = {"repeatability": [{k: r[k] for k in ("image", "angle",
                                                   "scale")}
                                for r in got["rows"]]}
    attach_oracle(report, str(out))
    assert report["oracle_repeatability_comparison"]["pipeline"] == \
        "sift_tpu_torch"
    for row, r in zip(report["repeatability"], got["rows"]):
        assert row["pipeline_repeatability_reduced_res"] == \
            r["pipeline_repeatability"]


def test_repeatability_tool_refuses_an_empty_corpus(tmp_path, capsys):
    out = tmp_path / "out.json"
    rc = _tool().main(["--data", str(tmp_path), "--device", "cpu",
                       "--out", str(out)])
    assert rc != 0 and not out.exists()
    assert "none of" in capsys.readouterr().err
