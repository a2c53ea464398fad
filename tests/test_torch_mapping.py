"""The whole mapping slice of the port against sift_tpu's on the CPU: the
cv2-free renderer and run_mapping end to end (the eval harness is in
tests/test_torch_eval.py).

Both packages render from the same texture files, written into a
temporary directory under the renderer's names, and run_mapping gets the
same frames. sift_tpu runs with exact float32 descriptors
(descr_rc_bf16=False; the port has no bf16 arm); the port takes
sift_tpu's RANSAC draws (`sampler=`) and retrieval projection (`proj=`).
The sequence is tests/test_mapping.py's 10 frames of 200x268 with a
pair window of 2; the closure stage is cut to min_gap 7 and one
candidate per frame (at most 6 pairs), since each sift_tpu essential
RANSAC costs seconds here.
"""

import dataclasses
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

from sift_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from sift_tpu.ops.match_cascade import _projection as jax_projection
from sift_tpu.sfm import mapping as jmap

from sift_tpu_torch.config import from_jax_config
from sift_tpu_torch.sfm import mapping as tmap

from _torch_threads import one_thread  # noqa: F401


def jax_sampler(kind, valid, n_samples, k, seed):
    """sift_tpu's RANSAC draw for a call with this validity mask."""
    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (n_samples, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid.cpu().numpy())[None, :], g, -jnp.inf)
    return np.array(jax.lax.top_k(g, k)[1])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A directory with the renderer's four textures, as gray image
    files: chip_smoke.py's phase-6 textures."""
    d = tmp_path_factory.mktemp("corpus")
    for name, tex in zip(tmap._TEXTURES, chip_smoke.mapping_textures()):
        cv2.imwrite(str(d / name), tex.astype(np.uint8))
    return str(d)


# ---------------------------------------------------------------- renderer

def test_renderer_frames_match_jax(corpus):
    # mean |frame difference| <= 2 gray levels (cv2 weights bilinear
    # samples in 1/32-pixel steps, with its own rounding), ground-truth
    # poses within 1e-6, the same intrinsics
    want = jmap.render_corner_sequence(data_dir=corpus, n_frames=4,
                                       size=(200, 268), seed=3)
    got = tmap.render_corner_sequence(data_dir=corpus, n_frames=4,
                                      size=(200, 268), seed=3)
    assert got[0].shape == want[0].shape == (4, 200, 268)
    assert np.abs(got[0] - want[0]).mean() <= 2.0
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    # the textures= form renders the same frames as the data_dir form
    again = tmap.render_corner_sequence(
        n_frames=4, size=(200, 268), seed=3,
        textures=tmap.load_textures(corpus))
    np.testing.assert_array_equal(again[0], got[0])


def test_renderer_coverage_masks_match_cv2(corpus):
    # each plane's nearest-neighbour coverage mask against
    # cv2.warpPerspective's on the renderer's own homographies: <= 1 %
    # of pixels differ, and only on the mask's edges
    texs = tmap.load_textures(corpus)
    h, w = 200, 268
    k = np.array([[0.9 * w, 0, w / 2.0], [0, 0.9 * w, h / 2.0], [0, 0, 1]])
    for i in range(0, 24, 5):
        th = 2.0 * np.pi * i / 24
        center = np.array([0.9 * np.sin(th), 0.25 * np.sin(2 * th),
                           0.35 * 0.9 * (1.0 - np.cos(th))])
        r = tmap._look_at(center, np.array([0.6 * np.sin(th), 0.0, 6.0]))
        t = -r @ center
        for (o, u, v), tex in zip(tmap._PLANES, texs):
            th_, tw_ = tex.shape
            m = np.stack([r @ np.asarray(u), r @ np.asarray(v),
                          r @ np.asarray(o) + t], axis=1)
            hom = k @ m @ np.diag([1.0 / (tw_ - 1), 1.0 / (th_ - 1), 1.0])
            want = cv2.warpPerspective(np.ones_like(tex), hom, (w, h),
                                       flags=cv2.INTER_NEAREST).astype(bool)
            _, got = tmap._warp_plane(tex, hom, h, w)
            diff = got != want
            assert diff.mean() <= 0.01
            # an edge pixel: one of its 8 neighbours has the other value
            pad = np.pad(want, 1, mode="edge")
            edge = np.zeros_like(want)
            for dy in range(3):
                for dx in range(3):
                    edge |= pad[dy:dy + h, dx:dx + w] != want
            assert not (diff & ~edge).any()


# ------------------------------------------------------------ whole slice

@pytest.fixture(scope="module")
def mapped(corpus):
    """sift_tpu's run_mapping and the port's on the same frames."""
    frames, k, gt = jmap.render_corner_sequence(
        data_dir=corpus, n_frames=10, size=(200, 268), seed=3)
    jcfg = dataclasses.replace(JAX_CONFIG, descr_rc_bf16=False)
    kw = dict(pair_window=2, min_gap=7, closure_candidates=1)
    want = jmap.run_mapping(frames, k, cfg=jcfg, **kw)
    export = os.path.join(os.path.dirname(corpus), "port_map")
    got = tmap.run_mapping(
        frames, k, cfg=from_jax_config(dataclasses.asdict(jcfg)),
        sampler=jax_sampler, proj=np.asarray(jax_projection(128, 16, 7)),
        device="cpu", export_prefix=export, **kw)
    return want, got, gt


def test_mapping_registers_the_same_frames(mapped):
    want, got, _ = mapped
    np.testing.assert_array_equal(got.registered, want.registered)
    assert got.stats["n_registered"] >= 9
    assert got.stats["n_seq_pairs"] == want.stats["n_seq_pairs"]


def test_mapping_finds_the_same_closures(mapped):
    want, got, _ = mapped
    assert want.closures, "no closure in the reference run"
    assert [(c.i, c.j) for c in got.closures] == \
        [(c.i, c.j) for c in want.closures]
    assert got.stats["n_closure_edges"] == want.stats["n_closure_edges"]


def test_mapping_points_within_two_percent(mapped):
    want, got, _ = mapped
    n_w, n_g = want.stats["n_points"], got.stats["n_points"]
    assert n_g >= 50 and abs(n_g - n_w) <= 0.02 * n_w


def test_mapping_ate_matches_jax(mapped):
    # ATE of each stage within 5 % relative of sift_tpu's
    # (tools/torch_mapping_parity.py reads 1.7 % at most); the final map
    # inside the 0.07 gate
    want, got, gt = mapped
    a_w = jmap.mapping_ate(want, gt)
    a_g = tmap.mapping_ate(got, gt)
    for key in ("ate_odometry", "ate_posegraph", "ate_final"):
        assert abs(a_g[key] - a_w[key]) <= 0.05 * a_w[key], (a_g, a_w)
    assert a_g["ate_final"] <= 0.07


def test_mapping_reproj_rmse_matches_jax(mapped):
    # within 1 % relative (the parity tool reads 5e-7); inside the 4e-3
    # gate
    want, got, _ = mapped
    assert abs(got.reproj_rmse - want.reproj_rmse) <= 0.01 * want.reproj_rmse
    assert got.reproj_rmse <= 4e-3


def test_mapping_exports_the_final_map(mapped):
    _, got, _ = mapped
    exp = got.stats["export"]
    with open(exp["ply"]) as f:
        head = f.read(200)
    assert f"element vertex {got.stats['n_points']}" in head
    with open(exp["json"]) as f:
        cams = json.load(f)["cameras"]
    assert len(cams) == got.stats["n_registered"]
