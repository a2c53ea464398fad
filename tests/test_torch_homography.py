"""The port's RANSAC homography against sift_tpu's.

jax.random and torch.Generator draw different numbers, so the parity
tests recompute JAX's 4-point samples exactly as
sift_tpu/geometry/homography.py:168-172 draws them and inject them into
the port through `samples=`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.geometry import (find_homography_ransac as jax_ransac,
                               perspective_transform as jax_pt)

from sift_tpu_torch.geometry import (find_homography_ransac,
                                     perspective_transform)


def _make_case(seed, n=200, outlier_frac=0.4, noise=0.5):
    rng = np.random.default_rng(seed)
    h_true = np.array([[0.9, 0.12, 40.0],
                       [-0.1, 1.05, -22.0],
                       [1e-4, -2e-4, 1.0]], np.float32)
    src = rng.uniform(0, 800, (n, 2)).astype(np.float32)
    p = np.concatenate([src, np.ones((n, 1), np.float32)], 1) @ h_true.T
    dst = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    dst += rng.normal(0, noise, dst.shape).astype(np.float32)
    out = rng.choice(n, int(n * outlier_frac), replace=False)
    dst[out] = rng.uniform(0, 800, (out.size, 2)).astype(np.float32)
    is_in = np.ones(n, bool)
    is_in[out] = False
    return h_true, src, dst, is_in


def _jax_samples(valid, seed=0, n_hypotheses=1024):
    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (n_hypotheses, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.array(jax.lax.top_k(g, 4)[1])


@pytest.mark.parametrize("seed,masked", [(0, False), (4, True)])
def test_ransac_matches_jax_with_injected_samples(seed, masked):
    # H to relative 1e-3 (Frobenius): the same inlier set goes through
    # the same normalised DLT and Gauss-Newton, with eigh/solve from
    # different libraries; inlier masks and ok exact
    _, src, dst, _ = _make_case(seed)
    valid = np.ones(len(src), bool)
    if masked:
        valid[150:] = False
        dst[150:] = 1e6
    want = jax_ransac(jnp.asarray(src), jnp.asarray(dst),
                      valid=jnp.asarray(valid), seed=seed)
    got = find_homography_ransac(torch.from_numpy(src), torch.from_numpy(dst),
                                 valid=torch.from_numpy(valid),
                                 samples=torch.from_numpy(_jax_samples(valid,
                                                                       seed)))
    hj = np.asarray(want.H)
    assert np.linalg.norm(got.H.numpy() - hj) / np.linalg.norm(hj) < 1e-3
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert bool(got.ok) == bool(want.ok) is True
    assert int(got.n_inliers) == int(want.n_inliers)


def test_ransac_recovers_homography_with_own_draws():
    h_true, src, dst, is_in = _make_case(1)
    res = find_homography_ransac(torch.from_numpy(src), torch.from_numpy(dst),
                                 seed=3)
    assert bool(res.ok)
    inl = res.inliers.numpy()
    assert inl[is_in].mean() > 0.97
    assert inl[~is_in].mean() < 0.05
    proj = perspective_transform(torch.from_numpy(src[is_in]), res.H).numpy()
    assert np.median(np.linalg.norm(proj - dst[is_in], axis=1)) < 1.0
    again = find_homography_ransac(torch.from_numpy(src),
                                   torch.from_numpy(dst), seed=3)
    assert torch.equal(res.H, again.H)


def test_degenerate_input_flags_not_ok():
    src = np.ones((64, 2), np.float32) * 10
    dst = np.ones((64, 2), np.float32) * 20
    want = jax_ransac(jnp.asarray(src), jnp.asarray(dst))
    got = find_homography_ransac(torch.from_numpy(src), torch.from_numpy(dst))
    assert bool(want.ok) is False and bool(got.ok) is False
    assert int(got.n_inliers) == 0
    assert torch.equal(got.H, torch.eye(3))


def test_perspective_transform_matches_jax():
    # rtol 1e-6: the same float32 expression
    rng = np.random.default_rng(8)
    pts = rng.uniform(-50, 900, (40, 2)).astype(np.float32)
    h = np.array([[1.1, 0.05, 3.0], [-0.02, 0.95, 7.5], [2e-4, -1e-4, 1.0]],
                 np.float32)
    want = np.asarray(jax_pt(jnp.asarray(pts), jnp.asarray(h)))
    got = perspective_transform(torch.from_numpy(pts), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
