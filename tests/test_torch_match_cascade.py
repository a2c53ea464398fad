"""The port's cascade matcher against sift_tpu.ops.match_cascade, both
given the same projection: the JAX package's own seeded draw, passed to
the port as `proj` (the port cannot reproduce a jax.random draw)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops import match_cascade as jcas

from sift_tpu_torch.ops import match_cascade as tcas

from _torch_threads import one_thread  # noqa: F401

SEED, D_PROJ = 7, 16


def _descriptors(n=300, m=1500, seed=21):
    """Random descriptors with planted near-duplicates: the first 40 %
    of the queries have a jittered twin among the train rows, the rest
    have none; the first 10 twins appear twice (a tie on d1, which the
    lower train index wins and the ratio test rejects)."""
    rng = np.random.default_rng(seed)
    q = (rng.random((n, 128)) * 0.3).astype(np.float32)
    t = (rng.random((m, 128)) * 0.3).astype(np.float32)
    k = 2 * n // 5
    rows = rng.permutation(m)
    twins, dups = rows[:k], rows[k:k + 10]
    t[twins] = q[:k] + rng.normal(0, 0.01, (k, 128)).astype(np.float32)
    t[dups] = t[twins[:10]]
    qv = rng.random(n) > 0.05
    tv = rng.random(m) > 0.05
    return q, t, qv, tv


def _exact_top2(q, t, tv):
    """Exact top-2 L1 distances over the valid train rows (float64)."""
    tm = np.where(tv[:, None], t, 1e6).astype(np.float64)
    d = np.abs(q.astype(np.float64)[:, None, :] - tm[None]).sum(-1)
    d.sort(axis=1)
    return d[:, 0], d[:, 1]


@pytest.mark.parametrize("n_candidates,tile,verified",
                         [(64, 512, True), (32, 128, True), (32, 128, False)])
def test_cascade_matches_jax(n_candidates, tile, verified):
    # train_idx and good equal on rows that are not ratio-borderline
    # (|d1 - 0.86 d2| >= 1e-4); d1 within rtol 1e-6 (float32 rounding of
    # 128-term sums in another order)
    q, t, qv, tv = _descriptors()
    want = jcas.match_ratio_cascade(
        jnp.asarray(q), jnp.asarray(t), q_valid=jnp.asarray(qv),
        t_valid=jnp.asarray(tv), n_candidates=n_candidates, d_proj=D_PROJ,
        seed=SEED, tile=tile, downstream_verified=verified)
    proj = torch.from_numpy(np.array(jcas._projection(128, D_PROJ, SEED)))
    got = tcas.match_ratio_cascade(
        torch.from_numpy(q), torch.from_numpy(t), q_valid=torch.from_numpy(qv),
        t_valid=torch.from_numpy(tv), n_candidates=n_candidates,
        d_proj=D_PROJ, proj=proj, tile=tile, downstream_verified=verified)
    d1, d2 = _exact_top2(q, t, tv)
    clear = np.abs(d1 - 0.86 * d2) >= 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got.train_idx.numpy()[clear],
                                  np.asarray(want.train_idx)[clear])
    np.testing.assert_array_equal(got.good.numpy()[clear],
                                  np.asarray(want.good)[clear])
    np.testing.assert_allclose(got.distance.numpy(),
                               np.asarray(want.distance), rtol=1e-6)
    np.testing.assert_array_equal(got.query_idx.numpy(), np.arange(len(q)))
    good = got.good.numpy()
    assert 80 < good.sum() <= 110 and not good[:10].any()
    assert not good[120:].any()


def test_cascade_empty_query():
    q = torch.zeros((0, 128))
    t = torch.rand((5, 128))
    got = tcas.match_ratio_cascade(q, t)
    want = jcas.match_ratio_cascade(jnp.zeros((0, 128)), jnp.asarray(t.numpy()))
    for a, b in zip(got, want):
        assert a.shape == b.shape == (0,)
        assert a.numpy().dtype == np.asarray(b).dtype


def test_cascade_single_train_row():
    rng = np.random.default_rng(3)
    q = rng.random((4, 128)).astype(np.float32)
    t = rng.random((1, 128)).astype(np.float32)
    got = tcas.match_ratio_cascade(torch.from_numpy(q), torch.from_numpy(t))
    want = jcas.match_ratio_cascade(jnp.asarray(q), jnp.asarray(t))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got.good.any()


def test_default_projection_is_seeded():
    # no proj: a torch.Generator draw from `seed`, scale 1/sqrt(D); the
    # same seed gives the same matrix, and the same matches
    a, b = tcas.projection(128, 16, 7), tcas.projection(128, 16, 7)
    assert torch.equal(a, b) and a.shape == (128, 16)
    assert not torch.equal(a, tcas.projection(128, 16, 8))
    assert abs(float(a.std()) * 128 ** 0.5 - 1.0) < 0.1
    q, t, qv, tv = (torch.from_numpy(v) for v in _descriptors(60, 300))
    r1 = tcas.match_ratio_cascade(q, t, qv, tv)
    r2 = tcas.match_ratio_cascade(q, t, qv, tv, proj=a)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
