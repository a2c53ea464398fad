"""K4 over G pairs in one launch: the port's match_ratio with a leading
pair axis against jax.vmap of sift_tpu's match_ratio (XLA, and the
Pallas kernel in interpret mode at a tiny size), against the port's own
per-pair calls bit for bit, the kernel's (P, G, N) scratch layout in a
NumPy model, and the split plan with a pair count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops import match as jmatch

from sift_tpu_torch.ops import match as tmatch
from sift_tpu_torch.ops.match_cuda import (knn2_l1_cuda, knn2_l1_plain,
                                           split_plan, split_span)
from test_torch_kernel_designs import _knn2_split_model, _merge

from _torch_threads import one_thread  # noqa: F401

RATIO = 0.86


def _pairs(g=3, n=200, m=190, seed=21):
    """G pairs of (query, train, q_valid, t_valid): in every pair the
    first k = min(80, N/2, M/2) queries are train rows 0..k-1 plus noise
    (clear matches) and the rest are random rows (ratio near 1); pair 0
    has ragged validity, pair 1 duplicate train rows (rows M-20..M-11
    copy rows 10..19, and the last 10 queries equal rows 10..19
    exactly), pair 2 a single valid train row."""
    rng = np.random.default_rng(seed)
    q = (rng.random((g, n, 128)) * 0.3).astype(np.float32)
    t = (rng.random((g, m, 128)) * 0.3).astype(np.float32)
    k = min(80, n // 2, m // 2)
    q[:, :k] = t[:, :k] + rng.normal(0, 0.01, (g, k, 128)).astype(
        np.float32)
    qv = np.ones((g, n), bool)
    tv = np.ones((g, m), bool)
    qv[0] = rng.random(n) > 0.2
    tv[0] = rng.random(m) > 0.2
    if g > 1:
        t[1, m - 20:m - 10] = t[1, 10:20]
        q[1, n - 10:] = t[1, 10:20]
    if g > 2:
        tv[2] = False
        tv[2, 5] = True
    return q, t, qv, tv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_vmapped(q, t, qv, tv, impl):
    fn = jax.vmap(lambda a, b, c, d: jmatch.match_ratio(
        a, b, q_valid=c, t_valid=d, ratio=RATIO, impl=impl))
    return [np.asarray(f) for f in fn(*map(jnp.asarray, (q, t, qv, tv)))]


def _assert_no_borderline(q, t, tv):
    # the data leaves every ratio decision at least 1e-3 relative from
    # 0.86, so float32 summation order cannot flip one; a query equal to
    # two duplicate train rows has d1 = d2 = 0 exactly in any order
    r = tmatch.knn2_l1(_t(q), _t(t), _t(tv))
    d1, d2 = r.d1.numpy().astype(np.float64), r.d2.numpy().astype(np.float64)
    assert ((np.abs(d1 - RATIO * d2) > 1e-3 * d2) | (d2 == 0)).all()


def test_batched_match_ratio_matches_jax_vmap():
    # train_idx and good exact, distance within rtol 1e-6 (float32
    # rounding of the 128-term sums), query_idx arange on every row
    q, t, qv, tv = _pairs()
    _assert_no_borderline(q, t, tv)
    want = _jax_vmapped(q, t, qv, tv, "xla")
    got = tmatch.match_ratio(_t(q), _t(t), q_valid=_t(qv), t_valid=_t(tv),
                             ratio=RATIO)
    assert all(tuple(f.shape) == (3, 200) for f in got)
    np.testing.assert_array_equal(got.query_idx.numpy(), want[0])
    np.testing.assert_array_equal(got.query_idx.numpy(),
                                  np.broadcast_to(np.arange(200), (3, 200)))
    np.testing.assert_array_equal(got.train_idx.numpy(), want[1])
    np.testing.assert_allclose(got.distance.numpy(), want[2], rtol=1e-6)
    np.testing.assert_array_equal(got.good.numpy(), want[3])
    good = got.good.numpy()
    assert good[0].sum() > 40 and good[1].sum() > 40
    assert not good[0][~qv[0]].any()
    # ties: the lowest of two equal train rows wins
    np.testing.assert_array_equal(got.train_idx.numpy()[1, 190:],
                                  np.arange(10, 20))
    assert (got.distance.numpy()[1, 190:] == 0).all()
    # fewer than 2 valid train rows: no good match
    assert not good[2].any()


def test_batched_match_ratio_matches_pallas_vmap_interpret():
    # jax.vmap over the Pallas kernel (a pair axis on its grid), in
    # interpret mode on the CPU, at a tiny size
    q, t, qv, tv = _pairs(g=2, n=24, m=40, seed=5)
    want = _jax_vmapped(q, t, qv, tv, "pallas")
    got = tmatch.match_ratio(_t(q), _t(t), q_valid=_t(qv), t_valid=_t(tv),
                             ratio=RATIO)
    np.testing.assert_array_equal(got.train_idx.numpy(), want[1])
    np.testing.assert_allclose(got.distance.numpy(), want[2], rtol=1e-6)
    _assert_no_borderline(q, t, tv)
    np.testing.assert_array_equal(got.good.numpy(), want[3])


def test_batched_match_ratio_equals_per_pair_calls():
    # bit for bit: the batched plain K4 runs the single plain K4 on each
    # pair, and the ratio test is elementwise
    q, t, qv, tv = _pairs()
    got = tmatch.match_ratio(_t(q), _t(t), q_valid=_t(qv), t_valid=_t(tv),
                             ratio=RATIO)
    knn = tmatch.knn2_l1(_t(q), _t(t), _t(tv))
    for g in range(q.shape[0]):
        one = tmatch.match_ratio(_t(q[g]), _t(t[g]), q_valid=_t(qv[g]),
                                 t_valid=_t(tv[g]), ratio=RATIO)
        for a, b in zip(got, one):
            assert torch.equal(a[g], b)
        for a, b in zip(knn, tmatch.knn2_l1(_t(q[g]), _t(t[g]), _t(tv[g]))):
            assert torch.equal(a[g], b)
        assert torch.equal(tmatch.mask_train(_t(t), _t(tv))[g],
                           tmatch.mask_train(_t(t[g]), _t(tv[g])))


def test_batched_wrapper_takes_plain_version_on_cpu():
    q, t, _, tv = _pairs(g=2, n=40, m=70)
    tm = tmatch.mask_train(_t(t), _t(tv))
    before = knn2_l1_cuda.launches
    got = knn2_l1_cuda(_t(q), tm)
    want = knn2_l1_plain(_t(q), tm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [tuple(a.shape) for a in got] == [(2, 40)] * 3
    assert got[0].dtype == torch.int32
    assert knn2_l1_cuda.launches == before
    # no pairs: empty results
    empty = knn2_l1_cuda(_t(q[:0]), tm[:0])
    assert [tuple(a.shape) for a in empty] == [(0, 40)] * 3


@pytest.mark.parametrize("qs,ts", [((2, 8, 128), (3, 9, 128)),
                                   ((2, 8, 128), (9, 128)),
                                   ((2, 8, 128), (2, 9, 64)),
                                   ((1, 2, 8, 128), (1, 2, 9, 128))])
def test_batched_wrapper_refuses_mismatched_pairs(qs, ts):
    with pytest.raises(ValueError, match="knn2 takes"):
        knn2_l1_cuda(torch.zeros(qs), torch.zeros(ts))


def test_batched_wrapper_raises_on_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        knn2_l1_cuda(torch.empty((2, 8, 128), device="meta"),
                     torch.empty((2, 9, 128), device="meta"))


@pytest.mark.parametrize("g,p,m", [(3, 1, 190), (3, 2, 190), (2, 3, 70)])
def test_pair_scratch_layout_model_is_the_per_pair_plain_version(g, p, m):
    # csrc/knn2.cu with G pairs: block (x, s, pair) writes its split's
    # partial at ((s * G) + pair) * N + query of the (P, G, N) scratch,
    # and the merge kernel folds, for each of the G N queries, the P
    # partials at stride G N in split order. The model lays out and
    # reads the scratch by those expressions.
    q, t, _, tv = _pairs(g=g, n=50, m=m)
    tm = tmatch.mask_train(_t(t), _t(tv)).numpy()
    n = q.shape[1]
    span = split_span(m, p)
    scratch = [np.empty(p * g * n, dt) for dt in (np.float32, np.float32,
                                                  np.int64)]
    for pair in range(g):
        for s in range(p):
            # split s alone: rows outside it masked by an empty model
            lo, hi = min(m, s * span), min(m, (s + 1) * span)
            part = _split_partial(q[pair], tm[pair], lo, hi)
            o = (s * g + pair) * n + np.arange(n)
            for buf, v in zip(scratch, part):
                buf[o] = v
    ng = g * n
    idx = np.empty(ng, np.int64)
    d1 = np.empty(ng, np.float32)
    d2 = np.empty(ng, np.float32)
    for qq in range(ng):
        acc = tuple(buf[qq:qq + 1] for buf in scratch)
        for s in range(1, p):
            acc = _merge(acc, tuple(buf[s * ng + qq:s * ng + qq + 1]
                                    for buf in scratch))
        d1[qq], d2[qq], idx[qq] = acc[0][0], acc[1][0], acc[2][0]
    idx = np.where(idx == np.iinfo(np.int32).max, 0, idx)
    want = knn2_l1_plain(_t(q), _t(tm))
    np.testing.assert_array_equal(idx.reshape(g, n), want[0].numpy())
    np.testing.assert_array_equal(d1.reshape(g, n), want[1].numpy())
    np.testing.assert_array_equal(d2.reshape(g, n), want[2].numpy())


def _split_partial(q, t, lo, hi):
    """(d1, d2, idx) of train rows [lo, hi) for every query: the single
    pair's split model (tests/test_torch_kernel_designs.py) on one split
    whose rows start at lo."""
    idx, d1, d2 = _knn2_split_model(q, t[lo:hi], 1, max(64, hi - lo))
    reached = hi > lo
    idx = np.where(reached, idx + lo, np.iinfo(np.int32).max)
    return d1, d2, idx


@pytest.mark.parametrize("n,m", [(1536, 1536), (64, 1536), (1536, 64),
                                 (300, 5000), (0, 0), (1536, 1), (200, 190)])
@pytest.mark.parametrize("g", [1, 2, 7, 100])
def test_split_plan_with_pairs(n, m, g):
    n_sm = 132
    p, span = split_plan(n, m, n_sm, g)
    if g == 1:                       # one pair: the single-pair plan
        assert (p, span) == split_plan(n, m, n_sm)
    assert p >= 1 and span % 64 == 0 and p * span >= m
    assert span == split_span(m, p)
    m_tiles = -(-m // 64)
    q_tiles = max(1, -(-n // 64))
    # never an empty grid, and two blocks per SM over all G pairs unless
    # the train set has too few tiles for it
    assert q_tiles * p * g >= 1
    assert g * q_tiles * p >= 2 * n_sm or p == max(1, m_tiles)
    if (n, m, g) == (1536, 1536, 7):   # the batch step's 7 pairs
        assert (p, span) == (2, 768)
