"""The geometry layer's CUDA-graph cache (sift_tpu_torch/geometry/
graphs.py) and the stretches it replays, on the CPU: the 5-point solver
split at its SVD, and the essential and PnP RANSACs built around their
stretches, give the bits of the frozen eager copies the mapping cell is
held to (benchmark/reference/geometry_plain.py, copied before the
split); the cache's keys and counts through a fake capture, a refused
capture and a replay that differs; and CPU tensors never reach the
cache. The card's side (real captures, bit for bit against eager) is
chip_smoke.py's phase 6d."""

import numpy as np
import pytest
import torch

from benchmark.reference import geometry_plain as frozen
from sift_tpu_torch.geometry import epipolar, fivepoint, graphs, pnp
from sift_tpu_torch.utils import profiling

from _torch_threads import one_thread  # noqa: F401


def two_view(n_pad: int, n: int, seed: int):
    """Normalized correspondences of n points seen from two poses (a
    fifth of them outliers), zero-padded to n_pad, with the points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform([-1, -1, 4], [1, 1, 8], (n, 3))
    c, s = np.cos(0.1), np.sin(0.1)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    x1 = x @ r.T + np.array([0.5, 0.05, 0.1])
    p0, p1 = x[:, :2] / x[:, 2:], x1[:, :2] / x1[:, 2:]
    p1 = p1 + rng.normal(0, 1e-3, p1.shape)
    out = rng.random(n) < 0.2
    p1[out] = rng.uniform(-0.3, 0.3, (int(out.sum()), 2))

    def pad(a):
        return torch.tensor(np.pad(a, ((0, n_pad - n), (0, 0))),
                            dtype=torch.float32)
    valid = torch.zeros(n_pad, dtype=torch.bool)
    valid[:n] = True
    return pad(p0), pad(p1), valid, pad(x)


@pytest.fixture(scope="module")
def problem():
    return two_view(64, 50, seed=3)


def test_split_5pt_solver_gives_the_frozen_candidates(problem):
    p0, p1, _, _ = problem
    idx = torch.randint(0, 50, (128, 5),
                        generator=torch.Generator().manual_seed(1))
    want = frozen.essential_candidates_5pt(p0[idx], p1[idx])
    basis = fivepoint.nullspace_basis(p0[idx], p1[idx])
    assert basis.shape == (128, 4, 9)
    assert graphs.same_bits(fivepoint.candidates_from_basis(basis), want)
    assert graphs.same_bits(
        fivepoint.essential_candidates_5pt(p0[idx], p1[idx]), want)
    assert int(want[1].sum()) > 128


def test_cpu_ransacs_are_the_frozen_eager_copies_and_skip_the_cache(
        problem):
    """Both RANSACs on CPU tensors: the frozen copies' bits, the cache
    untouched, and spans that carry the padded N and no graph hit."""
    p0, p1, valid, x = problem
    graphs.CACHE.clear()
    profiling.clear()
    with profiling.tracing():
        ess = epipolar.find_essential_ransac(p0, p1, valid=valid,
                                             threshold=2e-3)
        pose = pnp.pnp_ransac(x, p0, valid=valid)
    recs = {s.name: s.attrs for s in profiling.spans()}
    profiling.clear()
    assert graphs.same_bits(tuple(ess), tuple(frozen.find_essential_ransac(
        p0, p1, valid=valid, threshold=2e-3)))
    assert graphs.same_bits(tuple(pose),
                            tuple(frozen.pnp_ransac(x, p0, valid=valid)))
    assert int(ess.n_inliers) >= 35 and int(pose.n_inliers) == 50
    c = graphs.CACHE
    assert (c.hits, c.misses, c.replays, c.refused, c.keys()) == \
        (0, 0, 0, 0, [])
    for name in ("geometry.essential", "geometry.pnp"):
        assert recs[name] == {"n": 64, "graph_hit": False}


def fake_capture(fn, args, pools):
    """A capture that records nothing: each replay runs fn on the static
    inputs again and writes the static outputs in place. It takes the
    cache's one pool, as the CUDA capture takes a device's."""
    pools.setdefault("pool", object())
    outs = fn(*args)

    def replay():
        new = fn(*args)
        for o, n in (((outs, new),) if torch.is_tensor(outs)
                     else zip(outs, new)):
            o.copy_(n)
    return replay, outs


def scaled_sum(a, b, k):
    return (a * k + b).sum(0), a.max()


def test_cache_keys_and_counts_through_a_fake_capture():
    cache = graphs.GraphCache(capture=fake_capture, on_card=lambda ts: True)
    a, b = torch.rand(8, 3), torch.rand(8, 3)
    calls = [(a, b, 2.0), (a + 1, b, 2.0), (a, b - 1, 2.0)]
    for x, y, k in calls:
        got = cache.run("s", scaled_sum, (x, y), (k,))
        assert graphs.same_bits(got, scaled_sum(x, y, k))
    # one key: a miss (eager, then a capture checked by one replay), two
    # hits that replay it
    assert (cache.hits, cache.misses, cache.replays, cache.refused) == \
        (2, 1, 3, 0)
    # the clones a hit hands back outlive the next replay
    first = cache.run("s", scaled_sum, (a, b), (2.0,))
    cache.run("s", scaled_sum, (a * 5, b), (2.0,))
    assert graphs.same_bits(first, scaled_sum(a, b, 2.0))
    # another N, another baked scalar, another name, another storage
    # offset of the same shape: four keys more
    big = torch.rand(9, 3)
    for name, x, k in (("s", torch.rand(16, 3), 2.0), ("s", a, 3.0),
                       ("t", a, 2.0), ("s", big[1:], 2.0)):
        cache.run(name, scaled_sum, (x, b if x.shape[0] == 8
                                     else torch.rand(x.shape)), (k,))
    assert cache.misses == 5 and len(cache.keys()) == 5
    assert cache.keys()[0] == ("s", (((8, 3), (3, 1), 0, torch.float32,
                                      torch.device("cpu")),) * 2, (2.0,))
    assert cache.keys()[4][1][0][2] == 3       # the view's storage offset
    # every capture shared one pool; clear() drops it with the graphs, so
    # the next capture starts another (a pool without graphs takes none)
    pool = cache._pools["pool"]
    cache.clear()
    assert (cache.hits, cache.misses, cache.replays, cache.keys(),
            cache._pools) == (0, 0, 0, [], {})
    cache.run("s", scaled_sum, (a, b), (2.0,))
    assert cache._pools["pool"] is not pool


def test_a_real_stretch_through_a_fake_capture(problem):
    """PnP's polish, captured and replayed on static buffers: the eager
    bits on a miss and on a hit with other inputs."""
    _, p0, _, x = problem
    cache = graphs.GraphCache(capture=fake_capture, on_card=lambda ts: True)
    w = torch.ones(64)
    for shift in (0.0, 0.01):
        params = torch.tensor([0.01, 0.0, 0.0, shift, 0.0, 0.0])
        got = cache.run("pnp.polish", pnp._polish, (params, x, p0, w))
        assert graphs.same_bits(got, pnp._polish(params, x, p0, w))
    assert (cache.hits, cache.misses) == (1, 1)


def test_a_capture_that_fails_or_differs_leaves_the_key_eager():
    def raising(fn, args, pools):
        raise RuntimeError("operation not permitted when stream is capturing")

    def off_by_one(fn, args, pools):
        replay, outs = fake_capture(fn, args, pools)

        def bad():
            replay()
            outs[0].add_(1.0)
        return bad, outs

    a, b = torch.rand(8, 3), torch.rand(8, 3)
    for capture in (raising, off_by_one):
        cache = graphs.GraphCache(capture=capture, on_card=lambda ts: True)
        for _ in range(3):
            got = cache.run("s", scaled_sum, (a, b), (2.0,))
            assert graphs.same_bits(got, scaled_sum(a, b, 2.0))
        assert (cache.hits, cache.misses, cache.refused) == (0, 1, 1)
        assert cache.replays == (0 if capture is raising else 1)
        assert cache._pools == {}      # the pool of the refused graph went


def test_same_bits():
    nan = torch.tensor([float("nan"), 1.0])
    assert graphs.same_bits(nan, nan.clone())
    assert not graphs.same_bits(torch.tensor([0.0]), torch.tensor([-0.0]))
    assert not graphs.same_bits(torch.ones(2), torch.ones(2, 1))
    assert not graphs.same_bits(torch.ones(2),
                                torch.ones(2, dtype=torch.int32))
    assert graphs.same_bits((torch.tensor(True), torch.tensor(3)),
                            (torch.tensor(True), torch.tensor(3)))
