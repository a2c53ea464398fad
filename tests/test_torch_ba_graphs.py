"""The bundle adjustment's LM iteration as a CUDA-graph stretch
(sift_tpu_torch/sfm/ba.py `_lm_iter`, through geometry/graphs.py), on
the CPU: run through a cache with a fake capture, bundle_adjust gives
the bits of the frozen eager copy the mapping cell is held to
(benchmark/reference/sfm_plain.py) under the Cauchy and the Huber loss,
with masked rows and a fixed camera; the cache's counts and keys over
calls of 3 and 5 iterations; the span's `graph_hit`; CPU tensors and
the sharded loop (`bundle_adjust_loop` with a `psum`) never reach the
cache. The card's side (real captures, bit for bit against eager) is
chip_smoke.py's phase 6d."""

import numpy as np
import pytest
import torch

from benchmark.reference import sfm_plain as frozen
from sift_tpu_torch.geometry import graphs
from sift_tpu_torch.geometry.lie import so3_exp
from sift_tpu_torch.ops import segsum
from sift_tpu_torch.sfm import ba
from sift_tpu_torch.utils import profiling

from _torch_threads import one_thread  # noqa: F401
from test_torch_graphs import fake_capture

ITERS, CG_ITERS = 3, 5


def rig(seed: int, n_cams: int = 5, n_pts: int = 48) -> dict:
    """Cameras on an arc seeing points 6-12 ahead, a fifth of the
    observations dropped, a tenth of them outliers, padded to a power of
    two with masked rows at index 0; a perturbed start, camera 0 fixed."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 12, n_pts)], axis=1)
    w = np.zeros((n_cams, 3))
    w[:, 1] = (np.arange(n_cams) - n_cams / 2) * 0.12
    rot = so3_exp(torch.tensor(w)).numpy()
    centers = np.stack([2.0 * np.arange(n_cams) / n_cams - 1.0,
                        0.1 * np.arange(n_cams), np.zeros(n_cams)], axis=1)
    cams = np.concatenate([w, -np.einsum("cij,cj->ci", rot, centers)], 1)
    cam_idx, pt_idx = np.nonzero(rng.random((n_cams, n_pts)) >= 0.2)
    xc = np.einsum("oij,oj->oi", rot[cam_idx], pts[pt_idx]) \
        + cams[cam_idx, 3:]
    uv = xc[:, :2] / xc[:, 2:] + rng.normal(0, 1e-3, (len(xc), 2))
    bad = rng.random(len(uv)) < 0.1
    uv[bad] += rng.uniform(0.1, 0.3, (int(bad.sum()), 2))
    o = len(cam_idx)
    pad = (1 << int(np.ceil(np.log2(o)))) - o
    cams[1:] += rng.normal(0, 0.03, cams[1:].shape)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return dict(
        cameras=torch.tensor(cams, dtype=torch.float32),
        points=torch.tensor(pts + rng.normal(0, 0.05, pts.shape),
                            dtype=torch.float32),
        cam_idx=torch.tensor(np.pad(cam_idx, (0, pad))),
        pt_idx=torch.tensor(np.pad(pt_idx, (0, pad))),
        uv=torch.tensor(np.pad(uv, ((0, pad), (0, 0))), dtype=torch.float32),
        mask=torch.tensor(np.arange(o + pad) < o),
        fixed_cams=torch.tensor(fixed))


def card_plans(index, n_segments, valid=None):
    """segsum.make_plan as on the card: the plan carries its order (the
    CPU's segment_sum still adds with index_add_)."""
    index = index.reshape(-1).long()
    return segsum.Plan(index, int(n_segments), valid,
                       *segsum.order(index, n_segments, valid))


@pytest.fixture
def fake_card(monkeypatch):
    """The process cache replaced by one whose capture is fake and that
    takes CPU tensors for the card's, and plans made as on the card: the
    path bundle_adjust takes on the card."""
    cache = graphs.GraphCache(capture=fake_capture, on_card=lambda ts: True)
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(segsum, "make_plan", card_plans)
    return cache


def counts(cache) -> tuple:
    return cache.hits, cache.misses, cache.replays, cache.refused


def traced_ba(d: dict, **kw):
    """bundle_adjust on rig d, and the attributes of its sfm.ba span."""
    profiling.clear()
    with profiling.tracing():
        out = ba.bundle_adjust(ba.BAProblem(**d), **kw)
    (rec,) = [s.attrs for s in profiling.spans() if s.name == "sfm.ba"]
    profiling.clear()
    return out, rec


@pytest.mark.parametrize("loss", ["cauchy", "huber"])
def test_replayed_iterations_are_the_frozen_eager_copy(fake_card, loss):
    d = rig(1)
    kw = dict(iters=ITERS, cg_iters=CG_ITERS, loss=loss)
    got, rec = traced_ba(d, **kw)
    want = frozen.bundle_adjust(frozen.BAProblem(**d), **kw)
    assert graphs.same_bits((got.cameras, got.points),
                            (want.cameras, want.points))
    # the problem moved, the fixed camera did not, and the masked rows
    # (a quarter of the table) were summed
    assert not torch.equal(got.cameras[1:], d["cameras"][1:])
    assert torch.equal(got.cameras[0], d["cameras"][0])
    assert int((~d["mask"]).sum()) > d["mask"].numel() // 8
    # the first iteration ran eagerly and was captured, the rest replayed
    assert counts(fake_card) == (ITERS - 1, 1, ITERS, 0)
    assert rec["graph_hit"] is False


def test_calls_of_one_shape_share_a_key_and_replay(fake_card):
    a, b = rig(2), rig(2)
    b["points"] = b["points"] * 1.01
    ba.bundle_adjust(ba.BAProblem(**a), iters=ITERS, cg_iters=CG_ITERS,
                     loss="cauchy")
    assert counts(fake_card) == (ITERS - 1, 1, ITERS, 0)
    got, rec = traced_ba(b, iters=5, cg_iters=CG_ITERS, loss="cauchy")
    # another call, values and iteration count of the same shapes: every
    # iteration a hit, on the one key
    assert counts(fake_card) == (ITERS - 1 + 5, 1, ITERS + 5, 0)
    assert rec["graph_hit"] is True and rec["iters"] == 5
    want = frozen.bundle_adjust(frozen.BAProblem(**b), iters=5,
                                cg_iters=CG_ITERS, loss="cauchy")
    assert graphs.same_bits((got.cameras, got.points),
                            (want.cameras, want.points))
    (key,) = fake_card.keys()
    o, c, p = a["mask"].numel(), a["cameras"].shape[0], a["points"].shape[0]
    assert key[0] == "ba.lm_iter" and key[2] == (3e-3, "cauchy", CG_ITERS)
    assert [s[0] for s in key[1]] == [
        (c, 6), (p, 3), (), (o,), (o,), (o, 2), (o,), (c,), (o,), (c + 1,),
        (o,), (p + 1,)]
    # another loss or CG count is another key
    ba.bundle_adjust(ba.BAProblem(**a), iters=2, cg_iters=CG_ITERS,
                     loss="huber")
    ba.bundle_adjust(ba.BAProblem(**a), iters=2, cg_iters=CG_ITERS + 1,
                     loss="cauchy")
    assert fake_card.misses == 3 and len(fake_card.keys()) == 3


def test_cpu_tensors_leave_the_process_cache_untouched():
    d = rig(3)
    graphs.CACHE.clear()
    got, rec = traced_ba(d, iters=ITERS, cg_iters=CG_ITERS, loss="cauchy")
    want = frozen.bundle_adjust(frozen.BAProblem(**d), iters=ITERS,
                                cg_iters=CG_ITERS, loss="cauchy")
    assert graphs.same_bits((got.cameras, got.points),
                            (want.cameras, want.points))
    assert counts(graphs.CACHE) == (0, 0, 0, 0) and graphs.CACHE.keys() == []
    assert rec["graph_hit"] is False


def test_the_sharded_loop_stays_eager(fake_card):
    """bundle_adjust_loop with a psum (parallel/ba.py's path; here the
    identity of one rank) never reaches the cache, even where the card's
    path would, and gives the frozen loop's bits."""
    d = rig(4)
    calls = []

    def psum(t):
        calls.append(t.shape)
        return t
    got = ba.bundle_adjust_loop(ba.BAProblem(**d), ITERS, CG_ITERS, 3e-3,
                                "huber", 1e-3, psum=psum)
    want = frozen.bundle_adjust_loop(frozen.BAProblem(**d), ITERS, CG_ITERS,
                                     3e-3, "huber", 1e-3, psum=lambda t: t)
    assert graphs.same_bits((got.cameras, got.points),
                            (want.cameras, want.points))
    assert counts(fake_card) == (0, 0, 0, 0) and fake_card.keys() == []
    # 6 + 2 cg_iters segment sums and 2 costs an iteration, all-reduced
    assert len(calls) == ITERS * (6 + 2 * CG_ITERS + 2)
