"""The fixed-order segment sum (ops/segsum.py, csrc/segsum.cu) on the CPU.

A NumPy twin of the kernel's loop -- each segment's rows read through the
plan, a tile at a time, and added in row order into out's value, one
float32 rounding an add -- is bit for bit index_add_ on the CPU, which
is the plain version; the plan's sort is stable; and the bundle adjuster
and the pose graph with the twin in place of their sums give the same
bits as with index_add_. No JAX here: the twin is the kernel's
counterpart, and tests/test_torch_sfm.py holds the solvers to sift_tpu.
"""

import re
import pathlib

import numpy as np
import pytest
import torch

from sift_tpu_torch.ops import segsum
from sift_tpu_torch.sfm import ba as tba
from sift_tpu_torch.sfm import posegraph as tpg

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "sift_tpu_torch"
        / "csrc" / "segsum.cu").read_text()
K_COLS = int(re.search(r"constexpr int kCols = (\d+);", CSRC).group(1))
K_TILE = int(re.search(r"constexpr int kTileElems = (\d+);", CSRC).group(1))


def kernel_twin(out: np.ndarray, perm: np.ndarray, offsets: np.ndarray,
                x: np.ndarray) -> np.ndarray:
    """csrc/segsum.cu's loop: a CTA a (segment, chunk of K_COLS columns),
    tiles of K_TILE // cw rows gathered through perm, each column's
    accumulator started from out and advanced one rounded add a row."""
    out = out.reshape(out.shape[0], -1).astype(np.float32).copy()
    w = out.shape[1]
    x = x.reshape(x.shape[0], w).astype(np.float32)
    for s in range(out.shape[0]):
        begin, end = int(offsets[s]), int(offsets[s + 1])
        if begin >= end:
            continue
        for c0 in range(0, w, K_COLS):
            cw = min(K_COLS, w - c0)
            acc = out[s, c0:c0 + cw].copy()
            rows = K_TILE // cw
            for r0 in range(begin, end, rows):
                tile = x[perm[r0:min(r0 + rows, end)], c0:c0 + cw]
                for row in tile:
                    acc = (acc + row).astype(np.float32)
            out[s, c0:c0 + cw] = acc
    return out


def twin_sum(out: torch.Tensor, plan, x: torch.Tensor) -> torch.Tensor:
    """segment_sum as the card computes it, on CPU tensors: the card's
    plan (segsum.order) and the kernel's loop."""
    perm, offsets = segsum.order(plan.index, plan.n_segments, plan.valid)
    got = kernel_twin(out.numpy(), perm.numpy(), offsets.numpy(),
                      x.contiguous().numpy())
    out.copy_(torch.from_numpy(got.reshape(out.shape)))
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().numpy().view(np.uint32)


def _case(rng, n_seg, n_rows, width, dist):
    if dist == "one":
        idx = np.full(n_rows, n_seg // 2)
    elif dist == "skewed":               # a few heavy segments, many empty
        idx = np.minimum(rng.geometric(0.3, n_rows) - 1, n_seg - 1)
    else:
        idx = rng.integers(0, n_seg, n_rows)
    # magnitudes over many decades, so that the order of the adds moves
    # the rounding
    x = (rng.standard_normal((n_rows, width))
         * 10.0 ** rng.uniform(-4, 4, (n_rows, 1))).astype(np.float32)
    out = (rng.standard_normal((n_seg, width)) * 100).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(x), torch.from_numpy(out)


@pytest.mark.parametrize("width", [1, 3, 6, 9, 36, 70])
@pytest.mark.parametrize("dist", ["uniform", "skewed", "one"])
def test_twin_is_index_add_bit_for_bit(width, dist):
    """Widths of the BA's and the pose graph's sums (and one over a
    chunk), empty segments, one segment holding every row, a non-zero
    out; the order of the adds is visible in the bits."""
    rng = np.random.default_rng([width, len(dist)])
    idx, x, out = _case(rng, 40, 3000 if width < 36 else 600, width, dist)
    want = out.clone().index_add_(0, idx, x)
    plan = segsum.make_plan(idx, 40)
    got = twin_sum(out.clone(), plan, x)
    assert np.array_equal(_bits(got), _bits(want))
    # the plain version is index_add_ itself
    plain = segsum.segment_sum(out.clone(), plan, x)
    assert np.array_equal(_bits(plain), _bits(want))
    # another order of the same rows rounds differently: the check sees
    # the order
    shuffled = torch.from_numpy(rng.permutation(len(idx)))
    moved = out.clone().index_add_(0, idx[shuffled], x[shuffled])
    if dist != "uniform" or width > 1:
        assert not np.array_equal(_bits(moved), _bits(want))


def test_twin_on_a_non_contiguous_x_and_trailing_shape():
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 7, 500))
    base = torch.from_numpy(rng.standard_normal((6, 6, 500)).astype(
        np.float32))
    x = base.permute(2, 0, 1)                     # (500, 6, 6), strided
    assert not x.is_contiguous()
    out = torch.from_numpy(rng.standard_normal((7, 6, 6)).astype(np.float32))
    want = out.clone().index_add_(0, idx, x)
    got = twin_sum(out.clone(), segsum.make_plan(idx, 7), x)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(
        _bits(segsum.segment_sum(out.clone(), segsum.make_plan(idx, 7), x)),
        _bits(want))


def test_empty_rows_and_segments():
    idx = torch.zeros(0, dtype=torch.long)
    out = torch.ones(5, 3)
    plan = segsum.make_plan(idx, 5)
    assert torch.equal(twin_sum(out.clone(), plan, torch.zeros(0, 3)), out)
    assert torch.equal(segsum.segment_sum(out.clone(), plan,
                                          torch.zeros(0, 3)), out)
    perm, offsets = segsum.order(idx, 5)
    assert perm.numel() == 0 and offsets.tolist() == [0] * 6


def test_plan_permutation_is_stable():
    """perm lists each segment's rows in ascending order (a stable sort
    of the index, int32), and offsets where each segment starts."""
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 9, 2000)
    idx[idx == 4] = 5                            # segment 4 empty
    perm, offsets = segsum.order(torch.from_numpy(idx), 10)
    assert perm.dtype == torch.int32 and offsets.dtype == torch.int32
    want = np.argsort(idx, kind="stable")
    assert np.array_equal(perm.numpy(), want)
    counts = np.bincount(idx, minlength=10)
    assert np.array_equal(offsets.numpy(),
                          np.concatenate([[0], np.cumsum(counts)]))
    assert offsets[4] == offsets[5]


def test_rows_left_out_sort_past_the_last_segment():
    """A plan with `valid` never reads the rows it leaves out; where they
    are zeros and the sum starts from zeros, the bits are index_add_'s
    over every row (the BA's padded observation table)."""
    rng = np.random.default_rng(5)
    idx = np.concatenate([rng.integers(0, 8, 600), np.zeros(400, np.int64)])
    valid = np.arange(1000) < 600
    perm, offsets = segsum.order(torch.from_numpy(idx), 8,
                                 torch.from_numpy(valid))
    assert offsets[-1] == 600 and set(perm[:600].tolist()) == set(range(600))
    x = rng.standard_normal((1000, 6)).astype(np.float32)
    x[~valid] = np.where(rng.random((400, 6)) < 0.5, 0.0, -0.0)
    out = torch.zeros(8, 6)
    plan = segsum.make_plan(torch.from_numpy(idx), 8, torch.from_numpy(valid))
    want = out.clone().index_add_(0, torch.from_numpy(idx),
                                  torch.from_numpy(x))
    got = twin_sum(out.clone(), plan, torch.from_numpy(x))
    assert np.array_equal(_bits(got), _bits(want))


def test_shapes_are_checked():
    plan = segsum.make_plan(torch.tensor([0, 1, 1]), 2)
    with pytest.raises(ValueError):
        segsum.segment_sum(torch.zeros(3, 2), plan, torch.zeros(3, 2))
    with pytest.raises(ValueError):
        segsum.segment_sum(torch.zeros(2, 2), plan, torch.zeros(3, 3))
    with pytest.raises(ValueError):
        segsum.segment_sum(torch.zeros(2, 2, dtype=torch.float64), plan,
                           torch.zeros(3, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        segsum.segment_sum(torch.zeros(2, 4)[:, ::2], plan, torch.zeros(3, 2))


def _ba_problem(seed: int, c: int = 6, p: int = 120) -> tba.BAProblem:
    """Cameras around a point cloud, noisy, every point seen by 3-5
    cameras, padded rows at the end; camera 0 fixed."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1, 1, p), rng.uniform(-1, 1, p),
                    rng.uniform(4, 6, p)], 1)
    cams = np.zeros((c, 6))
    cams[:, 1] = np.linspace(-0.2, 0.2, c)
    cams[:, 3] = np.linspace(-0.5, 0.5, c)
    cam_idx, pt_idx, uv = [], [], []
    for j in range(p):
        for i in rng.choice(c, rng.integers(3, 6), replace=False):
            w = cams[i, :3]
            th = np.linalg.norm(w)
            k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                          [-w[1], w[0], 0]]) / max(th, 1e-12)
            r = (np.eye(3) + np.sin(th) * k
                 + (1 - np.cos(th)) * k @ k)
            xc = r @ pts[j] + cams[i, 3:]
            cam_idx.append(i)
            pt_idx.append(j)
            uv.append(xc[:2] / xc[2] + rng.normal(0, 1e-3, 2))
    o = len(cam_idx)
    cap = 1 << int(np.ceil(np.log2(o + 5)))
    pad = cap - o
    noisy_cams = cams + rng.normal(0, 1e-2, cams.shape)
    noisy_cams[0] = cams[0]
    noisy_pts = pts + rng.normal(0, 5e-2, pts.shape)
    fixed = np.zeros(c, bool)
    fixed[0] = True
    f32 = torch.float32
    return tba.BAProblem(
        cameras=torch.tensor(noisy_cams, dtype=f32),
        points=torch.tensor(noisy_pts, dtype=f32),
        cam_idx=torch.tensor(cam_idx + [0] * pad),
        pt_idx=torch.tensor(pt_idx + [0] * pad),
        uv=torch.tensor(np.concatenate([uv, np.zeros((pad, 2))]), dtype=f32),
        mask=torch.tensor([True] * o + [False] * pad),
        fixed_cams=torch.tensor(fixed))


@pytest.mark.parametrize("loss", ["huber", "cauchy"])
def test_bundle_adjust_with_the_kernel_loop_is_index_add(monkeypatch, loss):
    """bundle_adjust's sums through the card's plan and the kernel's
    loop give the bits of the CPU's index_add_: every camera and point
    after 3 LM iterations of 6 CG steps."""
    prob = _ba_problem(5)
    want = tba.bundle_adjust(prob, iters=3, cg_iters=6, loss=loss)
    monkeypatch.setattr(segsum, "segment_sum", twin_sum)
    got = tba.bundle_adjust(prob, iters=3, cg_iters=6, loss=loss)
    assert np.array_equal(_bits(got.cameras), _bits(want.cameras))
    assert np.array_equal(_bits(got.points), _bits(want.points))
    # and the problem moved: the sums mattered
    assert not torch.equal(want.points, prob.points)


def test_pose_graph_with_the_kernel_loop_is_index_add(monkeypatch):
    """optimize_pose_graph's six sums an iteration (four into the flat
    normal matrix, two into the right-hand side) through the kernel's
    loop give the CPU's bits, on a loop with extra closure edges that
    share vertices."""
    rng = np.random.default_rng(2)
    v = 10
    poses = np.zeros((v, 6), np.float32)
    poses[:, 3] = np.arange(v)
    poses[:, 1] = 0.05 * np.arange(v)
    ei = list(range(v - 1)) + [v - 1, 2, 3, 0]
    ej = list(range(1, v)) + [0, 6, 7, 5]
    rels = rng.normal(0, 0.05, (len(ei), 6)).astype(np.float32)
    rels[:, 3] += 1.0
    fixed = np.zeros(v, bool)
    fixed[0] = True
    g = tpg.PoseGraph(torch.from_numpy(poses), torch.tensor(ei),
                      torch.tensor(ej), torch.from_numpy(rels),
                      torch.ones(len(ei)), torch.ones(len(ei), dtype=bool),
                      torch.from_numpy(fixed))
    want = tpg.optimize_pose_graph(g, iters=4)
    monkeypatch.setattr(segsum, "segment_sum", twin_sum)
    got = tpg.optimize_pose_graph(g, iters=4)
    assert np.array_equal(_bits(got.poses), _bits(want.poses))
    assert not torch.equal(want.poses, g.poses)
