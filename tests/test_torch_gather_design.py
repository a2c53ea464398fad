"""A NumPy model of K3's gather kernel (csrc/gather.cu) and its launch
plan, on the CPU.

The kernel runs on the card only; chip_smoke.py holds it against
`gather_patches_plain` there. Here the model runs its grid CTA by CTA,
as the kernel splits the work: CTA (n, y) of a (N, CTAs a window) grid
takes keypoint n; its warp w takes R = 2 rows (kRows) from
(y * warps + w) * R, and every CTAs-a-window x warps x R rows after
that; lane j takes columns
j, j + 32, ... j + 32 (C - 1) of each group of 32 C columns, C =
min(ceil(p / 32), 4). Every output element must be written exactly
once, from the clamped source element, so the model equals
`gather_patches_plain` bit for bit.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from sift_tpu_torch.ops import ori_gather_cuda
from sift_tpu_torch.ops.ori_gather_cuda import (gather_grid, gather_patches,
                                                gather_patches_plain,
                                                gather_shape)

from _torch_threads import one_thread  # noqa: F401

SMS = 132


def _cta_elements(y, p, warps, blocks):
    """(rows, columns) of every element CTA (n, y) writes, in the order
    its threads store them: warp by warp, each row block it strides to,
    each group of 32 C columns, R rows, C columns a lane."""
    rows = ori_gather_cuda._ROWS
    chunks = min(-(-p // 32), 4)
    lane = np.arange(32)
    got_i, got_j = [], []
    for w in range(warps):
        i0 = (y * warps + w) * rows
        while i0 < p:
            for g in range(0, p, 32 * chunks):
                i = i0 + np.arange(rows)[:, None, None]
                j = g + lane[None, :, None] + 32 * np.arange(chunks)
                i, j = np.broadcast_arrays(i, j)
                keep = (i < p) & (j < p)
                got_i.append(i[keep])
                got_j.append(j[keep])
            i0 += blocks * warps * rows
    return np.concatenate(got_i), np.concatenate(got_j)


def _model(src, layer, row, col, p, warps, grid_cap=None):
    """K3's CTAs one by one: the (N, p, p) output, and how many times a
    window's CTAs write each of its (p, p) elements (the same for every
    window: a CTA's elements depend on its row block only)."""
    nlay, hp, wp = src.shape
    blocks, threads = gather_grid(p, warps)
    assert threads == 32 * warps
    if grid_cap is not None:
        blocks = min(blocks, grid_cap)
    elements = [_cta_elements(y, p, warps, blocks) for y in range(blocks)]
    writes = np.zeros((p, p), np.int64)
    for i, j in elements:
        writes += np.bincount(i * p + j, minlength=p * p).reshape(p, p)
    out = np.full((len(layer), p, p), np.nan, np.float32)
    for k in range(len(layer)):
        lay = min(max(layer[k], 0), nlay - 1)
        r0 = min(max(row[k], 0), hp - p)
        c0 = min(max(col[k], 0), wp - p)
        for i, j in elements:                 # CTA (k, y)
            out[k, i, j] = src[lay, r0 + i, c0 + j]
    return out, writes


def _inputs(rng, n, p, nlay=3):
    """A stack whose width is no multiple of 4, and starts beyond every
    edge: layers -1 and L, rows and columns before 0 and past Hp - p and
    Wp - p."""
    hp, wp = p + 9, p + 14 + (p % 4 == 2)
    assert wp % 4
    src = rng.standard_normal((nlay, hp, wp)).astype(np.float32)
    layer = rng.integers(-1, nlay + 1, n).astype(np.int32)
    row = rng.integers(-4, hp - p + 5, n).astype(np.int32)
    col = rng.integers(-4, wp - p + 5, n).astype(np.int32)
    edges = [(-1, -7, -9), (nlay, hp, wp), (0, hp - p, wp - p),
             (nlay - 1, hp - p + 1, -1)]
    for k, (lay, r, c) in enumerate(edges[:n]):
        layer[k], row[k], col[k] = lay, r, c
    return src, layer, row, col


def _plain(src, layer, row, col, p):
    return gather_patches_plain(*(torch.from_numpy(a) for a in
                                  (src, layer, row, col)), p).numpy()


@pytest.mark.parametrize("p", [1, 2, 31, 32, 33, 39, 85, 128, 129, 200])
@pytest.mark.parametrize("n", [0, 1, 64, 300])
def test_model_writes_every_element_once_from_its_clamped_source(p, n):
    rng = np.random.default_rng(1000 * p + n)
    src, layer, row, col = _inputs(rng, n, p)
    got, writes = _model(src, layer, row, col, p, gather_shape(n, p, SMS))
    assert got.shape == (n, p, p)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, _plain(src, layer, row, col, p))


@pytest.mark.parametrize("warps,cap", [(1, None), (3, None), (32, None),
                                       (1, 3), (2, 1)])
def test_model_at_other_launch_shapes_and_a_capped_grid(warps, cap):
    # any warps a CTA the C entry takes gives the same windows; a grid cut
    # below the row blocks (the kernel's cap is 65,535) strides over the
    # rest
    p, n = 85, 7
    src, layer, row, col = _inputs(np.random.default_rng(5), n, p)
    got, writes = _model(src, layer, row, col, p, warps, grid_cap=cap)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, _plain(src, layer, row, col, p))


def _kernel_constants() -> dict:
    src = (pathlib.Path(ori_gather_cuda.__file__).parent.parent / "csrc"
           / "gather.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (kRows|kMaxWarps|kMaxGridY) = (\d+);", src)}


def test_gather_shape_rules():
    max_warps = _kernel_constants()["kMaxWarps"]
    for sms in (1, 78, 132):
        for n in (1, 2, 7, 64, 263, 264, 1024, 8192, 32768):
            for p in (1, 2, 31, 33, 39, 63, 64, 85, 128, 129, 200, 1000):
                warps = gather_shape(n, p, sms)
                ctas, threads = gather_grid(p, warps)
                rows = ori_gather_cuda._ROWS
                assert 1 <= warps <= max_warps and threads == 32 * warps
                # every CTA has rows to copy, and every row a CTA
                assert (ctas - 1) * rows * warps < p <= ctas * rows * warps
                assert 1 <= ctas <= ori_gather_cuda._MAX_GRID_Y
                # two CTAs an SM, unless every CTA is one warp already
                assert n * ctas >= 2 * sms or warps == 1
    # the descriptor stage's chunk: 64 windows of 85 x 85
    warps = gather_shape(64, 85, 132)
    assert warps == 4
    assert 64 * gather_grid(85, warps)[0] >= 2 * 132


def test_wrapper_grid_cap_is_the_kernels():
    assert _kernel_constants()["kMaxGridY"] == ori_gather_cuda._MAX_GRID_Y


def test_wrapper_rows_a_warp_are_the_kernels():
    assert _kernel_constants()["kRows"] == ori_gather_cuda._ROWS


def test_wrapper_takes_the_plain_version_on_the_cpu():
    src, layer, row, col = _inputs(np.random.default_rng(3), 9, 39)
    before = gather_patches.launches
    got = gather_patches(*(torch.from_numpy(a) for a in
                           (src, layer, row, col)), 39)
    assert gather_patches.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  _plain(src, layer, row, col, 39))
