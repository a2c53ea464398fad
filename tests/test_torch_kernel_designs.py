"""The rules the H100 kernels K1 and K4 are built on, held on the CPU
against the plain PyTorch versions the kernels are compared with on the
card (chip_smoke.py), and against sift_tpu's taps:

- K1 (csrc/blur.cu) sums each scale over its range of nonzero taps only
  (`tap_ranges`), starting from zero: bit for bit the plain version,
  which skips zero taps.
- K4 (csrc/knn2.cu) splits the train set across blocks and threads and
  merges partial top-2s: a NumPy model of that split and merge equals
  `knn2_l1_plain` on tie-heavy inputs, empty splits included.
"""

import numpy as np
import pytest
import torch

from sift_tpu.config import DEFAULT_CONFIG as JCFG
from sift_tpu.ops.conv import _stack_kernels as jax_stack_kernels

from sift_tpu_torch.config import DEFAULT_CONFIG as TCFG
from sift_tpu_torch.ops import conv_cuda
from sift_tpu_torch.ops.conv import stack_kernels, zero_last_row_col
from sift_tpu_torch.ops.conv_cuda import blur_vh_plain, tap_ranges
from sift_tpu_torch.ops.match import mask_train
from sift_tpu_torch.ops.match_cuda import (knn2_l1_plain, split_plan,
                                           split_span)

from _torch_threads import one_thread  # noqa: F401

SIGMAS = {"base": (TCFG.init_blur_sigma,), "octave": TCFG.scale_sigmas()[1:]}
LANES = 16            # threads sharing a query in csrc/knn2.cu (tt)
INF = np.float32(3.0e38)
NO_ROW = np.iinfo(np.int32).max


# ------------------------------------------------------------------- K1

@pytest.mark.parametrize("which,taps", [("base", [9]),
                                        ("octave", [9, 17, 25, 37])])
def test_tap_ranges_cover_exactly_the_nonzero_taps(which, taps):
    kmat, w = stack_kernels(SIGMAS[which])
    # the port's stacked taps are sift_tpu's
    jk = jax_stack_kernels(tuple(float(s) for s in SIGMAS[which]))
    np.testing.assert_array_equal(kmat, np.asarray(jk[0]))
    ranges = tap_ranges(kmat)
    assert ranges.dtype == np.int32 and ranges.shape == (len(taps), 2)
    assert (ranges[:, 1] - ranges[:, 0] + 1).tolist() == taps
    for row, (lo, hi) in zip(kmat, ranges):
        assert (row[lo:hi + 1] != 0).all()
        assert not row[:lo].any() and not row[hi + 1:].any()
    # the stack is centred: the widest scale spans all 2w + 1 taps
    assert ranges[:, 0].min() == 0 and ranges[:, 1].max() == 2 * w


@pytest.mark.parametrize("which", sorted(SIGMAS))
def test_launch_taps_are_computed_once_and_kept_apart_from_the_caller(which):
    kmat, _ = stack_kernels(SIGMAS[which])
    taps, ranges = conv_cuda._prepared(kmat)
    np.testing.assert_array_equal(taps, kmat)
    np.testing.assert_array_equal(ranges, tap_ranges(kmat))
    again = stack_kernels(SIGMAS[which])[0]
    assert conv_cuda._prepared(again)[1] is ranges   # one entry per matrix
    kmat[0, ranges[0, 0] + 1] = 0.0   # a later write, inside the range,
    np.testing.assert_array_equal(taps, again)   # reaches no cached entry
    with pytest.raises(ValueError, match="contiguous"):
        conv_cuda._prepared(kmat)     # and the new matrix is checked anew


def _blur_over_ranges(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """(H, W) -> (S, H, W) as csrc/blur.cu computes it: per scale, each
    output starts at 0 and adds v * t over taps lo..hi in order, one
    float32 rounding per multiply and per add; zeros outside the image."""
    h, w = x.shape
    r = kmat.shape[1] // 2
    out = []
    for taps, (lo, hi) in zip(kmat, tap_ranges(kmat)):
        xp = torch.nn.functional.pad(x, (0, 0, r, r))
        mid = torch.zeros((h, w), dtype=torch.float32)
        for k in range(lo, hi + 1):
            mid = mid + xp[k:k + h] * float(taps[k])
        mp = torch.nn.functional.pad(mid, (r, r))
        acc = torch.zeros((h, w), dtype=torch.float32)
        for k in range(lo, hi + 1):
            acc = acc + mp[:, k:k + w] * float(taps[k])
        out.append(acc)
    return torch.stack(out)


@pytest.mark.parametrize("which", sorted(SIGMAS))
def test_blur_over_tap_ranges_is_the_plain_version_bit_for_bit(which):
    rng = np.random.default_rng(21)
    img = torch.from_numpy((rng.random((64, 64)) * 255).astype(np.float32))
    x = zero_last_row_col(img)
    kmat, _ = stack_kernels(SIGMAS[which])
    assert torch.equal(_blur_over_ranges(x, kmat), blur_vh_plain(x, kmat))


@pytest.mark.parametrize("row", [[0.0, 0.1, 0.0, 0.2, 0.0],
                                 [0.0, 0.0, 0.0, 0.0, 0.0]])
def test_tap_ranges_refuse_a_zero_inside_the_range(row):
    kmat = np.array([[0.0, 0.1, 0.3, 0.1, 0.0], row], np.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tap_ranges(kmat)


# ------------------------------------------------------------------- K4

def _l1(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(N, M) float32 L1 distances summed over dims 0..D-1 in order."""
    dist = np.zeros((len(q), len(t)), np.float32)
    for k in range(q.shape[1]):
        dist = dist + np.abs(q[:, k, None] - t[None, :, k])
    return dist


def _merge(a, b):
    """csrc/knn2.cu merge: b wins on a smaller d1, or an equal d1 with a
    lower index."""
    d1, d2, idx = a
    x1, x2, xi = b
    win = (x1 < d1) | ((x1 == d1) & (xi < idx))
    return (np.where(win, x1, d1),
            np.where(win, np.minimum(d1, x2), np.minimum(d2, x1)),
            np.where(win, xi, idx))


def _knn2_split_model(q, t, p, span):
    """K4's split and merge in NumPy: split s holds train rows
    [s * span, (s + 1) * span); within it, lane l visits the rows with
    (row - start) % 16 == l in increasing order and keeps its best on
    strict <; lanes merge into the split's partial, and the P partials
    merge in split order. Rows nobody holds leave (3e38, 3e38, INT_MAX);
    a query no row reaches gets index 0."""
    n, m = len(q), len(t)
    dist = _l1(q, t)

    def empty():
        return (np.full(n, INF), np.full(n, INF), np.full(n, NO_ROW))

    total = None
    for s in range(p):
        lo, hi = min(m, s * span), min(m, (s + 1) * span)
        lanes = [empty() for _ in range(LANES)]
        for row in range(lo, hi):
            b1, b2, bi = lanes[(row - lo) % LANES]
            x = dist[:, row]
            best, second = x < b1, (x >= b1) & (x < b2)
            lanes[(row - lo) % LANES] = (
                np.where(best, x, b1),
                np.where(best, b1, np.where(second, x, b2)),
                np.where(best, row, bi))
        part = lanes[0]
        for other in lanes[1:]:
            part = _merge(part, other)
        total = part if total is None else _merge(total, part)
    d1, d2, idx = total
    return np.where(idx == NO_ROW, 0, idx).astype(np.int32), d1, d2


def _tie_heavy(m, n=40, seed=13):
    """Queries and train rows with duplicate rows in different splits
    and lanes, queries equal to them, and masked rows."""
    rng = np.random.default_rng(seed + m)
    q = (rng.random((n, 128)) * 0.3).astype(np.float32)
    t = (rng.random((m, 128)) * 0.3).astype(np.float32)
    valid = np.ones(m, bool)
    if m >= 200:
        t[150:160] = t[10:20]      # splits 0 and 1 or 2 (span 64 or 128)
        t[70:75] = t[0:5]          # one split at P <= 3, two lanes apart
        t[130] = t[2]              # a third copy
        q[0:10] = t[10:20]
        q[10:15] = t[0:5]
        q[15] = t[2]
        q[16] = t[33]              # its exact row is masked out
        valid[[7, 33, 199]] = False
    elif m >= 5:
        t[4] = t[1]
        q[0] = t[1]
        q[1] = t[4] + 0.01
    return q, t, valid


@pytest.mark.parametrize("m", [0, 1, 5, 200])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_knn2_split_and_merge_model_is_the_plain_version(p, m):
    q, t, valid = _tie_heavy(m)
    tm = mask_train(torch.from_numpy(t), torch.from_numpy(valid))
    span = split_span(m, p)
    assert span % 64 == 0 and p * span >= m
    idx, d1, d2 = _knn2_split_model(q, tm.numpy(), p, span)
    want = knn2_l1_plain(torch.from_numpy(q), tm)
    np.testing.assert_array_equal(idx, want[0].numpy())
    np.testing.assert_array_equal(d1, want[1].numpy())
    np.testing.assert_array_equal(d2, want[2].numpy())
    if m == 0:
        assert (idx == 0).all() and (d1 == INF).all() and (d2 == INF).all()
    if m == 1:
        assert (d2 == INF).all()
    if m >= 5:                     # the lowest of the tied rows wins
        assert idx[0] == (10 if m >= 200 else 1) and d1[0] == 0 == d2[0]
    if m >= 200:
        assert idx[15] == 2 and idx[16] != 33


@pytest.mark.parametrize("n,m", [(1536, 1536), (64, 1536), (1536, 64),
                                 (300, 5000), (0, 0), (1536, 1)])
def test_split_plan_fills_the_card_and_covers_the_train_set(n, m):
    n_sm = 132
    p, span = split_plan(n, m, n_sm)
    assert p >= 1 and span % 64 == 0 and p * span >= m
    assert span == split_span(m, p)
    m_tiles = -(-m // 64)
    assert p <= max(1, m_tiles)
    q_tiles = max(1, -(-n // 64))
    # two blocks per SM, unless the train set has too few tiles for it
    assert q_tiles * p >= 2 * n_sm or p == max(1, m_tiles)
    if (n, m) == (1536, 1536):
        assert (p, span) == (12, 128)
