"""K2's compact scan and its select kernel (csrc/extrema.cu), held on the
CPU through NumPy models of their algorithms:

- the scan takes the 3x3x3 max and min including the centre, separably
  (a 3x3 box per plane, shared by the layers above and below), in
  launches of at most kMaxLayers layers: the model equals `extrema_mask`
  and the Pallas kernel's candidates on ties, plateaus and both signs,
  at the default nL and at one that takes two launches;
- the select kernel packs each candidate as float_bits(score) << 32 |
  (0xFFFFFFFF - flat index), takes the keys in the order the scan
  appended them (any order), radix-selects the cap-th largest with 8-bit
  digit histograms when there are more than cap, sorts the kept keys
  with the kernel's bitonic network (in shared memory up to
  SHARED_SORT_KEYS slots, in a device-memory scratch past them; the same
  network) and fills the slots past the count with the lowest indices
  that are no candidate: the model equals `top_candidates_plain` (a
  stable sort of the dense scores) exactly, on all four outputs.

The wrappers take the plain route on the CPU without counting a launch;
chip_smoke.py holds the kernels against the same plain versions on the
card.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.config import DEFAULT_CONFIG as JCFG
from sift_tpu.ops.extrema_pallas import extrema_scores_pallas

from sift_tpu_torch.config import DEFAULT_CONFIG as TCFG
from sift_tpu_torch.ops import extrema as text
from sift_tpu_torch.ops import extrema_cuda
from sift_tpu_torch.ops.extrema_cuda import (extrema_compact,
                                             extrema_compact_plain,
                                             extrema_mask, pack_keys,
                                             select_candidates,
                                             select_candidates_plain)

MASK32 = 0xFFFFFFFF
CSRC = pathlib.Path(extrema_cuda.__file__).resolve().parent.parent / "csrc"


# ---------------------------------------------------------------- models

def _scan_model(dog: np.ndarray, thr: float, border: int, nl: int
                ) -> np.ndarray:
    """(D, H, W) -> (nl, H, W) candidate mask as csrc/extrema.cu takes
    it: zeros outside the image, a horizontal then a vertical 3-max (and
    min) per plane, the max of three planes' boxes, centre included."""
    d, h, w = dog.shape
    p = np.pad(dog[:nl + 2], ((0, 0), (1, 1), (1, 1)))

    def box(f):
        hor = f(f(p[:, :, :-2], p[:, :, 1:-1]), p[:, :, 2:])
        return f(f(hor[:, :-2], hor[:, 1:-1]), hor[:, 2:])

    bmax, bmin = box(np.maximum), box(np.minimum)
    v = dog[1:nl + 1]
    mx = np.maximum(np.maximum(bmax[:-2], bmax[1:-1]), bmax[2:])
    mn = np.minimum(np.minimum(bmin[:-2], bmin[1:-1]), bmin[2:])
    rr, cc = np.arange(h)[:, None], np.arange(w)[None, :]
    inside = ((rr >= border) & (rr < h - border)
              & (cc >= border) & (cc < w - border))
    return (inside & (np.abs(v) > thr)
            & (((v > 0) & (v >= mx)) | ((v < 0) & (v <= mn))))


def _chunked_scan_model(dog: np.ndarray, thr: float, border: int, nl: int,
                        per_launch: int) -> np.ndarray:
    """The scan as launch_scan runs it for nl > per_launch: layers
    l0 + 1 .. l0 + k from planes l0 .. l0 + k + 1, one launch each."""
    return np.concatenate([
        _scan_model(dog[l0:], thr, border, min(per_launch, nl - l0))
        for l0 in range(0, nl, per_launch)])


def _kernel_consts() -> dict:
    src = (CSRC / "extrema.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (kMaxSharedKeys|kMaxLayers) = (\d+);", src)}


def _keys(score: np.ndarray) -> np.ndarray:
    """float32 scores (N,) -> uint64 keys."""
    bits = score.astype(np.float32).view(np.uint32).astype(np.uint64)
    idx = np.arange(score.size, dtype=np.uint64)
    return (bits << np.uint64(32)) | (np.uint64(MASK32) - idx)


def _appended(dog: np.ndarray, rng, nl: int = TCFG.n_octave_layers
              ) -> np.ndarray:
    """The scan's list for one frame: its candidates' keys, in a shuffled
    order (the warps' appends race)."""
    cand = _chunked_scan_model(dog, TCFG.nms_threshold, TCFG.img_border, nl,
                               _kernel_consts()["kMaxLayers"])
    score = np.where(cand, np.abs(dog[1:nl + 1]), -1.0).reshape(-1)
    keys = _keys(score)[cand.reshape(-1)]
    return keys[rng.permutation(len(keys))]


def _radix_threshold(keys: np.ndarray, cap: int) -> int:
    """The kernel's radix select: the key at or above which exactly cap
    keys lie (len(keys) > cap)."""
    prefix, mask, k = 0, 0, cap
    for shift in range(56, -1, -8):
        sel = keys[(keys & np.uint64(mask)) == np.uint64(prefix)]
        hist = np.bincount(((sel >> np.uint64(shift)) & np.uint64(255))
                           .astype(np.int64), minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            h = int(hist[digit])
            if above + h >= k:
                prefix |= digit << shift
                mask |= 255 << shift
                k -= above
                break
            above += h
        if h == k:
            return prefix
    raise AssertionError("radix select did not end")


def _bitonic(a: np.ndarray, descending: bool) -> np.ndarray:
    """The kernel's bitonic network on a power-of-two array: each step
    compare-exchanges the n2 / 2 pairs (i, i + j)."""
    a = a.copy()
    n2 = len(a)
    k = 2
    while k <= n2:
        j = k >> 1
        while j > 0:
            pair = np.arange(n2 // 2)
            i = pair + (pair & ~(j - 1))   # (pair / j) * 2j + pair % j
            ixj = i + j
            x, y = a[i], a[ixj]
            up = ((i & k) == 0) != descending
            swap = np.where(up, x > y, x < y)
            a[i[swap]], a[ixj[swap]] = y[swap], x[swap]
            j >>= 1
        k <<= 1
    return a


def _select_model(listed: np.ndarray, cap: int, nl: int, h: int, w: int):
    """One select block: (layer, r, c, valid) each (cap,), and whether
    the gaps took the general (merge) path."""
    n, hw = len(listed), h * w
    total = nl * hw
    lowest = _radix_threshold(listed, cap) if n > cap else 0
    kept = listed[listed >= np.uint64(lowest)]
    m = len(kept)
    assert m == min(n, cap)
    n2 = 1 << max(m - 1, 0).bit_length()
    sk = _bitonic(np.concatenate([kept, np.zeros(n2 - m, np.uint64)]), True)
    idx = [MASK32 - int(x & np.uint64(MASK32)) for x in sk[:m]]
    slots = min(cap, total)
    gaps = slots - m
    general = gaps > 0 and m > 0 and min(idx) < gaps
    if general:
        asc = _bitonic(np.array(idx + [2 ** 64 - 1] * (n2 - m), np.uint64),
                       False)
        for j in range(gaps):
            lo, hi = 0, m
            while lo < hi:
                mid = (lo + hi) >> 1
                if int(asc[mid]) - mid <= j:
                    lo = mid + 1
                else:
                    hi = mid
            idx.append(j + lo)
    else:
        idx.extend(range(max(gaps, 0)))
    valid = [True] * m + [False] * (cap - m)
    idx = np.array(idx + [0] * (cap - slots), np.int64)
    rem = idx % hw
    return ((idx // hw + 1).astype(np.int32), (rem // w).astype(np.int32),
            (rem % w).astype(np.int32), np.array(valid)), general


# ---------------------------------------------------------------- inputs

def _noise(rng, shape=(4, 40, 64), scale=12.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _plateau_dog(rng):
    """A wide positive plateau (every interior pixel of it a candidate,
    all with one score) and a smaller negative one, over noise."""
    dog = _noise(rng)
    dog[:, 8:32, 8:56] = 20.0
    dog[1:4, 30:36, 20:30] = -30.0
    return dog


def _small_dog(rng, shape):
    """Noise with a positive and a negative peak, for frames too small
    for _planted_dog."""
    dog = _noise(rng, shape)
    dog[1, shape[1] // 2, shape[2] // 2] = 50.0
    dog[2, 6, 7] = -40.0
    return dog


def _planted_dog(rng):
    dog = _noise(rng)
    dog[0:3, 10:13, 10:13] = 30.0      # positive 3x3x3 plateau
    dog[1:4, 20:23, 30:33] = -25.0     # negative plateau
    dog[1, 24, 50] = 50.0              # peak with a tied neighbour
    dog[2, 24, 50] = 50.0
    return dog


def _count(dog) -> int:
    return int(_scan_model(dog, TCFG.nms_threshold, TCFG.img_border,
                           TCFG.n_octave_layers).sum())


def _check(dog: np.ndarray, cap: int, seed: int = 0):
    """The model on dog equals top_candidates_plain; returns (n, the
    general-gap flag)."""
    listed = _appended(dog, np.random.default_rng(seed))
    got, general = _select_model(listed, cap, TCFG.n_octave_layers,
                                 *dog.shape[1:])
    want = text.top_candidates_plain(torch.from_numpy(dog), cap, TCFG)
    for g, t in zip(got, want):
        np.testing.assert_array_equal(g, t.numpy())
    return len(listed), general


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("kind", ["planted", "integer ties", "plateaus",
                                  "negative"])
def test_separable_scan_model_is_extrema_mask(kind):
    rng = np.random.default_rng(3)
    if kind == "planted":
        dog = _planted_dog(rng)
    elif kind == "integer ties":   # many equal neighbours of both signs
        dog = rng.integers(-14, 15, (4, 40, 64)).astype(np.float32)
    elif kind == "plateaus":
        dog = _plateau_dog(rng)
    else:
        dog = -_planted_dog(rng)
    nl = TCFG.n_octave_layers
    got = _scan_model(dog, TCFG.nms_threshold, TCFG.img_border, nl)
    want = extrema_mask(torch.from_numpy(dog), TCFG).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(extrema_scores_pallas(jnp.asarray(dog), JCFG)) > 0)
    assert got.sum() > 10
    # at border 1 the cube reaches the image's first and last rows
    np.testing.assert_array_equal(
        _scan_model(dog, TCFG.nms_threshold, 1, nl),
        extrema_mask(torch.from_numpy(dog),
                     dataclasses.replace(TCFG, img_border=1)).numpy())


def test_scan_model_in_two_launches_is_extrema_mask():
    # nL = 8 > kMaxLayers: layers 1..6 and 7..8 in two launches appending
    # to one list
    per_launch = _kernel_consts()["kMaxLayers"]
    nl = 8
    assert nl > per_launch
    rng = np.random.default_rng(12)
    dog = _noise(rng, (nl + 2, 32, 48))
    dog[5:9, 10:13, 10:13] = 30.0      # a plateau across the launch seam
    dog[6, 20, 30] = -45.0
    cfg = dataclasses.replace(TCFG, n_octave_layers=nl)
    got = _chunked_scan_model(dog, cfg.nms_threshold, cfg.img_border, nl,
                              per_launch)
    want = extrema_mask(torch.from_numpy(dog), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(extrema_scores_pallas(
            jnp.asarray(dog), dataclasses.replace(JCFG, n_octave_layers=nl)))
        > 0)
    assert got[per_launch - 1:per_launch + 1].sum() > 0
    # the select on that list is the plain route at that nL
    listed = _appended(dog, rng, nl)
    sel, _ = _select_model(listed, 64, nl, 32, 48)
    for g, t in zip(sel, text.top_candidates_plain(torch.from_numpy(dog), 64,
                                                   cfg)):
        np.testing.assert_array_equal(g, t.numpy())


def test_keys_order_like_a_stable_descending_sort():
    rng = np.random.default_rng(8)
    score = np.where(rng.random(500) < 0.3,
                     rng.integers(9, 14, 500).astype(np.float32), -1.0)
    score = score.astype(np.float32)
    cand = score > 0
    keys = _keys(score)
    np.testing.assert_array_equal(
        keys.astype(np.int64), pack_keys(torch.from_numpy(score)).numpy())
    by_key = np.nonzero(cand)[0][np.argsort(keys[cand])[::-1]]
    by_sort = torch.sort(torch.from_numpy(score), descending=True,
                         stable=True).indices[:cand.sum()].numpy()
    np.testing.assert_array_equal(by_key, by_sort)
    assert len(np.unique(keys)) == len(keys)


def test_plateau_with_many_more_candidates_than_cap():
    # thousands of tied scores: the radix select resolves the ties in
    # the index bits
    dog = _plateau_dog(np.random.default_rng(1))
    n, _ = _check(dog, 64)
    assert n > 1000


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_cap_around_the_count(delta):
    dog = _planted_dog(np.random.default_rng(4))
    n = _count(dog)
    assert n > 20
    got_n, _ = _check(dog, n - delta, seed=delta + 5)
    assert got_n == n


def test_no_candidate():
    dog = (np.random.default_rng(2).standard_normal((4, 40, 64)) * 2
           ).astype(np.float32)
    n, general = _check(dog, 16)
    assert n == 0 and not general


def test_cap_beyond_the_field():
    dog = _small_dog(np.random.default_rng(6), (4, 14, 16))
    n, _ = _check(dog, 500)        # nL*H*W = 448 slots, then padding
    assert 0 < n


def test_gaps_past_the_border_band_take_the_general_path():
    # cap - n > img_border * W: the gap slots reach past the first border
    # rows, so candidate indices are merged with the gaps
    dog = _small_dog(np.random.default_rng(7), (4, 24, 20))
    cap = 512
    n, general = _check(dog, cap)
    assert cap - n > TCFG.img_border * 20 and general


@pytest.mark.parametrize("cap", [20000, 65536])
def test_caps_past_shared_memory_sort_in_scratch(cap):
    # min(cap, nL*H*W) > SHARED_SORT_KEYS: the same network in a
    # device-memory scratch; 20000 keeps the top of ~20000 plateau
    # candidates, 65536 pads past the field
    h, w = 96, 128
    total = TCFG.n_octave_layers * h * w
    assert (extrema_cuda.sort_keys(cap, total)
            > extrema_cuda.SHARED_SORT_KEYS)
    dog = _noise(np.random.default_rng(13), (4, h, w))
    dog[:, 5:91, 5:123] = 20.0
    n, _ = _check(dog, cap)
    assert n > 20000 if cap == 20000 else cap > total


def test_batch_rows_are_the_single_frames():
    rng = np.random.default_rng(9)
    dogs = np.stack([_planted_dog(rng), _plateau_dog(rng), _noise(rng)])
    cap = 48
    want = text.top_candidates_batch_plain(torch.from_numpy(dogs), cap, TCFG)
    for b in range(len(dogs)):
        got, _ = _select_model(_appended(dogs[b], rng), cap,
                               TCFG.n_octave_layers, *dogs.shape[2:])
        single = text.top_candidates_plain(torch.from_numpy(dogs[b]), cap,
                                           TCFG)
        for g, t, s in zip(got, want, single):
            np.testing.assert_array_equal(g, t[b].numpy())
            assert torch.equal(t[b], s)


@pytest.mark.parametrize("cap", [5, 200, 6000])
def test_plain_compact_and_select_are_the_plain_route(cap):
    # the kernels' plain versions compose to top_candidates_batch_plain
    rng = np.random.default_rng(10)
    dogs = torch.from_numpy(np.stack([_planted_dog(rng), _plateau_dog(rng)]))
    keys, count = extrema_compact_plain(dogs, TCFG)
    assert keys.shape == (2, TCFG.n_octave_layers * 40 * 64)
    for b in range(2):
        listed = keys[b, :count[b]].numpy().astype(np.uint64)
        np.testing.assert_array_equal(
            np.sort(listed), np.sort(_appended(dogs[b].numpy(), rng)))
    got = select_candidates_plain(keys, count, cap, (40, 64))
    want = text.top_candidates_batch_plain(dogs, cap, TCFG)
    for g, t in zip(got, want):
        assert g.dtype == t.dtype and torch.equal(g, t)


def test_cpu_takes_the_plain_route_without_counting():
    rng = np.random.default_rng(11)
    dogs = torch.from_numpy(np.stack([_planted_dog(rng), _planted_dog(rng)]))
    before = (extrema_compact.launches, select_candidates.launches)
    single = text.top_candidates(dogs[0], 32, TCFG)
    batch = text.top_candidates_batch(dogs, 32, TCFG)
    for got, want in zip(single, text.top_candidates_plain(dogs[0], 32,
                                                           TCFG)):
        assert torch.equal(got, want)
    for got, want in zip(batch, text.top_candidates_batch_plain(dogs, 32,
                                                                TCFG)):
        assert torch.equal(got, want)
    keys, count = extrema_compact(dogs, TCFG)
    for got, want in zip(select_candidates(keys, count, 32, (40, 64)),
                         batch):
        assert torch.equal(got, want)
    assert before == (extrema_compact.launches, select_candidates.launches)


@pytest.mark.parametrize("call", ["top_candidates", "top_candidates_batch",
                                  "extrema_compact", "select_candidates"])
def test_other_devices_raise(call):
    meta = torch.empty((2, 4, 16, 16), device="meta")
    calls = {
        "top_candidates": lambda: text.top_candidates(meta[0], 8, TCFG),
        "top_candidates_batch": lambda: text.top_candidates_batch(meta, 8,
                                                                  TCFG),
        "extrema_compact": lambda: extrema_compact(meta, TCFG),
        "select_candidates": lambda: select_candidates(
            torch.empty((2, 512), dtype=torch.int64, device="meta"),
            torch.empty((2,), dtype=torch.int32, device="meta"), 8,
            (16, 16)),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[call]()


def test_select_refuses_what_the_kernel_does_not_take():
    keys = torch.zeros((2, 512), dtype=torch.int64)
    count = torch.zeros((2,), dtype=torch.int32)
    for cap in (0, -3):
        with pytest.raises(ValueError, match="cap"):
            select_candidates(keys, count, cap, (16, 16))
    with pytest.raises(ValueError, match="whole"):
        select_candidates(keys, count, 8, (15, 16))
    with pytest.raises(ValueError, match="int32"):
        select_candidates(keys, count.long(), 8, (16, 16))


@pytest.mark.parametrize("call", ["top_candidates", "top_candidates_batch",
                                  "extrema_compact", "select_candidates"])
def test_fields_past_32_bit_indices_raise_on_every_device(call):
    # 2 x 32768 x 32768 = 2^31 flat indices: one more than the keys hold;
    # meta tensors stand in for both devices, since the check comes first
    meta = torch.empty((1, 4, 32768, 32768), device="meta")
    calls = {
        "top_candidates": lambda: text.top_candidates(meta[0], 8, TCFG),
        "top_candidates_batch": lambda: text.top_candidates_batch(meta, 8,
                                                                  TCFG),
        "extrema_compact": lambda: extrema_compact(meta, TCFG),
        "select_candidates": lambda: select_candidates(
            torch.empty((1, 2 * 32768 * 32768), dtype=torch.int64,
                        device="meta"),
            torch.empty((1,), dtype=torch.int32, device="meta"), 8,
            (32768, 32768)),
    }
    with pytest.raises(ValueError, match="more than 2147483647"):
        calls[call]()


def test_wrapper_limits_are_the_kernels():
    consts = _kernel_consts()
    assert consts["kMaxSharedKeys"] == extrema_cuda.SHARED_SORT_KEYS
    assert consts["kMaxLayers"] == 6
    assert [extrema_cuda.sort_keys(c, 5000) for c in (1, 2, 3, 4096, 4097,
                                                      9000)] == [
        1, 2, 4, 4096, 8192, 8192]
