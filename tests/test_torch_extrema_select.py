"""K2's compact scan and its select kernel (csrc/extrema.cu), held on the
CPU through NumPy models of their algorithms:

- the scan takes the 3x3x3 max and min including the centre, separably
  (a 3x3 box per plane, shared by the layers above and below), in
  launches of at most kMaxLayers layers: the model equals `extrema_mask`
  and the Pallas kernel's candidates on ties, plateaus and both signs,
  at the default nL and at one that takes two launches;
- the select kernel packs each candidate as float_bits(score) << 32 |
  (0xFFFFFFFF - flat index) and takes the keys in the order the scan
  appended them (any order). Up to SHARED_SORT_KEYS slots it runs as a
  grid of select_shape's CTAs a frame, which the model runs one by one:
  each stages the list (up to `stage` keys; past that it radix-selects
  the cap-th largest with 8-bit digit histograms and packs the kept keys
  thread by thread), ranks its slice of the staged list against the
  whole list, two keys a thread over parts of the list, and writes each key
  ranked below cap at its rank; the gap slots take the
  lowest indices that are no candidate, straight or through a bitmap and
  a prefix sum of its zeros, split over the CTAs. Every slot is written
  exactly once. Past SHARED_SORT_KEYS slots one block sorts the kept keys
  with the bitonic network in a device-memory scratch. The model equals
  `top_candidates_plain` (a stable sort of the dense scores) exactly, on
  all four outputs, at every launch shape it is given, and equals
  `select_candidates_plain` on key lists built at the shape's edges.

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

import chip_smoke

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

from _torch_threads import one_thread  # noqa: F401

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
        r"constexpr int (kMaxSharedKeys|kMaxLayers|kSelThreads) = (\d+);",
        src)}


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


def _radix_threshold(keys: np.ndarray, cap: int) -> tuple:
    """The kernel's radix select: the key at or above which exactly cap
    keys lie (len(keys) > cap), and the shift of its last digit."""
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
            return prefix, shift
    raise AssertionError("radix select did not end")


def _bitonic(a: np.ndarray, descending: bool) -> np.ndarray:
    """The scratch path's bitonic network on a power-of-two array: each
    step compare-exchanges the n2 / 2 pairs (i, i + j)."""
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


def _network_model(listed: np.ndarray, cap: int, total: int):
    """The scratch path (one block, bitonic network in device memory):
    the flat indices of slots 0..min(cap, total)-1, and whether the gaps
    took the general (merge) path."""
    n = len(listed)
    lowest = _radix_threshold(listed, cap)[0] if n > cap else 0
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
    return idx, general


def _chunk(span: int, g: int, ctas: int) -> tuple:
    """csrc/extrema.cu chunk_of: CTA g's part [lo, hi) of span items,
    chunks of span / 2^lg + 1 (2^lg <= ctas < 2^(lg + 1))."""
    per = (span >> (ctas.bit_length() - 1)) + 1
    lo = min(g * per, span)
    return lo, min(lo + per, span)


def _index(x) -> np.ndarray:
    return np.uint64(MASK32) - (np.asarray(x, np.uint64) & np.uint64(MASK32))


def _rank_model(listed: np.ndarray, cap: int, total: int, ctas: int,
                stage: int, info: dict):
    """rank_select_kernel, CTA by CTA: the flat index of every slot
    0..cap-1 and its valid flag; fails unless every slot is written
    exactly once. info receives the path taken."""
    threads = _kernel_consts()["kSelThreads"]
    n = len(listed)
    slots = min(cap, total)
    assert slots <= stage <= extrema_cuda.SHARED_SORT_KEYS
    m = min(n, cap)
    gaps = slots - m
    ny = n if n <= stage else cap
    if n <= stage:
        staged = listed
    else:
        # the cap-th largest key, then thread t's kept keys in list
        # order, threads in order
        lowest, info["radix_shift"] = _radix_threshold(listed, cap)
        staged = np.concatenate([
            listed[t::threads][listed[t::threads] >= np.uint64(lowest)]
            for t in range(threads)])
        assert len(staged) == cap
        info["packed"] = True
    general = n <= stage and bool((_index(listed) < gaps).any())
    info["general"] = general
    idx = np.full(cap, -1, np.int64)
    ok = np.zeros(cap, bool)
    writes = np.zeros(cap, np.int64)

    def write(slot, i, valid):
        slot = np.asarray(slot, np.int64)
        idx[slot] = i
        ok[slot] = valid
        np.add.at(writes, slot, 1)

    idx_all = _index(staged).astype(np.int64)
    for g in range(ctas):
        lo, hi = _chunk(ny, g, ctas)
        ns = hi - lo
        if ns:
            npair = -(-ns // 2)   # a thread takes keys i and i + npair
            parts = (1 if npair >= threads
                     else max(1, min(threads // npair, ny >> 5)))
            assert npair * parts <= threads or parts == 1
            x = staged[lo:hi]
            rank = np.zeros(ns, np.int64)
            size = ny // parts + 1
            bounds = [min(p * size, ny) for p in range(parts + 1)]
            assert bounds[0] == 0 and bounds[-1] == ny
            for p in range(parts):
                y = staged[bounds[p]:bounds[p + 1]]
                rank += (y[None, :] > x[:, None]).sum(axis=1)
            kept = rank < cap
            write(rank[kept], idx_all[lo:hi][kept], True)
        if not general:
            q0, q1 = _chunk(cap - m, g, ctas)
            q = np.arange(m + q0, m + q1)
            write(q, np.where(q < slots, q - m, 0), False)
            continue
        words = -(-slots // 32)
        bits = np.zeros(words * 32, bool)
        below = idx_all[idx_all < slots]
        bits[below] = True
        free = ~bits
        zeros = np.concatenate([[0], np.cumsum(free.reshape(words, 32)
                                               .sum(axis=1))])[:-1]
        q0, q1 = _chunk(words, g, ctas)
        i = np.arange(q0 * 32, min(q1 * 32, slots))
        i = i[free[i]]
        j = zeros[i >> 5] + np.array(
            [free[(k >> 5) * 32:k].sum() for k in i], np.int64)
        take = j < gaps
        write(m + j[take], i[take], False)
        q0, q1 = _chunk(cap - slots, g, ctas)
        write(np.arange(slots + q0, slots + q1), 0, False)
    np.testing.assert_array_equal(writes, 1)
    return idx, ok


def _select_model(listed: np.ndarray, cap: int, nl: int, h: int, w: int,
                  shape=None, info=None):
    """The select kernel on one frame's list: (layer, r, c, valid) each
    (cap,), and whether the gaps took the general path. shape: (ctas,
    stage) of the rank select, default select_shape's for one frame on a
    132-SM card; past SHARED_SORT_KEYS slots the scratch path runs."""
    hw = h * w
    total = nl * hw
    info = {} if info is None else info
    if min(cap, total) > extrema_cuda.SHARED_SORT_KEYS:
        got, general = _network_model(listed, cap, total)
        slots = min(cap, total)
        valid = np.arange(cap) < min(len(listed), cap)
        idx = np.array(got + [0] * (cap - slots), np.int64)
        info["general"] = general
    else:
        ctas, stage = shape or extrema_cuda.select_shape(cap, total, 1, 132)
        idx, valid = _rank_model(listed, cap, total, ctas, stage, info)
        general = info["general"]
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


def _shapes(cap: int, total: int) -> list:
    """Launch shapes the model runs each case at: select_shape's for one
    frame and for eight on a 132-SM card, one CTA staging only the slots
    (so n > cap packs the kept keys), and 7 CTAs staging select_shape's
    keys."""
    if min(cap, total) > extrema_cuda.SHARED_SORT_KEYS:
        return [None]
    one = extrema_cuda.select_shape(cap, total, 1, 132)
    return [one, extrema_cuda.select_shape(cap, total, 8, 132),
            (1, min(cap, total)), (7, one[1])]


def _check(dog: np.ndarray, cap: int, seed: int = 0):
    """The model on dog equals top_candidates_plain at every launch
    shape of _shapes; returns (n, the general-gap flag)."""
    listed = _appended(dog, np.random.default_rng(seed))
    nl = TCFG.n_octave_layers
    want = text.top_candidates_plain(torch.from_numpy(dog), cap, TCFG)
    flags = set()
    for shape in _shapes(cap, nl * dog.shape[1] * dog.shape[2]):
        got, general = _select_model(listed, cap, nl, *dog.shape[1:], shape)
        for g, t in zip(got, want):
            np.testing.assert_array_equal(g, t.numpy())
        flags.add(general)
    assert len(flags) == 1
    return len(listed), general


def _listed(rng, n: int, total: int, tied: bool = False,
            low: int = 0) -> np.ndarray:
    """A frame's key list of n candidates at distinct flat indices of a
    total-index field, in a shuffled order: random scores, or one score
    for all (tied: the keys differ only in their index bits); `low` of
    the indices lie below 64, the rest anywhere."""
    idx = np.concatenate([
        rng.choice(64, low, replace=False),
        64 + rng.choice(total - 64, n - low, replace=False)])
    score = (np.full(n, 20.0) if tied else rng.uniform(1.0, 50.0, n)
             ).astype(np.float32)
    bits = score.view(np.uint32).astype(np.uint64)
    keys = (bits << np.uint64(32)) | (np.uint64(MASK32) - idx.astype(
        np.uint64))
    return keys[rng.permutation(n)]


def _against_plain(lists, cap: int, hw, shape, nl: int = 2):
    """The model on each frame's list at `shape` equals
    select_candidates_plain on the (B, nl*H*W) keys; returns each
    frame's info."""
    total = nl * hw[0] * hw[1]
    keys = np.zeros((len(lists), total), np.int64)
    for b, listed in enumerate(lists):
        keys[b, :len(listed)] = listed.astype(np.int64)
    count = torch.tensor([len(x) for x in lists], dtype=torch.int32)
    want = select_candidates_plain(torch.from_numpy(keys), count, cap, hw)
    infos = []
    for b, listed in enumerate(lists):
        info = {}
        got, _ = _select_model(listed, cap, nl, *hw, shape, info)
        for g, t in zip(got, want):
            np.testing.assert_array_equal(g, t[b].numpy())
        infos.append(info)
    return infos


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


HW = (40, 64)
TOTAL = 2 * HW[0] * HW[1]


def _edge_counts(cap: int, ctas: int, stage: int) -> list:
    """chip_smoke.py's counts at the edges of a launch shape (slices of
    1, 32 and kSelThreads keys a CTA and their neighbours, cap +- 1,
    stage and stage + 1), inside the test's field."""
    return [c for c in chip_smoke.select_edge_counts(
        cap, ctas, stage, _kernel_consts()["kSelThreads"]) if c <= TOTAL]


@pytest.mark.parametrize("cap,shape", [
    (512, None), (512, (1, 512)), (512, (3, 1024)), (128, None),
    (128, (128, 256)), (2000, (5, 4000))])
def test_rank_select_at_the_partition_edges(cap, shape):
    # n at the slices', warps' and parts' boundaries, n = cap +- 1 and
    # n = stage + 1: the model at that shape is select_candidates_plain
    shape = shape or extrema_cuda.select_shape(cap, TOTAL, 1, 132)
    rng = np.random.default_rng(cap + shape[0])
    paths = set()
    for n in _edge_counts(cap, *shape):
        (info,) = _against_plain([_listed(rng, n, TOTAL)], cap, HW, shape)
        paths.add((n > cap, bool(info.get("packed"))))
    assert (True, True) in paths and (False, False) in paths


@pytest.mark.parametrize("n", [300, 5000])
def test_tied_plateau_reaches_the_index_digits(n):
    # one score for every key: the ranks order the ties by their index
    # bits (n <= stage); past stage the radix select resolves the cap-th
    # key in the low (index) word before the kept keys are packed
    cap = 200
    rng = np.random.default_rng(n)
    shape = extrema_cuda.select_shape(cap, TOTAL, 1, 132)
    assert (n > shape[1]) == (n == 5000)
    (info,) = _against_plain([_listed(rng, n, TOTAL, tied=True)], cap, HW,
                             shape)
    assert info.get("radix_shift", 0) < 32 and ("radix_shift" in info) == (
        n == 5000)


@pytest.mark.parametrize("shape", [None, (1, 600), (9, 600)])
def test_rank_select_general_gap_path(shape):
    # candidates among the first cap - n indices: the gaps come from the
    # bitmap of candidates and the prefix sum of its zeros
    cap = 600
    shape = shape or extrema_cuda.select_shape(cap, TOTAL, 1, 132)
    rng = np.random.default_rng(21)
    for n, low in ((1, 1), (40, 25), (300, 64)):
        (info,) = _against_plain([_listed(rng, n, TOTAL, low=low)], cap, HW,
                                 shape)
        assert info["general"]


def test_batch_with_an_empty_frame_and_one_over_cap():
    # B = 8 at its own launch shape: frame 2 has no candidate, frame 5
    # more than cap (and frame 6 more than stage); each row is its frame
    cap = 256
    rng = np.random.default_rng(22)
    shape = extrema_cuda.select_shape(cap, TOTAL, 8, 132)
    counts = [100, 255, 0, 1, 256, 400, shape[1] + 50, 37]
    infos = _against_plain([_listed(rng, n, TOTAL) for n in counts], cap,
                           HW, shape)
    assert infos[6].get("packed") and not infos[5].get("packed")


def test_select_shape_rule():
    # the launch shape comes from what the host knows: cap, the field,
    # the frames and the SM count
    shape = extrema_cuda.select_shape
    total = 2 * 1080 * 1920
    # the main path on a 132-SM card: 1080p octaves 0..4, one frame and
    # the batch step's 8
    assert [shape(c, total, 1, 132) for c in TCFG.detect_caps] == [
        (128, 8192), (64, 4096), (16, 1024), (8, 512), (4, 256)]
    assert [shape(c, total, 8, 132)[0] for c in TCFG.detect_caps] == [
        33, 33, 16, 8, 4]
    threads = _kernel_consts()["kSelThreads"]
    for cap in (1, 5, 31, 32, 33, 128, 4096, 9000, 16384):
        for tot in (7, 448, 5120, total):
            for frames in (1, 2, 8, 65535):
                for sms in (1, 114, 132):
                    ctas, stage = shape(cap, tot, frames, sms)
                    slots = min(cap, tot)
                    assert 1 <= ctas <= max(1, -(-slots // 32))
                    assert ctas * frames >= min(2 * sms,
                                                frames * -(-slots // 32))
                    assert slots <= stage <= max(
                        slots, min(2 * slots, extrema_cuda.SHARED_SORT_KEYS))
                    # the CTA's shared memory (the staged keys and two
                    # words a 32 slots; the radix select's and the
                    # parts' static arrays) fits one H100 block
                    smem = 8 * stage + 8 * -(-slots // 32)
                    assert smem + 4 * (3 * threads) + 1100 <= 232448
