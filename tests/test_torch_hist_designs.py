"""The integer accumulation the H100 kernels K3-ori and K3-desc are built
on (csrc/hist_common.cuh), as a NumPy model held on the CPU against the
plain PyTorch versions the kernels are compared with on the card
(chip_smoke.py):

- each sample's bins and float32 value are the plain version's
  arithmetic (K3-desc's 8 trilinear corner weights, both arms; K3-ori's
  wgt * mag);
- each value v becomes the integer rn(v * 2^e) < 2^31, at a
  power-of-two scale per keypoint from the largest finite gradient
  component |dx|, |dy| of its box, and is summed in uint64;
  a bin leaves as float32(sum) * 2^-e; a binned value that is not
  finite makes the row NaN;
- a cluster of CTAs splits the box into row bands, each CTA taking the
  largest finite component of its band's samples.

The model gives the same bits under a permutation of the samples and a
split into bands, stays within the phase-2 tolerance of the plain
versions on small_image's octave-0 keypoints, cannot overflow at the
largest radius on a 0/255 checkerboard, and leaves a row finite beside
an infinity that it does not bin and NaN where it bins a NaN.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sift_tpu_torch import sift as tsift
from sift_tpu_torch.config import DEFAULT_CONFIG as TCFG
from sift_tpu_torch.ops import descriptor as tdesc
from sift_tpu_torch.ops import orientation as tori
from sift_tpu_torch.ops import pyramid as tpyr
from sift_tpu_torch.ops.descr_hist_cuda import descriptor_hist_plain
from sift_tpu_torch.ops.mathutil import fast_atan2_deg
from sift_tpu_torch.ops.ori_hist_cuda import orientation_hist_plain

from _torch_threads import one_thread  # noqa: F401

F32 = np.float32
MAX_EXPONENT = 100    # csrc/hist_common.cuh: kMaxExponent
UNIT_BITS = 29        # csrc/hist_common.cuh: kUnitBits


def _atan2(dy, dx):
    return fast_atan2_deg(torch.from_numpy(dy), torch.from_numpy(dx)).numpy()


def _exp(x):
    # torch.exp, as the plain versions take it: under the bf16 arm a
    # one-ulp difference in a weight (np.exp's) can tip a bfloat16
    # rounding by 2^-9 of a contribution, and the model holds the
    # accumulation, not the exponential
    return torch.exp(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _window(stack, layer, row, col, rad):
    """The clamped (p, p) window of one keypoint (load_band's clamp)."""
    nl, hp, wp = stack.shape
    p = 2 * rad + 3
    lay = min(max(int(layer), 0), nl - 1)
    r0 = min(max(int(row), 0), hp - p)
    c0 = min(max(int(col), 0), wp - p)
    return stack[lay, r0:r0 + p, c0:c0 + p]


def _samples(kind, stack, k, a, cfg, rad, hw, bf16=False):
    """One keypoint's binned samples: (bins, float32 values) with the
    kernels' per-sample arithmetic; the (2R + 1, 2R + 1) largest gradient
    component of each box sample where it is finite (0 elsewhere); and
    whether a binned sample's value is not finite."""
    h, w = hw
    R = min(int(a["radius"][k]), rad)
    off = np.arange(-R, R + 1)
    ii, jj = np.meshgrid(off, off, indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    win = _window(stack, a["layer"][k], a["r"][k], a["c"][k], rad)
    i, j = ii + rad, jj + rad
    with np.errstate(invalid="ignore", over="ignore"):
        dx = win[i + 1, j + 2] - win[i + 1, j]
        dy = win[i, j + 1] - win[i + 2, j + 1]
        g = np.fmax(np.abs(dx), np.abs(dy))
    yy, xx = a["r"][k] + ii, a["c"][k] + jj
    m = (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)
    fi, fj = ii.astype(F32), jj.astype(F32)
    if kind == "ori":
        wgt = _exp((ii * ii + jj * jj).astype(F32) * a["expf"][k])
        with np.errstate(invalid="ignore", over="ignore"):
            v = (wgt * np.sqrt(dx * dx + dy * dy)).astype(F32)
            theta = _atan2(dy, dx)
        n = cfg.ori_hist_bins
        bins = np.rint(np.nan_to_num(F32(n / 360.0) * theta)).astype(
            np.int64)
        bins = np.where(bins >= n, bins - n, bins)
        bins = np.where(bins < 0, bins + n, bins)
        return (bins[m], v[m], _finite_grads(g, R),
                not np.isfinite(v[m]).all())
    d, n = cfg.descr_width, cfg.descr_hist_bins
    ct, st = a["cos_t"][k], a["sin_t"][k]
    c_rot = fj * ct - fi * st
    r_rot = fj * st + fi * ct
    rbin, cbin = r_rot + F32(d / 2 - 0.5), c_rot + F32(d / 2 - 0.5)
    m &= (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
    wgt = _exp((c_rot * c_rot + r_rot * r_rot) * F32(-1.0 / (d * d * 0.5)))
    with np.errstate(invalid="ignore", over="ignore"):
        mag = np.sqrt(dx * dx + dy * dy) * wgt
        obin = np.nan_to_num((_atan2(dy, dx) - a["ori"][k])
                             * F32(n / 360.0))
    r0, c0, o0 = np.floor(rbin), np.floor(cbin), np.floor(obin)
    fr, fc, fo = rbin - r0, cbin - c0, obin - o0
    oi = o0.astype(np.int64)
    oi = np.where(oi < 0, oi + n, oi)
    oi = np.where(oi >= n, oi - n, oi)
    stride = (d + 2) * (n + 2)
    key = (r0.astype(np.int64) + 1) * stride + (c0.astype(np.int64) + 1) * (
        n + 2) + oi
    wr, wc = (F32(1) - fr, fr), (F32(1) - fc, fc)
    with np.errstate(invalid="ignore", over="ignore"):
        wo = [(F32(1) - fo) * mag, fo * mag]
        if bf16:
            wo = [_bf16(x) for x in wo]
        bins, vals = [], []
        for c in range(8):
            rc = wr[c >> 2] * wc[(c >> 1) & 1]
            if bf16:
                rc = _bf16(rc)
            bins.append(key + (c >> 2) * stride + ((c >> 1) & 1) * (n + 2)
                        + (c & 1))
            vals.append((rc * wo[c & 1]).astype(F32))
    return (np.concatenate(bins)[np.tile(m, 8)],
            np.concatenate(vals)[np.tile(m, 8)], _finite_grads(g, R),
            not np.isfinite(mag[m]).all())


def _finite_grads(g, R):
    """The box's largest components where they are finite, 0 elsewhere,
    as (2R + 1, 2R + 1)."""
    return np.where(np.isfinite(g), g, F32(0)).reshape(2 * R + 1, 2 * R + 1)


def _exponent(g):
    """hist_common.cuh scale_exponent of the largest component g (ilogbf
    of an infinity is INT_MAX)."""
    if g == 0:
        return MAX_EXPONENT
    e = np.iinfo(np.int32).max if np.isinf(g) else np.frexp(g)[1] - 1
    return min(UNIT_BITS - e, MAX_EXPONENT)


def _integer_hist(bins, vals, bands, bad, nbins, order=None):
    """The kernels' accumulation: the scale from every CTA's largest
    component, integer units summed in uint64 (in `order`), one float32
    rounding back; all NaN if `bad`. Returns (row, largest unit, largest
    uint64 bin)."""
    if bad:
        return np.full(nbins, np.nan, F32), 0, 0
    e = _exponent(max(bands))
    units = np.rint(vals.astype(np.float64) * 2.0 ** e).astype(np.uint64)
    if order is not None:
        bins, units = bins[order], units[order]
    acc = np.zeros(nbins, np.uint64)
    np.add.at(acc, bins, units)
    return (acc.astype(F32) * F32(2.0 ** -e), int(units.max(initial=0)),
            int(acc.max(initial=0)))


def _band_grads(g, size):
    """Each CTA's largest component: over the sample rows [lo, hi) of
    its band (an empty band has none)."""
    side = g.shape[0]
    out = [F32(0)]
    for rank in range(size):
        lo, hi = side * rank // size, side * (rank + 1) // size
        if hi > lo:
            out.append(g[lo:hi].max())
    return out


def _model(kind, stack, a, cfg, rad, hw, bf16=False, size=1, rng=None):
    nbins = (cfg.ori_hist_bins if kind == "ori" else
             (cfg.descr_width + 2) ** 2 * (cfg.descr_hist_bins + 2))
    rows, unit, peak = [], 0, 0
    for k in range(len(a["r"])):
        bins, vals, g, bad = _samples(kind, stack, k, a, cfg, rad, hw, bf16)
        order = rng.permutation(len(bins)) if rng is not None else None
        row, top, big = _integer_hist(bins, vals, _band_grads(g, size), bad,
                                      nbins, order)
        rows.append(row)
        unit, peak = max(unit, top), max(peak, big)
    return np.stack(rows), unit, peak


def _within(got, want):
    """chip_smoke.hist_err's bound: rtol 1e-5, atol 1e-5 * max|row|."""
    g, x = got.reshape(len(got), -1), want.reshape(len(want), -1)
    atol = 1e-5 * np.abs(x).max(axis=1, keepdims=True)
    assert np.all(np.abs(g - x) <= 1e-5 * np.abs(x) + atol)


@pytest.fixture(scope="module")
def octave0(small_image):
    """small_image's octave-0 stack and its valid keypoints' arguments."""
    cfg = TCFG
    octs = tpyr.build_gaussian_pyramid(torch.from_numpy(small_image), cfg)
    dogs = tpyr.build_dog_pyramid(octs)
    kp = tsift.detect_octave(octs[0], dogs[0], 0, cfg.detect_caps[0], cfg,
                             cfg.out_caps[0])
    v = kp.valid
    assert int(v.sum()) > 50
    gauss = octs[0]
    return gauss, {f: getattr(kp, f)[v] for f in ("layer", "r", "c", "size",
                                                  "angle")}


def _args(kind, gauss, kp, cfg):
    """(plain version's arguments, the model's per-keypoint fields)."""
    nl = cfg.n_octave_layers
    hw = tuple(gauss.shape[1:])
    if kind == "ori":
        rad = cfg.ori_patch_radius
        padded = F.pad(gauss[1:1 + nl], (rad + 1,) * 4)
        radius, expf = tori.orientation_params(kp["size"] * 0.5, cfg)
        args = (padded, kp["layer"] - 1, kp["r"], kp["c"], radius, expf, cfg)
        fields = dict(radius=radius, expf=expf)
    else:
        rad = cfg.descr_patch_radius
        padded = F.pad(gauss[1:1 + nl], (rad + 1,) * 4)
        prm = tdesc.descriptor_params(kp["size"], kp["angle"], torch.ones(1),
                                      hw, cfg)
        valid = torch.ones(len(kp["r"]), dtype=torch.bool)
        args = (padded, kp["layer"] - 1, kp["r"], kp["c"], prm.cos_t,
                prm.sin_t, prm.radius, prm.ori, valid, cfg)
        fields = dict(radius=prm.radius, cos_t=prm.cos_t, sin_t=prm.sin_t,
                      ori=prm.ori)
    fields.update(layer=kp["layer"] - 1, r=kp["r"], c=kp["c"])
    fields = {k: v.numpy() for k, v in fields.items()}
    return args, fields, padded.numpy(), rad, hw


CASES = [("ori", False), ("desc", False), ("desc", True)]


@pytest.mark.parametrize("kind,bf16", CASES)
def test_model_matches_the_plain_versions(octave0, kind, bf16):
    gauss, kp = octave0
    cfg = dataclasses.replace(TCFG, descr_rc_bf16=bf16)
    args, a, stack, rad, hw = _args(kind, gauss, kp, cfg)
    got, unit, _ = _model(kind, stack, a, cfg, rad, hw, bf16)
    assert 2 ** 20 < unit < 2 ** 31
    # the same bits with the samples in another order, over 5 row bands
    split = _model(kind, stack, a, cfg, rad, hw, bf16, size=5,
                   rng=np.random.default_rng(3))[0]
    assert np.array_equal(split.view(np.uint32), got.view(np.uint32))
    plain = orientation_hist_plain if kind == "ori" else descriptor_hist_plain
    want = plain(*args).numpy().reshape(got.shape)
    assert (want > 0).sum(axis=1).min() > 4
    _within(got, want)


def _board(kind, cfg, n, seed):
    """n keypoints on a checkerboard of 2 x 2 squares of 0 and 255, at
    the largest radius and (K3-desc) with a rotated square filling the
    box: (plain version's arguments, the model's fields, stack, radius,
    image size)."""
    rad = cfg.ori_patch_radius if kind == "ori" else cfg.descr_patch_radius
    h = w = 2 * rad + 24
    yy, xx = np.mgrid[0:h, 0:w]
    board = np.where((yy // 2 + xx // 2) % 2 == 0, 255.0, 0.0).astype(F32)
    gauss = torch.from_numpy(np.repeat(board[None], cfg.n_octave_layers + 2,
                                       0))
    rng = np.random.default_rng(seed)
    kp = {"layer": torch.from_numpy(rng.integers(1, 4, n).astype(np.int32)),
          "r": torch.from_numpy(rng.integers(rad + 2, h - rad - 2, n)
                                .astype(np.int32)),
          "c": torch.from_numpy(rng.integers(rad + 2, w - rad - 2, n)
                                .astype(np.int32)),
          "angle": torch.from_numpy(rng.uniform(0, 360, n).astype(F32))}
    args, a, stack, _, hw = _args(kind, gauss, dict(kp, size=torch.ones(n)),
                                  cfg)
    a["radius"][:] = rad
    args = list(args)
    args[4 if kind == "ori" else 6] = torch.from_numpy(a["radius"])
    if kind == "ori":
        sigma = cfg.ori_sig_fctr * rad / cfg.ori_radius_fctr
        a["expf"][:] = F32(-1.0 / (2.0 * sigma * sigma))
        args[5] = torch.from_numpy(a["expf"])
    else:
        width = rad / (np.sqrt(2.0) * (cfg.descr_width + 1) * 0.5)
        theta = np.deg2rad(a["ori"].astype(np.float64))
        a["cos_t"] = (np.cos(theta) / width).astype(F32)
        a["sin_t"] = (np.sin(theta) / width).astype(F32)
        args[4], args[5] = (torch.from_numpy(a["cos_t"]),
                            torch.from_numpy(a["sin_t"]))
    return args, a, stack, rad, hw


@pytest.mark.parametrize("kind,bf16", CASES)
def test_scale_does_not_overflow_on_a_checkerboard(kind, bf16):
    # every central difference is +-255, so every sample adds the
    # largest magnitude, at the largest radius
    cfg = dataclasses.replace(TCFG, descr_rc_bf16=bf16)
    args, a, stack, rad, hw = _board(kind, cfg, 6, 9)
    got, unit, peak = _model(kind, stack, a, cfg, rad, hw, bf16)
    # every sample at the largest magnitude: the units reach 2^30, under
    # the 2^31 a unit may reach, and no bin nears 2^63
    assert 2 ** 29 < unit < 2 ** 31 and 0 < peak < 2 ** 63
    plain = orientation_hist_plain if kind == "ori" else descriptor_hist_plain
    want = plain(*args).numpy().reshape(got.shape)
    assert want.max() > 1e3
    _within(got, want)


@pytest.mark.parametrize("where", ["unbinned", "binned"])
@pytest.mark.parametrize("kind,bf16", CASES)
def test_non_finite_window(kind, bf16, where):
    # chip_smoke.nonfinite_args: an infinity that only keypoint 0's box
    # sample (R, 0), left of the image, reads; a NaN at keypoint 1's
    # pixel, which 4 of its binned samples read
    cfg = dataclasses.replace(TCFG, descr_rc_bf16=bf16)
    args, a, stack, rad, (h, w) = _board(kind, cfg, 2, 4)
    a["c"][:] = 1, w - rad - 3    # shared with args' c
    lay = np.clip(a["layer"], 0, stack.shape[0] - 1)
    row, col = a["r"], a["c"]
    # window (R + 1, 0) of keypoint 0's full-radius box; keypoint 1's
    # pixel (stack and args' padded stack share their memory)
    stack[lay[0], row[0] + rad + 1, col[0]] = np.inf
    stack[lay[1], row[1] + rad + 1, col[1] + rad + 1] = np.nan
    got = _model(kind, stack, a, cfg, rad, hw=(h, w), bf16=bf16)[0]
    plain = orientation_hist_plain if kind == "ori" else descriptor_hist_plain
    want = plain(*args).numpy().reshape(got.shape)
    if where == "unbinned":
        # the scale ignores the infinity: the row is finite and within
        # tolerance, as the plain version's is
        assert np.isfinite(want[0]).all() and np.isfinite(got[0]).all()
        _within(got[:1], want[:1])
    else:
        assert np.isnan(got[1]).all() and not np.isfinite(want[1]).all()


def test_cluster_size_rule(monkeypatch):
    # 2 CTAs an SM of a 132-SM card, at most 8 a keypoint
    from sift_tpu_torch.ops import ori_hist_cuda
    monkeypatch.setattr(ori_hist_cuda, "_sm_count", lambda device: 132)
    size = [ori_hist_cuda.cluster_size(n, None)
            for n in (8192, 1024, 264, 256, 128, 64, 16, 0)]
    assert size == [1, 1, 1, 2, 3, 5, 8, 8]
