"""Plain PyTorch SIFT: the benchmark's reference for detection and
description, on whatever device its inputs live.

A frozen copy, made at commit e1604af, of the plain versions that stand
beside each kernel of the port, and of the facade that chains them:
  sift_tpu_torch/config.py          SIFTConfig (as RefConfig)
  sift_tpu_torch/ops/mathutil.py    fast_atan2_deg, cv_round
  sift_tpu_torch/ops/conv.py        kernels, quirk; conv_cuda.py _plain
  sift_tpu_torch/ops/pyramid.py     the batched pyramids
  sift_tpu_torch/ops/extrema.py     top_candidates_batch_plain, _decode;
                                    extrema_cuda.py extrema_mask
  sift_tpu_torch/ops/refine.py      refine_candidates
  sift_tpu_torch/ops/orientation.py orientation_peaks; ori_hist_cuda.py
                                    orientation_hist_plain
  sift_tpu_torch/ops/descriptor.py  descriptors_octave; descr_hist_cuda.py
                                    descriptor_hist_plain
  sift_tpu_torch/ops/match.py       match_ratio; match_cuda.py
                                    knn2_l1_plain
  sift_tpu_torch/sift.py            detect_and_compute_batch, _octave_tail
The argument checks, the kernels and the row-band options are left out.
It imports nothing of the port, so a later change to the port leaves
this copy, and what the benchmark holds the port to, as it is. B frames
run as one batch, a single frame as a batch of one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_FLT_EPS = float(np.float32(1.1920929e-07))
_DBL_EPS = 2.220446049250313e-16
_P1 = 0.9997878412794807 * (180.0 / math.pi)
_P3 = -0.3258083974640975 * (180.0 / math.pi)
_P5 = 0.1555786518463281 * (180.0 / math.pi)
_P7 = -0.04432655554792128 * (180.0 / math.pi)


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The SIFT parameter block (src/sift.cpp:3-47) and the static caps."""
    n_octaves: int = 5
    n_octave_layers: int = 2
    sigma: float = 1.6
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    init_sigma_assumed: float = 0.2
    descr_width: int = 4
    descr_hist_bins: int = 8
    img_border: int = 5
    max_interp_steps: int = 5
    ori_hist_bins: int = 36
    ori_sig_fctr: float = 1.5
    ori_radius_fctr: float = 4.5
    ori_peak_ratio: float = 0.8
    descr_scl_fctr: float = 3.0
    descr_mag_thr: float = 0.2
    int_descr_fctr: float = 512.0
    nms_threshold: float = 8.0
    detect_caps: Tuple[int, ...] = (4096, 2048, 512, 256, 128)
    out_caps: Tuple[int, ...] = (1024, 256, 128, 64, 64)
    max_ori_peaks: int = 4
    max_keypoints: int = 4096
    match_ratio: float = 0.86
    descr_rc_bf16: bool = False

    @property
    def n_scales(self) -> int:
        return self.n_octave_layers + 3

    @property
    def descr_size(self) -> int:
        return self.descr_width * self.descr_width * self.descr_hist_bins

    @property
    def init_blur_sigma(self) -> float:
        return math.sqrt(self.sigma * self.sigma
                         + self.init_sigma_assumed * self.init_sigma_assumed)

    def scale_sigmas(self) -> Tuple[float, ...]:
        k = 2.0 ** (1.0 / self.n_octave_layers)
        sigs = [self.sigma]
        for i in range(1, self.n_scales):
            total = (k ** i) * self.sigma
            sigs.append(math.sqrt(total * total - self.sigma * self.sigma))
        return tuple(sigs)

    @property
    def max_scl_octv(self) -> float:
        return self.sigma * 2.0 ** (
            (self.n_octave_layers + 0.5) / self.n_octave_layers)

    @property
    def ori_patch_radius(self) -> int:
        return int(math.ceil(self.ori_radius_fctr * self.max_scl_octv))

    @property
    def descr_patch_radius(self) -> int:
        hw = self.descr_scl_fctr * self.max_scl_octv
        return int(math.ceil(hw * math.sqrt(2.0) * (self.descr_width + 1)
                             * 0.5))


def ref_config(params: Dict) -> RefConfig:
    """RefConfig from a configuration file's "sift" block."""
    kw = dict(params)
    for k in ("detect_caps", "out_caps"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return RefConfig(**kw)


# ----------------------------------------------------------- math


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ax, ay = x.abs(), y.abs()
    swap = ax < ay
    c = torch.where(swap, ax / (ay + _DBL_EPS), ay / (ax + _DBL_EPS))
    c2 = c * c
    a = (((_P7 * c2 + _P5) * c2 + _P3) * c2 + _P1) * c
    a = torch.where(swap, 90.0 - a, a)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


def cv_round(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).to(torch.int32)


def stable_top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ----------------------------------------------------------- keypoints

class Kp(NamedTuple):
    """Keypoint slots: (B, N) fields."""
    x: torch.Tensor
    y: torch.Tensor
    size: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    layer: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor
    valid: torch.Tensor

    def gather(self, idx: torch.Tensor) -> "Kp":
        return Kp(*(a.gather(-1, idx) for a in self))

    @staticmethod
    def zeros(shape, device) -> "Kp":
        f = torch.zeros(shape, dtype=torch.float32, device=device)
        i = torch.zeros(shape, dtype=torch.int32, device=device)
        return Kp(f, f, f, f, f, i, i, i, i,
                  torch.zeros(shape, dtype=torch.bool, device=device))

    @staticmethod
    def concatenate(parts: Sequence["Kp"]) -> "Kp":
        return Kp(*(torch.cat(a, dim=-1) for a in zip(*parts)))


# ----------------------------------------------------------- pyramid


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    w = int(math.floor(3 * sigma))
    i = np.arange(-w, w + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma)) / math.sqrt(
        2.0 * math.pi * sigma * sigma)
    return k.astype(np.float32)


def stack_kernels(sigmas: Sequence[float]) -> np.ndarray:
    ks = [gaussian_kernel_1d(s) for s in sigmas]
    kmax = max(k.shape[0] for k in ks)
    out = np.zeros((len(ks), kmax), np.float32)
    for i, k in enumerate(ks):
        off = (kmax - k.shape[0]) // 2
        out[i, off:off + k.shape[0]] = k
    return out


def zero_last_row_col(img: torch.Tensor) -> torch.Tensor:
    x = img.clone()
    x[..., -1, :] = 0.0
    x[..., :, -1] = 0.0
    return x


def _pass_plain(x: torch.Tensor, kmat: np.ndarray, dim: int) -> torch.Tensor:
    s, k = kmat.shape
    w = k // 2
    n = x.shape[dim]
    pad = (0, 0, w, w) if dim == 2 else (w, w, 0, 0)
    p = F.pad(x, pad)
    out = []
    for si in range(s):
        src = p[:, 0 if p.shape[1] == 1 else si]
        acc = None
        for di in range(k):
            t = float(kmat[si, di])
            if t == 0.0:
                continue
            term = src.narrow(dim - 1, di, n) * t
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out, dim=1)


def blur_batch(imgs: torch.Tensor, sigmas: Sequence[float]) -> torch.Tensor:
    """(B, H, W) -> (B, S, H, W), the quirk applied first."""
    kmat = stack_kernels(sigmas)
    x = zero_last_row_col(imgs.to(torch.float32))
    return _pass_plain(_pass_plain(x[:, None], kmat, 2), kmat, 3)


def gaussian_pyramid(imgs: torch.Tensor, cfg: RefConfig) -> List[torch.Tensor]:
    sig = cfg.scale_sigmas()
    base = blur_batch(imgs.to(torch.float32), (cfg.init_blur_sigma,))[:, 0]
    octaves: List[torch.Tensor] = []
    for o in range(cfg.n_octaves):
        if o > 0:
            prev = octaves[o - 1][:, cfg.n_octave_layers]
            h2, w2 = prev.shape[-2] // 2, prev.shape[-1] // 2
            base = prev[..., 0:2 * h2:2, 0:2 * w2:2]
        layers = blur_batch(base, sig[1:])
        octaves.append(torch.cat([base[:, None], layers], dim=1))
    return octaves


# ----------------------------------------------------------- extrema


def extrema_mask(dog: torch.Tensor, cfg: RefConfig) -> torch.Tensor:
    nl = cfg.n_octave_layers
    h, w = dog.shape[-2:]
    val = dog[..., 1:1 + nl, :, :]
    p = F.pad(dog, (1, 1, 1, 1))
    nmax = torch.full_like(val, float("-inf"))
    nmin = torch.full_like(val, float("inf"))
    for dl in (-1, 0, 1):
        for dr in (0, 1, 2):
            for dc in (0, 1, 2):
                if dl == 0 and dr == 1 and dc == 1:
                    continue
                s = p[..., 1 + dl:1 + dl + nl, dr:dr + h, dc:dc + w]
                nmax = torch.maximum(nmax, s)
                nmin = torch.minimum(nmin, s)
    mask = (val.abs() > cfg.nms_threshold) & (
        ((val > 0) & (val >= nmax)) | ((val < 0) & (val <= nmin)))
    b = cfg.img_border
    rr = torch.arange(h, device=dog.device)
    cc = torch.arange(w, device=dog.device)
    inside = ((rr >= b) & (rr < h - b))[:, None] & (
        (cc >= b) & (cc < w - b))[None, :]
    return mask & inside


def top_candidates(dog: torch.Tensor, cap: int, cfg: RefConfig):
    """(B, D, H, W) -> (layer 1..nL, r, c, valid), each (B, cap): the
    first `cap` slots of a stable descending sort of the masked scores."""
    nl = cfg.n_octave_layers
    val = dog[:, 1:1 + nl]
    score = torch.where(extrema_mask(dog, cfg), val.abs(),
                        torch.full_like(val, -1.0)).reshape(dog.shape[0], -1)
    k = min(cap, score.shape[-1])
    vals, idx = stable_top_k(score, k)
    if k < cap:
        vals = F.pad(vals, (0, cap - k), value=-1.0)
        idx = F.pad(idx, (0, cap - k))
    h, w = dog.shape[-2:]
    rem = idx % (h * w)
    return ((idx // (h * w) + 1).to(torch.int32),
            (rem // w).to(torch.int32), (rem % w).to(torch.int32), vals > 0.0)


# ----------------------------------------------------------- refine

_IMG_SCALE = 1.0 / 255.0
_DERIV_SCALE = _IMG_SCALE * 0.5
_SECOND_DERIV_SCALE = _IMG_SCALE
_CROSS_DERIV_SCALE = _IMG_SCALE * 0.25
_DIVERGE_LIMIT = float(2 ** 31) / 3.0


class Refined(NamedTuple):
    layer: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor
    xi: torch.Tensor
    xr: torch.Tensor
    xc: torch.Tensor
    contr: torch.Tensor
    valid: torch.Tensor


def _solve3x3(h00, h01, h02, h11, h12, h22, b0, b1, b2):
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    det = h00 * c00 + h01 * c01 + h02 * c02
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    safe = det.abs() > 1e-30
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return x0, x1, x2


def _derivative_fields(dog: torch.Tensor, nl: int):
    h, w = dog.shape[-2:]
    p = F.pad(dog, (1, 1, 1, 1, 1, 1))

    def val(dl, dr, dc):
        return p[..., 2 + dl:2 + dl + nl, 1 + dr:1 + dr + h,
                 1 + dc:1 + dc + w]

    v2 = dog[..., 1:1 + nl, :, :] * 2.0
    d0 = (val(0, 0, 1) - val(0, 0, -1)) * _DERIV_SCALE
    d1 = (val(0, 1, 0) - val(0, -1, 0)) * _DERIV_SCALE
    d2 = (val(1, 0, 0) - val(-1, 0, 0)) * _DERIV_SCALE
    dxx = (val(0, 0, 1) + val(0, 0, -1) - v2) * _SECOND_DERIV_SCALE
    dyy = (val(0, 1, 0) + val(0, -1, 0) - v2) * _SECOND_DERIV_SCALE
    dss = (val(1, 0, 0) + val(-1, 0, 0) - v2) * _SECOND_DERIV_SCALE
    dxy = (val(0, 1, 1) - val(0, 1, -1) - val(0, -1, 1)
           + val(0, -1, -1)) * _CROSS_DERIV_SCALE
    dxs = (val(1, 0, 1) - val(1, 0, -1) - val(-1, 0, 1)
           + val(-1, 0, -1)) * _CROSS_DERIV_SCALE
    dys = (val(1, 1, 0) - val(1, -1, 0) - val(-1, 1, 0)
           + val(-1, -1, 0)) * _CROSS_DERIV_SCALE
    return tuple(x.reshape(-1)
                 for x in (d0, d1, d2, dxx, dxy, dxs, dyy, dys, dss,
                           dog[..., 1:1 + nl, :, :]))


def refine_candidates(dog, layer, r, c, valid, cfg: RefConfig) -> Refined:
    """(B, D, H, W) DoG with (B, N) candidates -> Refined, (B, N) each."""
    h, w = dog.shape[-2:]
    nl = cfg.n_octave_layers
    border = cfg.img_border
    fields = _derivative_fields(dog, nl)
    frame0 = (torch.arange(layer.shape[0], device=dog.device)[:, None]
              * (nl * h * w))

    def fetch(lay, rr, cc):
        idx = (((lay - 1) * h + rr) * w + cc).long() + frame0
        return tuple(f[idx] for f in fields)

    lay, rr, cc = layer, r, c
    xi = torch.zeros(layer.shape, dtype=torch.float32, device=dog.device)
    xr, xc = xi, xi
    converged = torch.zeros_like(valid)
    alive = valid
    for _ in range(cfg.max_interp_steps):
        active = alive & ~converged
        (d0, d1, d2, dxx, dxy, dxs, dyy, dys, dss, _c) = fetch(lay, rr, cc)
        x0, x1, x2 = _solve3x3(dxx, dxy, dxs, dyy, dys, dss, d0, d1, d2)
        nxi, nxr, nxc = -x2, -x1, -x0
        finite = nxi.isfinite() & nxr.isfinite() & nxc.isfinite()
        conv_now = ((nxi.abs() < 0.5) & (nxr.abs() < 0.5)
                    & (nxc.abs() < 0.5) & finite)
        diverged = ~finite | (nxi.abs() > _DIVERGE_LIMIT) | \
            (nxr.abs() > _DIVERGE_LIMIT) | (nxc.abs() > _DIVERGE_LIMIT)
        xi = torch.where(active, nxi, xi)
        xr = torch.where(active, nxr, xr)
        xc = torch.where(active, nxc, xc)
        move = active & ~conv_now & ~diverged
        zero = torch.zeros_like(lay)
        nlay = lay + torch.where(move, cv_round(nxi), zero)
        nr = rr + torch.where(move, cv_round(nxr), zero)
        nc = cc + torch.where(move, cv_round(nxc), zero)
        oob = ((nlay < 1) | (nlay > nl) | (nc < border) | (nc >= w - border)
               | (nr < border) | (nr >= h - border))
        alive = alive & ~(active & (diverged | (move & oob)))
        converged = converged | (active & conv_now)
        step = move & ~oob
        lay = torch.where(step, nlay, lay)
        rr = torch.where(step, nr, rr)
        cc = torch.where(step, nc, cc)
    alive = alive & converged
    (d0, d1, d2, dxx, dxy, _dxs, dyy, _dys, _dss, center) = fetch(lay, rr, cc)
    t = d0 * xc + d1 * xr + d2 * xi
    contr = center * _IMG_SCALE + t * 0.5
    alive = alive & (contr.abs() * nl >= cfg.contrast_threshold)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    e = cfg.edge_threshold
    alive = alive & (det > 0) & (tr * tr * e < (e + 1) * (e + 1) * det)
    return Refined(lay, rr, cc, xi, xr, xc, contr, alive)


# ----------------------------------------------------------- histograms


def _gather_patches(stack, layer, r, c, patch: int) -> torch.Tensor:
    nlay, hp, wp = stack.shape
    lay = layer.long().clamp(0, nlay - 1)
    rs = r.long().clamp(0, hp - patch)
    cs = c.long().clamp(0, wp - patch)
    off = torch.arange(patch, device=stack.device)
    rows = (rs[:, None] + off)[:, :, None]
    cols = (cs[:, None] + off)[:, None, :]
    return stack[lay[:, None, None], rows, cols]


def _ori_hist_frame(stack, layer, r, c, radius, expf_scale, cfg: RefConfig):
    n = cfg.ori_hist_bins
    rp = cfg.ori_patch_radius
    h, w = (s - 2 * (rp + 1) for s in stack.shape[1:])
    patches = _gather_patches(stack, layer, r, c, 2 * rp + 3)
    off = torch.arange(-rp, rp + 1, dtype=torch.int32, device=stack.device)
    ii = off[None, :, None]
    jj = off[None, None, :]
    r2_grid = (ii * ii + jj * jj).to(torch.float32)
    dx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]
    dy = patches[:, :-2, 1:-1] - patches[:, 2:, 1:-1]
    rad = radius[:, None, None]
    yy = r[:, None, None] + ii
    xx = c[:, None, None] + jj
    m = ((ii.abs() <= rad) & (jj.abs() <= rad)
         & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1))
    wgt = torch.exp(r2_grid * expf_scale[:, None, None])
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = fast_atan2_deg(dy, dx)
    contrib = torch.where(m, wgt * mag, 0.0)
    bins = cv_round((n / 360.0) * ori)
    bins = torch.where(bins >= n, bins - n, bins)
    bins = torch.where(bins < 0, bins + n, bins)
    k = r.shape[0]
    contrib = contrib.reshape(k, -1)
    bins = bins.reshape(k, -1)
    onehot = (torch.arange(n, device=bins.device)[None, :, None]
              == bins[:, None, :]).to(torch.float32)
    return torch.bmm(onehot, contrib[:, :, None])[:, :, 0]


def orientation_peaks(gauss, layer, r, c, scl_octv, valid, cfg: RefConfig):
    """(B, S, H, W) stack, (B, N) keypoints -> (angles, ok), (B, N, K)."""
    n = cfg.ori_hist_bins
    nl = cfg.n_octave_layers
    pad = cfg.ori_patch_radius + 1
    padded = F.pad(gauss[:, 1:1 + nl], (pad, pad, pad, pad))
    radius = cv_round(cfg.ori_radius_fctr * scl_octv)
    sigma = cfg.ori_sig_fctr * scl_octv
    expf_scale = -1.0 / (2.0 * sigma * sigma)
    nb, nlay = padded.shape[:2]
    stack = padded.reshape(nb * nlay, *padded.shape[2:])
    hist = torch.stack([
        _ori_hist_frame(stack, (layer[b] - 1).clamp(0, nlay - 1) + b * nlay,
                        r[b], c[b], radius[b], expf_scale[b], cfg)
        for b in range(nb)])
    sm = (hist.roll(2, -1) + hist.roll(-2, -1)) * (1.0 / 16.0) \
        + (hist.roll(1, -1) + hist.roll(-1, -1)) * (4.0 / 16.0) \
        + hist * (6.0 / 16.0)
    maxval = sm.max(dim=-1, keepdim=True).values
    left = sm.roll(1, -1)
    right = sm.roll(-1, -1)
    peak = (sm > left) & (sm > right) & (sm >= maxval * cfg.ori_peak_ratio)
    pv, pj = stable_top_k(torch.where(peak, sm, -1.0), cfg.max_ori_peaks)
    hl = left.gather(-1, pj)
    hr = right.gather(-1, pj)
    hc = sm.gather(-1, pj)
    bin_f = pj.to(torch.float32) + 0.5 * (hl - hr) / (hl - 2.0 * hc + hr)
    bin_f = torch.where(bin_f < 0, bin_f + n,
                        torch.where(bin_f >= n, bin_f - n, bin_f))
    angle = 360.0 - (360.0 / n) * bin_f
    angle = torch.where((angle - 360.0).abs() < _FLT_EPS, 0.0, angle)
    ok = (pv > 0) & valid[..., None]
    return angle, ok


def _soft_onehot(i0, frac, width: int, shift: int) -> torch.Tensor:
    bins = torch.arange(width, device=i0.device)
    lo = (bins == (i0 + shift)[..., None]).to(torch.float32)
    hi = (bins == (i0 + shift + 1)[..., None]).to(torch.float32)
    return lo * (1.0 - frac)[..., None] + hi * frac[..., None]


def _descr_hist_chunk(patch, r0, c0, cos_t, sin_t, radius, ori, hw,
                      cfg: RefConfig) -> torch.Tensor:
    d = cfg.descr_width
    n = cfg.descr_hist_bins
    rd = cfg.descr_patch_radius
    h, w = hw
    b = patch.shape[0]
    off = torch.arange(-rd, rd + 1, dtype=torch.int32, device=patch.device)
    ii_i = off[None, :, None]
    jj_i = off[None, None, :]
    ii = ii_i.to(torch.float32)
    jj = jj_i.to(torch.float32)
    cos_t = cos_t[:, None, None]
    sin_t = sin_t[:, None, None]
    radius = radius[:, None, None]
    dx = patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]
    dy = patch[:, :-2, 1:-1] - patch[:, 2:, 1:-1]
    c_rot = jj * cos_t - ii * sin_t
    r_rot = jj * sin_t + ii * cos_t
    rbin = r_rot + (d / 2 - 0.5)
    cbin = c_rot + (d / 2 - 0.5)
    rr = r0[:, None, None] + ii_i
    cc = c0[:, None, None] + jj_i
    m = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
         & (rr > 0) & (rr < h - 1) & (cc > 0) & (cc < w - 1)
         & (ii_i.abs() <= radius) & (jj_i.abs() <= radius))
    wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
    mag_g = torch.sqrt(dx * dx + dy * dy)
    theta = fast_atan2_deg(dy, dx)
    obin = (theta - ori[:, None, None]) * (n / 360.0)
    mag = torch.where(m, mag_g * wgt, 0.0).reshape(b, -1)
    rbin = rbin.reshape(b, -1)
    cbin = cbin.reshape(b, -1)
    obin = obin.reshape(b, -1)
    r0i = torch.floor(rbin)
    c0i = torch.floor(cbin)
    o0i = torch.floor(obin)
    fr = rbin - r0i
    fc = cbin - c0i
    fo = obin - o0i
    r0i = r0i.to(torch.int32)
    c0i = c0i.to(torch.int32)
    o0i = o0i.to(torch.int32)
    o0i = torch.where(o0i < 0, o0i + n, o0i)
    o0i = torch.where(o0i >= n, o0i - n, o0i)
    rw = _soft_onehot(r0i, fr, d + 2, 1)
    cw = _soft_onehot(c0i, fc, d + 2, 1)
    ow = _soft_onehot(o0i, fo, n + 2, 0) * mag[..., None]
    rc = (rw[..., :, None] * cw[..., None, :]).reshape(
        b, -1, (d + 2) * (d + 2))
    if cfg.descr_rc_bf16:
        rc = rc.to(torch.bfloat16).to(torch.float32)
        ow = ow.to(torch.bfloat16).to(torch.float32)
    return torch.bmm(rc.transpose(1, 2), ow).reshape(b, d + 2, d + 2, n + 2)


def descriptors_octave(gauss: torch.Tensor, kp: Kp, cfg: RefConfig,
                       chunk: int = 64) -> torch.Tensor:
    """(B, S, H, W) stack, (B, N) keypoints -> (B, N, 128)."""
    d = cfg.descr_width
    n = cfg.descr_hist_bins
    rd = cfg.descr_patch_radius
    nl = cfg.n_octave_layers
    h, w = gauss.shape[-2:]
    pad = rd + 1
    padded = F.pad(gauss[:, 1:1 + nl], (pad, pad, pad, pad))
    inv_scale = torch.exp2(-kp.octave[..., :1].to(torch.float32))
    diag = int(math.sqrt(float(w) * w + float(h) * h))
    scl = kp.size * inv_scale * 0.5
    ori = 360.0 - kp.angle
    ori = torch.where((ori - 360.0).abs() < _FLT_EPS, 0.0, ori)
    hist_width = cfg.descr_scl_fctr * scl
    radius = cv_round(hist_width * math.sqrt(2.0) * (d + 1) * 0.5)
    radius = torch.clamp(radius, max=diag)
    cos_t = torch.cos(ori * (math.pi / 180.0)) / hist_width
    sin_t = torch.sin(ori * (math.pi / 180.0)) / hist_width

    nb, nlay = padded.shape[:2]
    stack = padded.reshape(nb * nlay, *padded.shape[2:])
    hist = torch.zeros((*kp.valid.shape, d + 2, d + 2, n + 2),
                       dtype=torch.float32, device=gauss.device)
    pn = 2 * rd + 3
    for b in range(nb):
        lay = (kp.layer[b] - 1).clamp(0, nlay - 1) + b * nlay
        rows = kp.valid[b].nonzero()[:, 0]
        for s in range(0, rows.shape[0], chunk):
            i = rows[s:s + chunk]
            patch = _gather_patches(stack, lay[i], kp.r[b][i], kp.c[b][i], pn)
            hist[b, i] = _descr_hist_chunk(
                patch, kp.r[b][i], kp.c[b][i], cos_t[b][i], sin_t[b][i],
                radius[b][i], ori[b][i], (h, w), cfg)
    hist = hist.reshape(-1, d + 2, d + 2, n + 2)
    valid = kp.valid.reshape(-1)
    hist[:, :, :, 0] += hist[:, :, :, n]
    hist[:, :, :, 1] += hist[:, :, :, n + 1]
    dst = hist[:, 1:1 + d, 1:1 + d, :n].reshape(-1, d * d * n)
    nrm2 = (dst * dst).sum(dim=1, keepdim=True)
    thr = torch.sqrt(nrm2) * cfg.descr_mag_thr
    dst = torch.minimum(dst, thr)
    nrm2 = (dst * dst).sum(dim=1, keepdim=True)
    nrm2 = cfg.int_descr_fctr / torch.clamp(torch.sqrt(nrm2), min=_FLT_EPS)
    q = torch.clamp(torch.round(dst * nrm2), 0.0, 255.0)
    q = q * nrm2
    nrm1 = 1.0 / torch.clamp(q.sum(dim=1, keepdim=True), min=_FLT_EPS)
    out = torch.where(valid[:, None], torch.sqrt(q * nrm1), 0.0)
    return out.reshape(*kp.valid.shape, out.shape[-1])


# ----------------------------------------------------------- facade


def _octave_tail(gauss, dog, layer0, r0, c0, valid0, octave: int,
                 cfg: RefConfig, out_cap: int) -> Kp:
    rf = refine_candidates(dog, layer0, r0, c0, valid0, cfg)
    cap = layer0.shape[-1]
    if out_cap < cap:
        mscore = torch.where(rf.valid, rf.contr.abs() + 10.0, -1.0)
        _, midx = stable_top_k(mscore, out_cap)
        rf = Refined(*(a.gather(-1, midx) for a in rf))
    nl = cfg.n_octave_layers
    lay_f = rf.layer.to(torch.float32)
    scl_octv = cfg.sigma * torch.exp2((lay_f + rf.xi) / nl)
    size = scl_octv * (1 << octave) * 2.0
    angles, ok = orientation_peaks(gauss, rf.layer, rf.r, rf.c, scl_octv,
                                   rf.valid, cfg)
    k = cfg.max_ori_peaks
    scale = float(1 << octave)

    def tile(a):
        return a.repeat_interleave(k, dim=-1)

    kp = Kp(x=tile((rf.c.to(torch.float32) + rf.xc) * scale),
            y=tile((rf.r.to(torch.float32) + rf.xr) * scale),
            size=tile(size), angle=angles.flatten(-2),
            response=tile(rf.contr.abs()),
            octave=torch.full(ok.flatten(-2).shape, octave, dtype=torch.int32,
                              device=dog.device),
            layer=tile(rf.layer), r=tile(rf.r), c=tile(rf.c),
            valid=ok.flatten(-2))
    score = torch.where(kp.valid, kp.response + 10.0, -1.0)
    _, idx = stable_top_k(score, out_cap)
    return kp.gather(idx)


def _octave_usable(shape, cfg: RefConfig) -> bool:
    return min(shape) >= max(2 * cfg.img_border + 3, 8)


def detect_and_compute(imgs: torch.Tensor, cfg: RefConfig
                       ) -> Tuple[Kp, torch.Tensor]:
    """(B, H, W) frames -> (Kp with (B, N) fields, (B, N, 128))."""
    nb = imgs.shape[0]
    octs = gaussian_pyramid(imgs, cfg)
    dogs = [o[:, 1:] - o[:, :-1] for o in octs]
    kp_parts, d_parts = [], []
    for o in range(cfg.n_octaves):
        out_cap = cfg.out_caps[o]
        if _octave_usable(octs[o].shape[2:], cfg):
            cands = top_candidates(dogs[o], cfg.detect_caps[o], cfg)
            kp = _octave_tail(octs[o], dogs[o], *cands, o, cfg, out_cap)
            d = descriptors_octave(octs[o], kp, cfg)
        else:
            kp = Kp.zeros((nb, out_cap), imgs.device)
            d = torch.zeros((nb, out_cap, cfg.descr_size),
                            dtype=torch.float32, device=imgs.device)
        kp_parts.append(kp)
        d_parts.append(d)
    return Kp.concatenate(kp_parts), torch.cat(d_parts, dim=1)


# ----------------------------------------------------------- match

_INF = 3.0e38
_SENTINEL = 1.0e6
_QUERY_CHUNK = 256


def knn2_l1(query: torch.Tensor, train: torch.Tensor):
    """(N, D) x (M, D) -> (idx int32, d1, d2), each (N,); the lowest
    train index wins equal distances."""
    n, d = query.shape
    m = train.shape[0]
    idx = torch.zeros((n,), dtype=torch.int32, device=query.device)
    d1 = torch.full((n,), _INF, dtype=torch.float32, device=query.device)
    d2 = torch.full((n,), _INF, dtype=torch.float32, device=query.device)
    cols = torch.arange(m, device=query.device)
    for s in range(0, n, _QUERY_CHUNK):
        q = query[s:s + _QUERY_CHUNK]
        dist = torch.zeros((q.shape[0], m), dtype=torch.float32,
                           device=query.device)
        for k in range(d):
            dist = dist + (q[:, k, None] - train[None, :, k]).abs()
        m1 = dist.min(dim=1).values
        a1 = torch.where(dist == m1[:, None], cols, m).min(dim=1).values
        idx[s:s + _QUERY_CHUNK] = a1.to(torch.int32)
        d1[s:s + _QUERY_CHUNK] = m1
        d2[s:s + _QUERY_CHUNK] = torch.where(
            cols == a1[:, None], _INF, dist).min(dim=1).values
    return idx, d1, d2


def match_ratio(query, train, q_valid, t_valid, ratio: float):
    """Lowe's ratio test over BFMatcher(NORM_L1) k = 2 of one pair:
    (train index (N,) int32, good (N,) bool, best distance (N,))."""
    t = torch.where(t_valid[..., None], train.to(torch.float32), _SENTINEL)
    idx, d1, d2 = knn2_l1(query.to(torch.float32), t)
    good = (d1 <= ratio * d2) & (d1 < _SENTINEL) & (d2 < _SENTINEL) & q_valid
    return idx, good, d1
