"""128-d SIFT descriptor extraction (reference C10).

Twin of calcSIFTDescriptor/calDescriptor (src/sift.cpp:579-753) and of
sift_tpu/ops/descriptor.py with descr_rc_bf16=False: a rotated 4x4
spatial grid x 8 orientation bins over a radius
cvRound(3*scl*sqrt(2)*2.5) window, trilinear histogram, then the
reference's normalization chain -- L2-clip at 0.2*||v||, x512, uchar
saturate, re-multiply, L1-normalize, sqrt (src/sift.cpp:689-721).

The per-sample scatter into the (d+2)x(d+2)x(n+2) histogram becomes a
contraction of soft one-hots in float32:

    hist[(row,col), ori] = sum_p RC[p, (row,col)] * OM[p, ori]

Keypoints are processed in chunks of 64, each gathering its (85, 85)
max-radius patches through K3 (ops/ori_gather_cuda.py), so the RC
intermediate stays at (64, 6889, 36) floats (~63 MB).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.ops.mathutil import fast_atan2_deg, cv_round
from sift_tpu_torch.ops.ori_gather_cuda import gather_patches

_FLT_EPS = float(np.float32(1.1920929e-07))


def _soft_onehot(i0: torch.Tensor, frac: torch.Tensor, width: int,
                 shift: int) -> torch.Tensor:
    """(B, P) lower bins and fractions -> (B, P, width) trilinear
    weights: (1 - frac) at bin i0 + shift, frac at i0 + shift + 1."""
    bins = torch.arange(width, device=i0.device)
    lo = (bins == (i0 + shift)[..., None]).to(torch.float32)
    hi = (bins == (i0 + shift + 1)[..., None]).to(torch.float32)
    return lo * (1.0 - frac)[..., None] + hi * frac[..., None]


def _describe(patch: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
              size0: torch.Tensor, angle0: torch.Tensor,
              valid0: torch.Tensor, inv_scale: torch.Tensor,
              hw: tuple, cfg: SIFTConfig) -> torch.Tensor:
    """Descriptors of one chunk: (B, pn, pn) patches -> (B, 128)."""
    d = cfg.descr_width
    n = cfg.descr_hist_bins
    rd = cfg.descr_patch_radius
    h, w = hw
    diag = int(math.sqrt(float(w) * w + float(h) * h))  # src/sift.cpp:590
    b = patch.shape[0]
    dev = patch.device

    off = torch.arange(-rd, rd + 1, dtype=torch.int32, device=dev)
    ii_i = off[None, :, None]
    jj_i = off[None, None, :]
    ii = ii_i.to(torch.float32)
    jj = jj_i.to(torch.float32)

    scl = size0 * inv_scale * 0.5                     # src/sift.cpp:745-751
    ori = 360.0 - angle0                              # src/sift.cpp:748-750
    ori = torch.where((ori - 360.0).abs() < _FLT_EPS, 0.0, ori)
    hist_width = cfg.descr_scl_fctr * scl
    radius = cv_round(hist_width * math.sqrt(2.0) * (d + 1) * 0.5)
    radius = torch.clamp(radius, max=diag)[:, None, None]
    cos_t = (torch.cos(ori * (math.pi / 180.0)) / hist_width)[:, None, None]
    sin_t = (torch.sin(ori * (math.pi / 180.0)) / hist_width)[:, None, None]

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

    # trilinear soft one-hots: (B, P, d+2), (B, P, d+2), (B, P, n+2)
    rw = _soft_onehot(r0i, fr, d + 2, 1)
    cw = _soft_onehot(c0i, fc, d + 2, 1)
    ow = _soft_onehot(o0i, fo, n + 2, 0) * mag[..., None]
    rc = (rw[..., :, None] * cw[..., None, :]).reshape(
        b, -1, (d + 2) * (d + 2))
    hist = torch.bmm(rc.transpose(1, 2), ow).reshape(b, d + 2, d + 2, n + 2)
    # circular orientation fold (src/sift.cpp:676-684)
    hist[:, :, :, 0] += hist[:, :, :, n]
    hist[:, :, :, 1] += hist[:, :, :, n + 1]
    dst = hist[:, 1:1 + d, 1:1 + d, :n].reshape(b, d * d * n)

    # normalization chain (src/sift.cpp:689-721)
    nrm2 = (dst * dst).sum(dim=1, keepdim=True)
    thr = torch.sqrt(nrm2) * cfg.descr_mag_thr
    dst = torch.minimum(dst, thr)
    nrm2 = (dst * dst).sum(dim=1, keepdim=True)
    nrm2 = cfg.int_descr_fctr / torch.clamp(torch.sqrt(nrm2), min=_FLT_EPS)
    q = torch.clamp(torch.round(dst * nrm2), 0.0, 255.0)
    q = q * nrm2
    nrm1 = 1.0 / torch.clamp(q.sum(dim=1, keepdim=True), min=_FLT_EPS)
    out = torch.sqrt(q * nrm1)
    return torch.where(valid0[:, None], out, 0.0)


def descriptors_octave(gauss: torch.Tensor, kp: Keypoints,
                       cfg: SIFTConfig = DEFAULT_CONFIG,
                       chunk: int = 64) -> torch.Tensor:
    """Descriptors for one octave's keypoint batch: (N,) -> (N, 128).

    kp fields are octave space (integer centre r, c; layer; size);
    invalid slots yield zero rows.
    """
    rd = cfg.descr_patch_radius
    nl = cfg.n_octave_layers
    _, h, w = gauss.shape
    pad = rd + 1
    # keypoints sit on layers 1..nl (refine clamps, sift.cpp:332);
    # invalid slots may carry layer 0, which the gather clamps
    padded = F.pad(gauss[1:1 + nl], (pad, pad, pad, pad))
    pn = 2 * rd + 3
    inv_scale = torch.exp2(-kp.octave[:1].to(torch.float32))
    cap = kp.capacity
    parts = []
    for s in range(0, cap, chunk):
        e = min(s + chunk, cap)
        patch = gather_patches(padded, kp.layer[s:e] - 1, kp.r[s:e],
                               kp.c[s:e], pn)
        parts.append(_describe(patch, kp.r[s:e], kp.c[s:e], kp.size[s:e],
                               kp.angle[s:e], kp.valid[s:e], inv_scale,
                               (h, w), cfg))
    return torch.cat(parts)
