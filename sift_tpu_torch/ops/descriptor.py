"""128-d SIFT descriptor extraction (reference C10).

Twin of calcSIFTDescriptor/calDescriptor (src/sift.cpp:579-753) and of
sift_tpu/ops/descriptor.py (either arm of cfg.descr_rc_bf16): a rotated 4x4
spatial grid x 8 orientation bins over a radius
cvRound(3*scl*sqrt(2)*2.5) window, trilinear histogram, then the
reference's normalization chain -- L2-clip at 0.2*||v||, x512, uchar
saturate, re-multiply, L1-normalize, sqrt (src/sift.cpp:689-721).

K3-desc (ops/descr_hist_cuda.py) turns each keypoint's window into its
raw (d+2)x(d+2)x(n+2) histogram, one launch per octave on the card (for
all frames of a batch);
on the CPU its plain version contracts soft one-hots in chunks of 64
keypoints. The per-keypoint parameters are computed here, once, for
both; the circular fold and the normalization chain run on (N, 128).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.ops.descr_hist_cuda import descriptor_hist
from sift_tpu_torch.ops.mathutil import cv_round

_FLT_EPS = float(np.float32(1.1920929e-07))


class DescrParams(NamedTuple):
    """Per-keypoint descriptor parameters, (N,) each."""
    ori: torch.Tensor        # degrees, 360 snapped to 0
    radius: torch.Tensor     # int32 window radius, at most the image diagonal
    cos_t: torch.Tensor      # cos(ori) / hist_width
    sin_t: torch.Tensor      # sin(ori) / hist_width


def descriptor_params(size: torch.Tensor, angle: torch.Tensor,
                      inv_scale: torch.Tensor, hw: tuple,
                      cfg: SIFTConfig = DEFAULT_CONFIG) -> DescrParams:
    """The per-keypoint values of calcSIFTDescriptor (src/sift.cpp:579-600,
    745-751) from keypoint size and angle; inv_scale = 2**-octave."""
    d = cfg.descr_width
    h, w = hw
    diag = int(math.sqrt(float(w) * w + float(h) * h))  # src/sift.cpp:590
    scl = size * inv_scale * 0.5                      # src/sift.cpp:745-751
    ori = 360.0 - angle                               # src/sift.cpp:748-750
    ori = torch.where((ori - 360.0).abs() < _FLT_EPS, 0.0, ori)
    hist_width = cfg.descr_scl_fctr * scl
    radius = cv_round(hist_width * math.sqrt(2.0) * (d + 1) * 0.5)
    radius = torch.clamp(radius, max=diag)
    cos_t = torch.cos(ori * (math.pi / 180.0)) / hist_width
    sin_t = torch.sin(ori * (math.pi / 180.0)) / hist_width
    return DescrParams(ori, radius, cos_t, sin_t)


def normalize_hist(hist: torch.Tensor, valid: torch.Tensor,
                   cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(N, d+2, d+2, n+2) raw histograms -> (N, 128) descriptors: the
    circular orientation fold (in place, on `hist`) and the
    normalization chain; invalid rows are zero."""
    d = cfg.descr_width
    n = cfg.descr_hist_bins
    # circular orientation fold (src/sift.cpp:676-684)
    hist[:, :, :, 0] += hist[:, :, :, n]
    hist[:, :, :, 1] += hist[:, :, :, n + 1]
    dst = hist[:, 1:1 + d, 1:1 + d, :n].reshape(-1, d * d * n)

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
    return torch.where(valid[:, None], out, 0.0)


def descriptors_octave(gauss: torch.Tensor, kp: Keypoints,
                       cfg: SIFTConfig = DEFAULT_CONFIG,
                       chunk: int = 64, row_bounds=None) -> torch.Tensor:
    """Descriptors for one octave's keypoint batch: (N,) -> (N, 128) on
    an (S, H, W) stack, or (B, N) -> (B, N, 128) on B frames'
    (B, S, H, W) stack.

    kp fields are octave space (integer centre r, c; layer; size);
    invalid slots yield zero rows. row_bounds: optional (lo, hi) local
    rows of the true image, as in orientation.orientation_peaks; samples
    outside are out-of-image samples (src/sift.cpp:616).
    """
    rd = cfg.descr_patch_radius
    nl = cfg.n_octave_layers
    h, w = gauss.shape[-2:]
    pad = rd + 1
    # keypoints sit on layers 1..nl (refine clamps, sift.cpp:332);
    # invalid slots may carry layer 0, which the window start clamps
    # inside the slot's frame
    padded = F.pad(gauss[..., 1:1 + nl, :, :], (pad, pad, pad, pad))
    inv_scale = torch.exp2(-kp.octave[..., :1].to(torch.float32))
    prm = descriptor_params(kp.size, kp.angle, inv_scale, (h, w), cfg)
    hist = descriptor_hist(padded, kp.layer - 1, kp.r, kp.c, prm.cos_t,
                           prm.sin_t, prm.radius, prm.ori, kp.valid, cfg,
                           chunk, row_bounds)
    # the fold and the normalization chain are row-wise: one (B*N,) batch
    out = normalize_hist(hist.reshape(-1, *hist.shape[-3:]),
                         kp.valid.reshape(-1), cfg)
    return out.reshape(*kp.valid.shape, out.shape[-1])
