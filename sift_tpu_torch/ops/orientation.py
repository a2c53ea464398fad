"""Orientation assignment (reference C8c).

Twin of calcOrientationHist + the peak-expansion loop
(src/sift.cpp:389-458, 519-541) and of sift_tpu/ops/orientation.py:
a 36-bin gradient-orientation histogram in a radius
cvRound(4.5*scl_octv) window, Gaussian-weighted with sigma
1.5*scl_octv, circularly smoothed by (1,4,6,4,1)/16; every local max
>= 0.8*globalmax spawns an orientation with parabolic sub-bin
interpolation, at most max_ori_peaks per keypoint.

K3-ori (ops/ori_hist_cuda.py) turns each keypoint's window into its
raw 36-bin histogram, one launch per octave on the card (for all frames
of a batch); on the CPU
its plain version gathers one fixed max-radius patch per keypoint,
masks the samples outside its radius or the image interior, and
contracts one-hots (the JAX package's "onehot_t" math). Neither uses
float atomics, so results do not change from run to run. The
per-keypoint parameters are computed here, once, for both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.ops.extrema import stable_top_k
from sift_tpu_torch.ops.mathutil import cv_round
from sift_tpu_torch.ops.ori_hist_cuda import orientation_hist

_FLT_EPS = float(np.float32(1.1920929e-07))


def orientation_params(scl_octv: torch.Tensor,
                       cfg: SIFTConfig = DEFAULT_CONFIG
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-keypoint values of calcOrientationHist
    (src/sift.cpp:389-400): (N,) octave scale -> (radius int32,
    expf_scale = -1 / (2 sigma^2))."""
    radius = cv_round(cfg.ori_radius_fctr * scl_octv)
    sigma = cfg.ori_sig_fctr * scl_octv
    return radius, -1.0 / (2.0 * sigma * sigma)


def orientation_peaks(gauss: torch.Tensor,
                      layer: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                      scl_octv: torch.Tensor, valid: torch.Tensor,
                      cfg: SIFTConfig = DEFAULT_CONFIG, row_bounds=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to max_ori_peaks orientations per refined keypoint.

    gauss: (S, H, W) Gaussian stack of one octave, or (B, S, H, W) for B
    frames.
    layer/r/c/scl_octv/valid: (N,) refined keypoints (octave space), or
    (B, N).
    row_bounds: optional (lo, hi), the rows of gauss that are the true
    image's first row and one past its last (a row band of a larger
    image, parallel/spatial.py); samples outside are out-of-image
    samples (src/sift.cpp:411). Default (0, H).
    Returns (angles (N, K) degrees, peak_valid (N, K)), or (B, N, K).
    """
    n = cfg.ori_hist_bins
    rp = cfg.ori_patch_radius
    nl = cfg.n_octave_layers
    pad = rp + 1
    # refined keypoints sit on layers 1..nl (refine clamps, sift.cpp:332)
    padded = F.pad(gauss[..., 1:1 + nl, :, :], (pad, pad, pad, pad))
    radius, expf_scale = orientation_params(scl_octv, cfg)
    hist = orientation_hist(padded, layer - 1, r, c, radius, expf_scale, cfg,
                            row_bounds)

    # circular (1,4,6,4,1)/16 smoothing (src/sift.cpp:440-451)
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
