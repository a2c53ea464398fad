"""Orientation assignment (reference C8c).

Twin of calcOrientationHist + the peak-expansion loop
(src/sift.cpp:389-458, 519-541) and of sift_tpu/ops/orientation.py:
a 36-bin gradient-orientation histogram in a radius
cvRound(4.5*scl_octv) window, Gaussian-weighted with sigma
1.5*scl_octv, circularly smoothed by (1,4,6,4,1)/16; every local max
>= 0.8*globalmax spawns an orientation with parabolic sub-bin
interpolation, at most max_ori_peaks per keypoint.

Each keypoint takes one fixed max-radius patch through K3
(ops/ori_gather_cuda.py) and masks the samples outside its own radius
or the image interior. The histogram is a one-hot contraction (the
JAX package's "onehot_t" math), not a scatter: float atomics would
make GPU results change from run to run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.ops.extrema import stable_top_k
from sift_tpu_torch.ops.mathutil import fast_atan2_deg, cv_round
from sift_tpu_torch.ops.ori_gather_cuda import gather_patches

_FLT_EPS = float(np.float32(1.1920929e-07))


def hist_onehot(contrib: torch.Tensor, bins: torch.Tensor,
                n: int) -> torch.Tensor:
    """(N, P) contributions into (N, P) bin indices -> (N, n) weighted
    histograms, as one-hot (N, n, P) @ (N, P, 1)."""
    onehot = (torch.arange(n, device=bins.device)[None, :, None]
              == bins[:, None, :]).to(torch.float32)
    return torch.bmm(onehot, contrib[:, :, None])[:, :, 0]


def orientation_peaks(gauss: torch.Tensor,
                      layer: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                      scl_octv: torch.Tensor, valid: torch.Tensor,
                      cfg: SIFTConfig = DEFAULT_CONFIG
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to max_ori_peaks orientations per refined keypoint.

    gauss: (S, H, W) Gaussian stack of one octave.
    layer/r/c/scl_octv/valid: (N,) refined keypoints (octave space).
    Returns (angles (N, K) degrees, peak_valid (N, K)).
    """
    n = cfg.ori_hist_bins
    rp = cfg.ori_patch_radius
    nl = cfg.n_octave_layers
    h, w = gauss.shape[1], gauss.shape[2]
    pad = rp + 1
    # refined keypoints sit on layers 1..nl (refine clamps, sift.cpp:332)
    padded = F.pad(gauss[1:1 + nl], (pad, pad, pad, pad))
    # one max-radius patch per keypoint; pixel (r, c) lands at
    # patch[rp+1, rp+1]
    patches = gather_patches(padded, layer - 1, r, c, 2 * rp + 3)

    off = torch.arange(-rp, rp + 1, dtype=torch.int32, device=gauss.device)
    ii = off[None, :, None]                   # row offsets
    jj = off[None, None, :]                   # col offsets
    r2_grid = (ii * ii + jj * jj).to(torch.float32)

    dx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]
    dy = patches[:, :-2, 1:-1] - patches[:, 2:, 1:-1]

    scl = scl_octv[:, None, None]
    radius = cv_round(cfg.ori_radius_fctr * scl)
    sigma = cfg.ori_sig_fctr * scl
    expf_scale = -1.0 / (2.0 * sigma * sigma)

    yy = r[:, None, None] + ii
    xx = c[:, None, None] + jj
    m = ((ii.abs() <= radius) & (jj.abs() <= radius)
         & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1))
    wgt = torch.exp(r2_grid * expf_scale)
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = fast_atan2_deg(dy, dx)
    contrib = torch.where(m, wgt * mag, 0.0)

    bins = cv_round((n / 360.0) * ori)
    bins = torch.where(bins >= n, bins - n, bins)
    bins = torch.where(bins < 0, bins + n, bins)
    k = r.shape[0]
    hist = hist_onehot(contrib.reshape(k, -1), bins.reshape(k, -1), n)

    # circular (1,4,6,4,1)/16 smoothing (src/sift.cpp:440-451)
    sm = (hist.roll(2, 1) + hist.roll(-2, 1)) * (1.0 / 16.0) \
        + (hist.roll(1, 1) + hist.roll(-1, 1)) * (4.0 / 16.0) \
        + hist * (6.0 / 16.0)

    maxval = sm.max(dim=1, keepdim=True).values
    left = sm.roll(1, 1)
    right = sm.roll(-1, 1)
    peak = (sm > left) & (sm > right) & (sm >= maxval * cfg.ori_peak_ratio)
    pv, pj = stable_top_k(torch.where(peak, sm, -1.0), cfg.max_ori_peaks)
    hl = left.gather(1, pj)
    hr = right.gather(1, pj)
    hc = sm.gather(1, pj)
    bin_f = pj.to(torch.float32) + 0.5 * (hl - hr) / (hl - 2.0 * hc + hr)
    bin_f = torch.where(bin_f < 0, bin_f + n,
                        torch.where(bin_f >= n, bin_f - n, bin_f))
    angle = 360.0 - (360.0 / n) * bin_f
    angle = torch.where((angle - 360.0).abs() < _FLT_EPS, 0.0, angle)
    ok = (pv > 0) & valid[:, None]
    return angle, ok
