"""Gaussian blur for scale-space construction (reference C4/C5).

The reference's 2-D kernel is the analytic Gaussian truncated at
radius floor(3*sigma) and NOT renormalized (src/sift.cpp:95-108); it
factors into two 1-D truncated Gaussians, so the blur runs separably
(K1, ops/conv_cuda.py), with all scales of an octave produced from one
base (the base-relative sigma scheme, src/sift.cpp:241-258).

Boundary semantics: zero padding, with the reference's getSubMatrix
off-by-one (reads at row/col >= dim-1 yield 0, src/sift.cpp:116),
reproduced by zeroing the input's last row and column first.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from sift_tpu_torch.ops.conv_cuda import blur_vh


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Truncated, unnormalized 1-D Gaussian; float32, radius floor(3s).
    Computed exactly as sift_tpu.ops.conv.gaussian_kernel_1d."""
    w = int(math.floor(3 * sigma))
    i = np.arange(-w, w + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma)) / math.sqrt(
        2.0 * math.pi * sigma * sigma)
    return k.astype(np.float32)


def stack_kernels(sigmas: Sequence[float]) -> Tuple[np.ndarray, int]:
    """Per-sigma 1-D kernels zero-padded to a common odd width, centred:
    ((S, K) float32, K // 2). Zero taps are skipped by the blur."""
    ks = [gaussian_kernel_1d(s) for s in sigmas]
    kmax = max(k.shape[0] for k in ks)
    out = np.zeros((len(ks), kmax), np.float32)
    for i, k in enumerate(ks):
        off = (kmax - k.shape[0]) // 2
        out[i, off:off + k.shape[0]] = k
    return out, kmax // 2


def zero_last_row_col(img: torch.Tensor) -> torch.Tensor:
    """Copy of img with the last row and column zeroed (the getSubMatrix
    quirk, src/sift.cpp:116)."""
    x = img.clone()
    x[-1, :] = 0.0
    x[:, -1] = 0.0
    return x


def gaussian_blur_multi(img: torch.Tensor,
                        sigmas: Sequence[float]) -> torch.Tensor:
    """Blur one image with several sigmas at once: (H, W) -> (S, H, W).
    Twin of S calls to Gaussian_Blur (src/sift.cpp:123-153)."""
    kmat, _ = stack_kernels(sigmas)
    return blur_vh(zero_last_row_col(img.to(torch.float32)), kmat)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Single-sigma blur: (H, W) -> (H, W)."""
    return gaussian_blur_multi(img, (sigma,))[0]
