"""K3-ori wrapper: per-keypoint 36-bin orientation histograms, the patch
gather fused with the histogram that consumes it.

Counterpart of sift_tpu/ops/ori_gather_pallas.py (gather_patches) plus
the one-hot contraction of sift_tpu/ops/orientation.py (_hist_bins,
"onehot_t"). `orientation_hist` launches the CUDA kernel
(csrc/ori_hist.cu) for a CUDA tensor and runs `orientation_hist_plain`
for a CPU tensor. Both return `hist` of calcOrientationHist
(src/sift.cpp:389-458) before smoothing, with the per-sample arithmetic
of the plain version; they differ only in the order of the sums.
"""

from __future__ import annotations

import torch

from sift_tpu_torch import _build
from sift_tpu_torch.config import SIFTConfig
from sift_tpu_torch.ops.mathutil import fast_atan2_deg, cv_round
from sift_tpu_torch.ops.ori_gather_cuda import gather_patches_plain

_KERNEL_BINS = 36     # csrc/ori_hist.cu: kBins


def _check_args(padded, layer, r, c, radius, expf_scale,
                cfg: SIFTConfig) -> None:
    rp = cfg.ori_patch_radius
    if padded.dtype != torch.float32 or padded.dim() != 3:
        raise ValueError(f"orientation source must be (L, Hp, Wp) float32, "
                         f"got {tuple(padded.shape)} {padded.dtype}")
    if min(padded.shape[1:]) < 2 * rp + 3:
        raise ValueError(f"source {tuple(padded.shape)} is not padded by "
                         f"{rp + 1}")
    if not (layer.shape == r.shape == c.shape == radius.shape
            == expf_scale.shape) or layer.dim() != 1:
        raise ValueError("keypoint arguments must be (N,) tensors of one "
                         "shape")


def hist_onehot(contrib: torch.Tensor, bins: torch.Tensor,
                n: int) -> torch.Tensor:
    """(N, P) contributions into (N, P) bin indices -> (N, n) weighted
    histograms, as one-hot (N, n, P) @ (N, P, 1)."""
    onehot = (torch.arange(n, device=bins.device)[None, :, None]
              == bins[:, None, :]).to(torch.float32)
    return torch.bmm(onehot, contrib[:, :, None])[:, :, 0]


def orientation_hist_plain(padded: torch.Tensor, layer: torch.Tensor,
                           r: torch.Tensor, c: torch.Tensor,
                           radius: torch.Tensor, expf_scale: torch.Tensor,
                           cfg: SIFTConfig) -> torch.Tensor:
    """Plain PyTorch K3-ori: one max-radius patch per keypoint, masked to
    its radius and the image interior, then a one-hot contraction.

    padded: (L, Hp, Wp), the octave's layers padded by
    ori_patch_radius + 1; layer: (N,) index into it; r, c: (N,) octave
    pixel; radius (int32), expf_scale: (N,) from
    orientation.orientation_params. Returns (N, ori_hist_bins).
    """
    _check_args(padded, layer, r, c, radius, expf_scale, cfg)
    n = cfg.ori_hist_bins
    rp = cfg.ori_patch_radius
    h, w = (s - 2 * (rp + 1) for s in padded.shape[1:])
    # pixel (r, c) lands at patch[rp+1, rp+1]
    patches = gather_patches_plain(padded, layer, r, c, 2 * rp + 3)

    off = torch.arange(-rp, rp + 1, dtype=torch.int32, device=padded.device)
    ii = off[None, :, None]                   # row offsets
    jj = off[None, None, :]                   # col offsets
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
    return hist_onehot(contrib.reshape(k, -1), bins.reshape(k, -1), n)


def orientation_hist(padded: torch.Tensor, layer: torch.Tensor,
                     r: torch.Tensor, c: torch.Tensor, radius: torch.Tensor,
                     expf_scale: torch.Tensor,
                     cfg: SIFTConfig) -> torch.Tensor:
    """K3-ori: (N, 36) raw orientation histograms (arguments as
    orientation_hist_plain). CPU tensors take the plain version; CUDA
    tensors launch the kernel, one block per keypoint."""
    _check_args(padded, layer, r, c, radius, expf_scale, cfg)
    if padded.device.type == "cpu":
        return orientation_hist_plain(padded, layer, r, c, radius,
                                      expf_scale, cfg)
    if padded.device.type != "cuda":
        raise ValueError(f"orientation_hist: unsupported device "
                         f"{padded.device}")
    if cfg.ori_hist_bins != _KERNEL_BINS:
        raise ValueError(f"the kernel bins into {_KERNEL_BINS}, not "
                         f"{cfg.ori_hist_bins}")
    padded = padded.contiguous()
    layer, r, c, radius = (
        v.to(device=padded.device, dtype=torch.int32).contiguous()
        for v in (layer, r, c, radius))
    expf_scale = expf_scale.to(device=padded.device,
                               dtype=torch.float32).contiguous()
    nlay, hp, wp = padded.shape
    n = layer.shape[0]
    out = torch.empty((n, _KERNEL_BINS), dtype=torch.float32,
                      device=padded.device)
    with torch.cuda.device(padded.device):
        err = _build.library().sift_ori_hist(
            padded.data_ptr(), layer.data_ptr(), r.data_ptr(), c.data_ptr(),
            radius.data_ptr(), expf_scale.data_ptr(), out.data_ptr(), n,
            nlay, hp, wp, cfg.ori_patch_radius,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_ori_hist")
    orientation_hist.launches += 1
    return out


orientation_hist.launches = 0
