"""K3-ori wrapper: per-keypoint 36-bin orientation histograms, the patch
gather fused with the histogram that consumes it.

Counterpart of sift_tpu/ops/ori_gather_pallas.py (gather_patches) plus
the one-hot contraction of sift_tpu/ops/orientation.py (_hist_bins,
"onehot_t"). `orientation_hist` launches the CUDA kernel
(csrc/ori_hist.cu) for a CUDA tensor and runs `orientation_hist_plain`
for a CPU tensor. Both return `hist` of calcOrientationHist
(src/sift.cpp:389-458) before smoothing, with the per-sample arithmetic
of the plain version. The kernel sums integers at a per-keypoint
power-of-two scale (csrc/hist_common.cuh), so its bits depend neither on
the order of the sums nor on `cluster_size`; it differs from the plain
version by that version's float summation order and by at most half a
unit of that scale per sample and bin. The scale comes from the largest
finite gradient component of the keypoint's box, so a finite outlier
that the kernel does not bin, far above the gradients it does, coarsens
the unit; a NaN or an infinity that it does not bin never touches the
row. A binned sample whose value is not finite makes the kernel's row
all NaN, where the plain version's row holds a NaN or an infinity
(0 * NaN and 0 * inf in its one-hot product).
A sample counts where its row lies strictly inside (row_lo, row_hi - 1),
(0, h) by default: a row band of a larger image passes the local rows
of the image's own edges (`row_window`).

One call takes one frame, an (L, Hp, Wp) stack with (N,) keypoint
arguments, or B frames, a (B, L, Hp, Wp) stack with (B, N) arguments:
one launch for all B·N keypoints over the (B·L, Hp, Wp) stack, each
keypoint's layer clamped inside its own frame (`stack_layer`). Each
keypoint takes a thread block cluster of `cluster_size` CTAs.
"""

from __future__ import annotations

import functools

import torch

from sift_tpu_torch import _build
from sift_tpu_torch.config import SIFTConfig
from sift_tpu_torch.ops.mathutil import fast_atan2_deg, cv_round
from sift_tpu_torch.ops.ori_gather_cuda import gather_patches_plain

_KERNEL_BINS = 36     # csrc/ori_hist.cu: kBins
_MAX_CLUSTER = 8      # csrc/hist_common.cuh: kMaxCluster
_CTAS_PER_SM = 2      # cluster_size: the least CTAs a launch gives an SM


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def cluster_size(n: int, device: torch.device) -> int:
    """CTAs per keypoint (1.._MAX_CLUSTER) for a K3-ori or K3-desc launch
    of n keypoints on a card: the fewest that give the launch
    _CTAS_PER_SM CTAs for each of the card's SMs, so that an octave with
    few keypoints still spreads over the card. Only the time depends on
    it, never the result."""
    want = _CTAS_PER_SM * _sm_count(device)
    return max(1, min(_MAX_CLUSTER, -(-want // max(n, 1))))


def check_frames(padded, pad: int, *kp_args) -> None:
    """An (L, Hp, Wp) float32 stack with (N,) keypoint arguments, or a
    (B, L, Hp, Wp) one with (B, N) arguments, padded by `pad`."""
    if padded.dtype != torch.float32 or padded.dim() not in (3, 4):
        raise ValueError(f"source must be (L, Hp, Wp) or (B, L, Hp, Wp) "
                         f"float32, got {tuple(padded.shape)} {padded.dtype}")
    if min(padded.shape[-2:]) < 2 * pad + 1:
        raise ValueError(f"source {tuple(padded.shape)} is not padded by "
                         f"{pad}")
    shape = kp_args[0].shape
    if (any(a.shape != shape for a in kp_args)
            or len(shape) != padded.dim() - 2
            or shape[:-1] != padded.shape[:-3]):
        raise ValueError(f"keypoint arguments must be (N,) tensors of one "
                         f"shape for an (L, Hp, Wp) source, (B, N) for a "
                         f"(B, L, Hp, Wp) one; got {tuple(padded.shape)} "
                         f"and {[tuple(a.shape) for a in kp_args]}")


def _check_args(padded, layer, r, c, radius, expf_scale,
                cfg: SIFTConfig) -> None:
    check_frames(padded, cfg.ori_patch_radius + 1, layer, r, c, radius,
                 expf_scale)


def frame_stack(padded: torch.Tensor):
    """(stack, frames, layers per frame): a (B, L, Hp, Wp) source as the
    (B·L, Hp, Wp) stack the kernels read; an (L, Hp, Wp) one is a single
    frame."""
    if padded.dim() == 3:
        return padded, 1, padded.shape[0]
    nb, nlay = padded.shape[:2]
    return padded.reshape(nb * nlay, *padded.shape[2:]), nb, nlay


def stack_layer(layer: torch.Tensor, n_layers: int,
                frame: int) -> torch.Tensor:
    """Frame `frame`'s keypoint layers -> planes of the stacked frames:
    clamped to 0..n_layers - 1 inside the frame, as lax.dynamic_slice
    clamps a window's start in one frame's stack, then offset to the
    frame's planes; csrc/hist_common.cuh load_window, line for line."""
    return layer.clamp(0, n_layers - 1) + frame * n_layers


def row_window(row_bounds, h: int):
    """(row_lo, row_hi) as Python ints: the rows of the true image's
    first row and one past its last, in the stack's local rows; (0, h)
    for None. They may lie outside the stack: they are compared, never
    clamped."""
    if row_bounds is None:
        return 0, h
    lo, hi = (int(v) for v in row_bounds)
    return lo, hi


def hist_onehot(contrib: torch.Tensor, bins: torch.Tensor,
                n: int) -> torch.Tensor:
    """(N, P) contributions into (N, P) bin indices -> (N, n) weighted
    histograms, as one-hot (N, n, P) @ (N, P, 1)."""
    onehot = (torch.arange(n, device=bins.device)[None, :, None]
              == bins[:, None, :]).to(torch.float32)
    return torch.bmm(onehot, contrib[:, :, None])[:, :, 0]


def _ori_hist_frame(stack, layer, r, c, radius, expf_scale,
                    cfg: SIFTConfig, row_bounds) -> torch.Tensor:
    """One frame's (N, n) histograms; layer indexes the stack."""
    n = cfg.ori_hist_bins
    rp = cfg.ori_patch_radius
    h, w = (s - 2 * (rp + 1) for s in stack.shape[1:])
    row_lo, row_hi = row_window(row_bounds, h)
    # pixel (r, c) lands at patch[rp+1, rp+1]
    patches = gather_patches_plain(stack, layer, r, c, 2 * rp + 3)

    off = torch.arange(-rp, rp + 1, dtype=torch.int32, device=stack.device)
    ii = off[None, :, None]                   # row offsets
    jj = off[None, None, :]                   # col offsets
    r2_grid = (ii * ii + jj * jj).to(torch.float32)

    dx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]
    dy = patches[:, :-2, 1:-1] - patches[:, 2:, 1:-1]

    rad = radius[:, None, None]
    yy = r[:, None, None] + ii
    xx = c[:, None, None] + jj
    m = ((ii.abs() <= rad) & (jj.abs() <= rad)
         & (yy > row_lo) & (yy < row_hi - 1) & (xx > 0) & (xx < w - 1))
    wgt = torch.exp(r2_grid * expf_scale[:, None, None])
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = fast_atan2_deg(dy, dx)
    contrib = torch.where(m, wgt * mag, 0.0)

    bins = cv_round((n / 360.0) * ori)
    bins = torch.where(bins >= n, bins - n, bins)
    bins = torch.where(bins < 0, bins + n, bins)
    k = r.shape[0]
    return hist_onehot(contrib.reshape(k, -1), bins.reshape(k, -1), n)


def orientation_hist_plain(padded: torch.Tensor, layer: torch.Tensor,
                           r: torch.Tensor, c: torch.Tensor,
                           radius: torch.Tensor, expf_scale: torch.Tensor,
                           cfg: SIFTConfig, row_bounds=None) -> torch.Tensor:
    """Plain PyTorch K3-ori: one max-radius patch per keypoint, masked to
    its radius and the image interior, then a one-hot contraction.

    padded: (L, Hp, Wp), the octave's layers padded by
    ori_patch_radius + 1, or (B, L, Hp, Wp) for B frames; layer: (N,)
    index into the frame's L planes, or (B, N); r, c: octave pixel;
    radius (int32), expf_scale: from orientation.orientation_params;
    row_bounds: optional (lo, hi) rows of the true image
    (`row_window`). Returns (N, ori_hist_bins), or (B, N, ...). Frame
    b's keypoints read the flattened stack at stack_layer(layer, L, b),
    as the kernel does, one frame at a time: a frame's sums never
    depend on the other frames.
    """
    _check_args(padded, layer, r, c, radius, expf_scale, cfg)
    stack, nb, nlay = frame_stack(padded)
    args = [a.reshape(nb, -1) for a in (layer, r, c, radius, expf_scale)]
    hist = torch.stack([
        _ori_hist_frame(stack, stack_layer(args[0][b], nlay, b),
                        *(a[b] for a in args[1:]), cfg, row_bounds)
        for b in range(nb)])
    return hist.reshape(*layer.shape, cfg.ori_hist_bins)


def orientation_hist(padded: torch.Tensor, layer: torch.Tensor,
                     r: torch.Tensor, c: torch.Tensor, radius: torch.Tensor,
                     expf_scale: torch.Tensor, cfg: SIFTConfig,
                     row_bounds=None) -> torch.Tensor:
    """K3-ori: raw orientation histograms (arguments and result as
    orientation_hist_plain). CPU tensors take the plain version; CUDA
    tensors launch the kernel once for all frames, a cluster of
    cluster_size CTAs per keypoint."""
    _check_args(padded, layer, r, c, radius, expf_scale, cfg)
    if padded.device.type == "cpu":
        return orientation_hist_plain(padded, layer, r, c, radius,
                                      expf_scale, cfg, row_bounds)
    if padded.device.type != "cuda":
        raise ValueError(f"orientation_hist: unsupported device "
                         f"{padded.device}")
    if cfg.ori_hist_bins != _KERNEL_BINS:
        raise ValueError(f"the kernel bins into {_KERNEL_BINS}, not "
                         f"{cfg.ori_hist_bins}")
    stack, nb, _ = frame_stack(padded.contiguous())
    shape = layer.shape
    layer, r, c, radius = (
        v.to(device=padded.device, dtype=torch.int32).reshape(-1)
        .contiguous() for v in (layer, r, c, radius))
    expf_scale = expf_scale.to(device=padded.device,
                               dtype=torch.float32).reshape(-1).contiguous()
    nlay, hp, wp = stack.shape
    rp = cfg.ori_patch_radius
    row_lo, row_hi = row_window(row_bounds, hp - 2 * (rp + 1))
    n = layer.shape[0]
    out = torch.empty((n, _KERNEL_BINS), dtype=torch.float32,
                      device=padded.device)
    with torch.cuda.device(padded.device):
        err = _build.library().sift_ori_hist(
            stack.data_ptr(), layer.data_ptr(), r.data_ptr(), c.data_ptr(),
            radius.data_ptr(), expf_scale.data_ptr(), out.data_ptr(), n, nb,
            nlay, hp, wp, rp, row_lo, row_hi,
            cluster_size(n, padded.device),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_ori_hist")
    orientation_hist.launches += 1
    return out.reshape(*shape, _KERNEL_BINS)


orientation_hist.launches = 0
