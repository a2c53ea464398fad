"""K3 wrapper: keypoint patch gather.

Counterpart of sift_tpu/ops/ori_gather_pallas.py. `gather_patches`
launches the CUDA kernel (csrc/gather.cu) for a CUDA tensor and runs
`gather_patches_plain` for a CPU tensor. Both return, for each
keypoint, the (patch, patch) window of the padded stack starting at
(layer, r, c), with the starts clamped as lax.dynamic_slice clamps
them; the two are bit-identical (a copy). The main path reads its
windows inside K3-ori and K3-desc (ops/ori_hist_cuda.py,
ops/descr_hist_cuda.py), whose plain versions gather through
`gather_patches_plain`.

The kernel's grid is (keypoint, row block): a CTA of `warps` warps
copies _ROWS rows a warp of one window at a time (`gather_shape`,
cached for each (n, p, device) by `launch_warps`; `gather_grid` gives
the grid it makes).
"""

from __future__ import annotations

import functools

import torch

from sift_tpu_torch import _build

_ROWS = 2             # csrc/gather.cu: kRows, rows a warp at a time
_WARPS = 4            # gather_shape: warps a CTA at most
_CTAS_PER_SM = 2      # gather_shape: the least CTAs a launch gives an SM
_MAX_GRID_Y = 65535   # csrc/gather.cu: kMaxGridY, row blocks of a launch


def _check_args(padded, layer, r, c, patch) -> None:
    if padded.dtype != torch.float32 or padded.dim() != 3:
        raise ValueError(f"gather source must be (L, Hp, Wp) float32, got "
                         f"{tuple(padded.shape)} {padded.dtype}")
    if patch > padded.shape[1] or patch > padded.shape[2]:
        raise ValueError(f"patch {patch} exceeds source {tuple(padded.shape)}")
    if not (layer.shape == r.shape == c.shape) or layer.dim() != 1:
        raise ValueError("layer/r/c must be (N,) tensors of one shape")


def gather_patches_plain(padded: torch.Tensor, layer: torch.Tensor,
                         r: torch.Tensor, c: torch.Tensor,
                         patch: int) -> torch.Tensor:
    """Plain PyTorch K3: (L, Hp, Wp) x (N,) starts -> (N, patch, patch)."""
    _check_args(padded, layer, r, c, patch)
    nlay, hp, wp = padded.shape
    lay = layer.long().clamp(0, nlay - 1)
    rs = r.long().clamp(0, hp - patch)
    cs = c.long().clamp(0, wp - patch)
    off = torch.arange(patch, device=padded.device)
    rows = (rs[:, None] + off)[:, :, None]
    cols = (cs[:, None] + off)[:, None, :]
    return padded[lay[:, None, None], rows, cols]


def gather_shape(n: int, p: int, sms: int) -> int:
    """Warps a CTA of a K3 launch of n windows of p x p on a card of
    `sms` SMs: the most, up to _WARPS, that still give the launch
    _CTAS_PER_SM CTAs an SM, or one where the windows have too few rows
    for that. Only the time depends on it, never the result."""
    for warps in range(min(_WARPS, -(-p // _ROWS)), 1, -1):
        if n * gather_grid(p, warps)[0] >= _CTAS_PER_SM * sms:
            return warps
    return 1


def gather_grid(p: int, warps: int) -> tuple:
    """(CTAs a window, threads a CTA) of a launch of `warps` warps a CTA,
    as csrc/gather.cu's gather_dims sets them: one CTA a block of _ROWS x
    warps rows, at most _MAX_GRID_Y, which then stride over the rest."""
    return min(-(-p // (_ROWS * warps)), _MAX_GRID_Y), 32 * warps


@functools.lru_cache(maxsize=256)
def launch_warps(n: int, p: int, device: torch.device) -> int:
    """gather_shape on `device`'s SM count, computed once for each (n,
    p, device)."""
    return gather_shape(
        n, p, torch.cuda.get_device_properties(device).multi_processor_count)


def gather_patches(padded: torch.Tensor, layer: torch.Tensor,
                   r: torch.Tensor, c: torch.Tensor,
                   patch: int) -> torch.Tensor:
    """K3: (N, patch, patch) windows of `padded` at (layer, r, c).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    with launch_warps' warps a CTA."""
    _check_args(padded, layer, r, c, patch)
    if padded.device.type == "cpu":
        return gather_patches_plain(padded, layer, r, c, patch)
    if padded.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {padded.device}")
    padded = padded.contiguous()
    layer, r, c = (v.to(device=padded.device, dtype=torch.int32).contiguous()
                   for v in (layer, r, c))
    nlay, hp, wp = padded.shape
    n = layer.shape[0]
    out = torch.empty((n, patch, patch), dtype=torch.float32,
                      device=padded.device)
    if n == 0:
        return out
    with torch.cuda.device(padded.device):
        err = _build.library().sift_gather_patches(
            padded.data_ptr(), layer.data_ptr(), r.data_ptr(), c.data_ptr(),
            out.data_ptr(), n, nlay, hp, wp, patch,
            launch_warps(n, patch, padded.device),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_gather_patches")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
