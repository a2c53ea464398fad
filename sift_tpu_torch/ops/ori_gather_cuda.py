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
"""

from __future__ import annotations

import torch

from sift_tpu_torch import _build


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


def gather_patches(padded: torch.Tensor, layer: torch.Tensor,
                   r: torch.Tensor, c: torch.Tensor,
                   patch: int) -> torch.Tensor:
    """K3: (N, patch, patch) windows of `padded` at (layer, r, c).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
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
    with torch.cuda.device(padded.device):
        err = _build.library().sift_gather_patches(
            padded.data_ptr(), layer.data_ptr(), r.data_ptr(), c.data_ptr(),
            out.data_ptr(), n, nlay, hp, wp, patch,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_gather_patches")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
