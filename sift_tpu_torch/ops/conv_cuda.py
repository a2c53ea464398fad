"""K1 wrapper: separable truncated Gaussian blur, one image -> S planes.

Counterpart of sift_tpu/ops/conv_pallas.py. `blur_vh` launches the
CUDA kernel (csrc/blur.cu) for a CUDA tensor and runs `blur_vh_plain`,
the plain PyTorch version beside it, for a CPU tensor. Both sum the
nonzero taps in tap order with a rounding after each multiply and add,
as the Pallas kernel does, and read zeros outside the image.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_tpu_torch import _build


def _check_args(x: torch.Tensor, kmat: np.ndarray) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"blur input must be (H, W) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if kmat.ndim != 2 or kmat.shape[1] % 2 != 1:
        raise ValueError(f"taps must be (S, odd K), got {kmat.shape}")


def _pass_plain(x: torch.Tensor, kmat: np.ndarray, dim: int) -> torch.Tensor:
    """(S or 1, H, W) -> (S, H, W), 1-D blur along `dim` (1 rows,
    2 cols) with zero padding; plane s of a 1-plane input uses taps s."""
    s, k = kmat.shape
    w = k // 2
    n = x.shape[dim]
    pad = (0, 0, w, w) if dim == 1 else (w, w, 0, 0)
    p = torch.nn.functional.pad(x, pad)
    out = []
    for si in range(s):
        src = p[0 if p.shape[0] == 1 else si]
        acc = None
        for di in range(k):
            t = float(kmat[si, di])
            if t == 0.0:
                continue
            term = src.narrow(dim - 1, di, n) * t
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out)


def blur_vh_plain(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """Plain PyTorch K1: (H, W) -> (S, H, W), vertical then horizontal
    pass with the (S, K) taps `kmat`. The caller applies the
    last-row/col quirk."""
    _check_args(x, kmat)
    return _pass_plain(_pass_plain(x[None], kmat, 1), kmat, 2)


def blur_vh(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """K1: (H, W) float32 -> (S, H, W). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_args(x, kmat)
    if x.device.type == "cpu":
        return blur_vh_plain(x, kmat)
    if x.device.type != "cuda":
        raise ValueError(f"blur_vh: unsupported device {x.device}")
    s, k = kmat.shape
    if s > 8 or k > 63:
        raise ValueError(f"K1 kernel takes S <= 8, K <= 63; got {s}, {k}")
    x = x.contiguous()
    h, w = x.shape
    taps = np.ascontiguousarray(kmat, dtype=np.float32)
    tmp = torch.empty((s, h, w), dtype=torch.float32, device=x.device)
    out = torch.empty((s, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().sift_blur_multi(
            x.data_ptr(), tmp.data_ptr(), out.data_ptr(), h, w, s, k,
            taps.ctypes.data, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_blur_multi")
    blur_vh.launches += 1
    return out


blur_vh.launches = 0
