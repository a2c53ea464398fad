"""K1 and K1-batch wrappers: separable truncated Gaussian blur, one or B
octave bases -> S planes each.

Counterpart of sift_tpu/ops/conv_pallas.py (gaussian_blur_multi_pallas
and gaussian_blur_multi_batch_pallas, one kernel body). `blur_vh` and
`blur_vh_batch` launch the CUDA kernel (csrc/blur.cu) for a CUDA tensor
and run `blur_vh_plain` / `blur_vh_batch_plain`, the plain PyTorch
versions beside them, for a CPU tensor. All sum the nonzero taps in tap
order with a rounding after each multiply and add, as the Pallas kernel
does, and read zeros outside the image. The kernel loops over each
scale's range of nonzero taps (`tap_ranges`), which must hold no zero.
Each wrapper keeps its own launch count, so a run shows which of the
two it went through.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_tpu_torch import _build

_MAX_GRID_Z = 65535   # the kernel puts the B frames on grid z
# (shape, dtype, bytes) of a taps matrix -> (its float32 copy, its tap
# ranges): a config stacks the same two or three matrices on every call
_PREPARED: dict = {}


def _check_args(x: torch.Tensor, kmat: np.ndarray, ndim: int) -> None:
    if x.dtype != torch.float32 or x.dim() != ndim:
        want = "(H, W)" if ndim == 2 else "(B, H, W)"
        raise ValueError(f"blur input must be {want} float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if kmat.ndim != 2 or kmat.shape[1] % 2 != 1:
        raise ValueError(f"taps must be (S, odd K), got {kmat.shape}")


def tap_ranges(kmat: np.ndarray) -> np.ndarray:
    """(S, 2) int32: the first and last nonzero tap of each scale of the
    (S, K) taps, the range the kernel sums over. Raises ValueError if a
    scale has no nonzero tap or a zero between its first and last."""
    out = np.zeros((kmat.shape[0], 2), np.int32)
    for s, row in enumerate(kmat):
        nz = np.flatnonzero(row)
        if nz.size == 0 or nz.size != nz[-1] - nz[0] + 1:
            raise ValueError(f"scale {s}: the nonzero taps are not one "
                             f"contiguous range: {row.tolist()}")
        out[s] = nz[0], nz[-1]
    return out


def _prepared(kmat: np.ndarray):
    """(float32 taps, tap ranges) for the kernel, computed once for each
    taps matrix; the cached taps are a copy, so a caller that later
    writes into kmat changes the key, not the entry."""
    key = (kmat.shape, kmat.dtype.str, kmat.tobytes())
    hit = _PREPARED.get(key)
    if hit is None:
        taps = np.array(kmat, dtype=np.float32, order="C")
        hit = _PREPARED[key] = (taps, tap_ranges(taps))
    return hit


def _pass_plain(x: torch.Tensor, kmat: np.ndarray, dim: int) -> torch.Tensor:
    """(B, S or 1, H, W) -> (B, S, H, W), 1-D blur along `dim` (2 rows,
    3 cols) with zero padding; plane s of a 1-plane input uses taps s."""
    s, k = kmat.shape
    w = k // 2
    n = x.shape[dim]
    pad = (0, 0, w, w) if dim == 2 else (w, w, 0, 0)
    p = torch.nn.functional.pad(x, pad)
    out = []
    for si in range(s):
        src = p[:, 0 if p.shape[1] == 1 else si]
        acc = None
        for di in range(k):
            t = float(kmat[si, di])
            if t == 0.0:
                continue
            term = src.narrow(dim - 1, di, n) * t
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out, dim=1)


def _plain(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """(B, H, W) -> (B, S, H, W), vertical then horizontal pass."""
    return _pass_plain(_pass_plain(x[:, None], kmat, 2), kmat, 3)


def _launch(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """The CUDA kernel on (B, H, W) -> (B, S, H, W)."""
    s, k = kmat.shape
    if s > 8 or k > 63:
        raise ValueError(f"K1 kernel takes S <= 8, K <= 63; got {s}, {k}")
    b, h, w = x.shape
    if b > _MAX_GRID_Z:
        raise ValueError(f"K1 kernel takes B <= {_MAX_GRID_Z} frames; "
                         f"got B={b}")
    taps, ranges = _prepared(kmat)
    x = x.contiguous()
    out = torch.empty((b, s, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().sift_blur_multi(
            x.data_ptr(), out.data_ptr(), b, h, w, s, k, taps.ctypes.data,
            ranges.ctypes.data, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_blur_multi")
    return out


def blur_vh_plain(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """Plain PyTorch K1: (H, W) -> (S, H, W), vertical then horizontal
    pass with the (S, K) taps `kmat`. The caller applies the
    last-row/col quirk."""
    _check_args(x, kmat, 2)
    return _plain(x[None], kmat)[0]


def blur_vh(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """K1: (H, W) float32 -> (S, H, W). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_args(x, kmat, 2)
    if x.device.type == "cpu":
        return blur_vh_plain(x, kmat)
    if x.device.type != "cuda":
        raise ValueError(f"blur_vh: unsupported device {x.device}")
    out = _launch(x[None], kmat)[0]
    blur_vh.launches += 1
    return out


def blur_vh_batch_plain(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """Plain PyTorch K1-batch: (B, H, W) -> (B, S, H, W); frame b is
    blur_vh_plain(x[b]) (the same elementwise arithmetic)."""
    _check_args(x, kmat, 3)
    return _plain(x, kmat)


def blur_vh_batch(x: torch.Tensor, kmat: np.ndarray) -> torch.Tensor:
    """K1-batch: (B, H, W) float32 -> (B, S, H, W), one launch for all
    frames. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check_args(x, kmat, 3)
    if x.device.type == "cpu":
        return blur_vh_batch_plain(x, kmat)
    if x.device.type != "cuda":
        raise ValueError(f"blur_vh_batch: unsupported device {x.device}")
    out = _launch(x, kmat)
    blur_vh_batch.launches += 1
    return out


blur_vh.launches = 0
blur_vh_batch.launches = 0
