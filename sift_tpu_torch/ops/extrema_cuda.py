"""K2 and K2-batch wrappers: DoG 26-neighbour extremum scores.

Counterpart of sift_tpu/ops/extrema_pallas.py (extrema_scores_pallas
and extrema_scores_batch_pallas, one kernel body). `extrema_scores` and
`extrema_scores_batch` launch the CUDA kernel (csrc/extrema.cu) for a
CUDA tensor and run `extrema_scores_plain` / `extrema_scores_batch_plain`
for a CPU tensor. All give, for DoG layers 1..nL, |v| where the pixel is
a candidate (`extrema_mask`) and -1 elsewhere; the kernel only
compares, so it is bit-identical to the plain versions. Each wrapper
keeps its own launch count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sift_tpu_torch import _build
from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG


def _check_args(dog: torch.Tensor, cfg: SIFTConfig, ndim: int) -> None:
    if dog.dtype != torch.float32 or dog.dim() != ndim:
        want = "(D, H, W)" if ndim == 3 else "(B, D, H, W)"
        raise ValueError(f"DoG stack must be {want} float32, got "
                         f"{tuple(dog.shape)} {dog.dtype}")
    if dog.shape[-3] < cfg.n_octave_layers + 2:
        raise ValueError(f"DoG stack has {dog.shape[-3]} layers; scanning "
                         f"{cfg.n_octave_layers} needs {cfg.n_octave_layers + 2}")


def extrema_mask(dog: torch.Tensor, cfg: SIFTConfig = DEFAULT_CONFIG
                 ) -> torch.Tensor:
    """(..., D, H, W) DoG stack(s) -> (..., nL, H, W) candidate mask for
    layers 1..nL; a leading batch axis is carried through."""
    nl = cfg.n_octave_layers
    h, w = dog.shape[-2:]
    val = dog[..., 1:1 + nl, :, :]
    p = F.pad(dog, (1, 1, 1, 1))
    nmax = torch.full_like(val, float("-inf"))
    nmin = torch.full_like(val, float("inf"))
    for dl in (-1, 0, 1):
        for dr in (0, 1, 2):
            for dc in (0, 1, 2):
                if dl == 0 and dr == 1 and dc == 1:
                    continue  # centre
                s = p[..., 1 + dl:1 + dl + nl, dr:dr + h, dc:dc + w]
                nmax = torch.maximum(nmax, s)
                nmin = torch.minimum(nmin, s)
    mask = (val.abs() > cfg.nms_threshold) & (
        ((val > 0) & (val >= nmax)) | ((val < 0) & (val <= nmin)))
    b = cfg.img_border
    rr = torch.arange(h, device=dog.device)
    cc = torch.arange(w, device=dog.device)
    border = ((rr >= b) & (rr < h - b))[:, None] & (
        (cc >= b) & (cc < w - b))[None, :]
    return mask & border


def _plain(dog: torch.Tensor, cfg: SIFTConfig) -> torch.Tensor:
    val = dog[..., 1:1 + cfg.n_octave_layers, :, :]
    return torch.where(extrema_mask(dog, cfg), val.abs(),
                       torch.full_like(val, -1.0))


def _launch(dog: torch.Tensor, cfg: SIFTConfig) -> torch.Tensor:
    """The CUDA kernel on (B, D, H, W) -> (B, nL, H, W)."""
    # the kernel's border test keeps every neighbour load inside the
    # frame only while the border is at least one pixel
    if cfg.img_border < 1:
        raise ValueError(f"K2 kernel needs img_border >= 1, got "
                         f"{cfg.img_border}")
    dog = dog.contiguous()
    nl = cfg.n_octave_layers
    b, d, h, w = dog.shape
    out = torch.empty((b, nl, h, w), dtype=torch.float32, device=dog.device)
    with torch.cuda.device(dog.device):
        err = _build.library().sift_extrema_scores(
            dog.data_ptr(), out.data_ptr(), b, d, nl, h, w,
            float(cfg.nms_threshold), cfg.img_border,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_extrema_scores")
    return out


def extrema_scores_plain(dog: torch.Tensor,
                         cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Plain PyTorch K2: (D, H, W) -> (nL, H, W) scores."""
    _check_args(dog, cfg, 3)
    return _plain(dog, cfg)


def extrema_scores(dog: torch.Tensor,
                   cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """K2: (D, H, W) DoG stack -> (nL, H, W) masked |response| scores.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_args(dog, cfg, 3)
    if dog.device.type == "cpu":
        return extrema_scores_plain(dog, cfg)
    if dog.device.type != "cuda":
        raise ValueError(f"extrema_scores: unsupported device {dog.device}")
    out = _launch(dog[None], cfg)[0]
    extrema_scores.launches += 1
    return out


def extrema_scores_batch_plain(dog: torch.Tensor,
                               cfg: SIFTConfig = DEFAULT_CONFIG
                               ) -> torch.Tensor:
    """Plain PyTorch K2-batch: (B, D, H, W) -> (B, nL, H, W) scores."""
    _check_args(dog, cfg, 4)
    return _plain(dog, cfg)


def extrema_scores_batch(dog: torch.Tensor,
                         cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """K2-batch: (B, D, H, W) DoG stacks -> (B, nL, H, W) scores, one
    launch for all frames. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check_args(dog, cfg, 4)
    if dog.device.type == "cpu":
        return extrema_scores_batch_plain(dog, cfg)
    if dog.device.type != "cuda":
        raise ValueError(
            f"extrema_scores_batch: unsupported device {dog.device}")
    out = _launch(dog, cfg)
    extrema_scores_batch.launches += 1
    return out


extrema_scores.launches = 0
extrema_scores_batch.launches = 0
