"""K2 wrapper: DoG 26-neighbour extremum scores.

Counterpart of sift_tpu/ops/extrema_pallas.py. `extrema_scores`
launches the CUDA kernel (csrc/extrema.cu) for a CUDA tensor and runs
`extrema_scores_plain` for a CPU tensor. Both give, for DoG layers
1..nL, |v| where the pixel is a candidate (`extrema_mask`) and -1
elsewhere; the kernel only compares, so the two are
bit-identical.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sift_tpu_torch import _build
from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG


def _check_args(dog: torch.Tensor, cfg: SIFTConfig) -> None:
    if dog.dtype != torch.float32 or dog.dim() != 3:
        raise ValueError(f"DoG stack must be (D, H, W) float32, got "
                         f"{tuple(dog.shape)} {dog.dtype}")
    if dog.shape[0] < cfg.n_octave_layers + 2:
        raise ValueError(f"DoG stack has {dog.shape[0]} layers; scanning "
                         f"{cfg.n_octave_layers} needs {cfg.n_octave_layers + 2}")


def extrema_mask(dog: torch.Tensor, cfg: SIFTConfig = DEFAULT_CONFIG
                 ) -> torch.Tensor:
    """(D, H, W) DoG stack -> (nL, H, W) candidate mask for layers 1..nL."""
    nl = cfg.n_octave_layers
    _, h, w = dog.shape
    val = dog[1:1 + nl]
    p = F.pad(dog, (1, 1, 1, 1))
    nmax = torch.full_like(val, float("-inf"))
    nmin = torch.full_like(val, float("inf"))
    for dl in (-1, 0, 1):
        for dr in (0, 1, 2):
            for dc in (0, 1, 2):
                if dl == 0 and dr == 1 and dc == 1:
                    continue  # centre
                s = p[1 + dl:1 + dl + nl, dr:dr + h, dc:dc + w]
                nmax = torch.maximum(nmax, s)
                nmin = torch.minimum(nmin, s)
    mask = (val.abs() > cfg.nms_threshold) & (
        ((val > 0) & (val >= nmax)) | ((val < 0) & (val <= nmin)))
    b = cfg.img_border
    rr = torch.arange(h, device=dog.device)
    cc = torch.arange(w, device=dog.device)
    border = ((rr >= b) & (rr < h - b))[:, None] & (
        (cc >= b) & (cc < w - b))[None, :]
    return mask & border[None]


def extrema_scores_plain(dog: torch.Tensor,
                         cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Plain PyTorch K2: (D, H, W) -> (nL, H, W) scores."""
    _check_args(dog, cfg)
    nl = cfg.n_octave_layers
    val = dog[1:1 + nl]
    return torch.where(extrema_mask(dog, cfg), val.abs(),
                       torch.full_like(val, -1.0))


def extrema_scores(dog: torch.Tensor,
                   cfg: SIFTConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """K2: (D, H, W) DoG stack -> (nL, H, W) masked |response| scores.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_args(dog, cfg)
    if dog.device.type == "cpu":
        return extrema_scores_plain(dog, cfg)
    if dog.device.type != "cuda":
        raise ValueError(f"extrema_scores: unsupported device {dog.device}")
    dog = dog.contiguous()
    nl = cfg.n_octave_layers
    _, h, w = dog.shape
    out = torch.empty((nl, h, w), dtype=torch.float32, device=dog.device)
    with torch.cuda.device(dog.device):
        err = _build.library().sift_extrema_scores(
            dog.data_ptr(), out.data_ptr(), nl, h, w,
            float(cfg.nms_threshold), cfg.img_border,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_extrema_scores")
    extrema_scores.launches += 1
    return out


extrema_scores.launches = 0
