"""DoG scale-space extrema scan (reference C8a).

Twin of the 26-neighbour NMS in findScaleSpaceExtremaComputer
(src/sift.cpp:487-511) and of sift_tpu/ops/extrema.py: a pixel is a
candidate iff |val| > 8 (the literal threshold at src/sift.cpp:564) and
it is >= (resp. <=) every neighbour of its 3x3x3 DoG cube, with a 5 px
border margin. The mask and the dense score field live with K2
(ops/extrema_cuda.py); the top `cap` candidates by |response| are then
taken with one stable descending sort, so equal scores keep the lower
flat index first, as jax.lax.top_k does. `top_candidates_batch` does the
same for B frames: one K2-batch launch and one sort along the last axis
of the (B, nL*H*W) scores, so row b equals top_candidates(dog[b]).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.ops.extrema_cuda import (  # noqa: F401
    extrema_mask, extrema_scores, extrema_scores_batch)


def stable_top_k(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lower index (jax.lax.top_k's
    order): (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_candidates(dog: torch.Tensor, cap: int,
                   cfg: SIFTConfig = DEFAULT_CONFIG
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Up to `cap` NMS candidates ranked by |DoG response|.

    Returns (layer, r, c, valid), each (cap,); layer is the absolute
    DoG layer index (1..nL). Slots past the candidate count are invalid.
    """
    return _decode(extrema_scores(dog, cfg).reshape(-1), cap, dog.shape)


def top_candidates_batch(dog: torch.Tensor, cap: int,
                         cfg: SIFTConfig = DEFAULT_CONFIG
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """B frames: (B, D, H, W) -> (layer, r, c, valid), each (B, cap);
    row b equals top_candidates(dog[b], cap)."""
    score = extrema_scores_batch(dog, cfg).reshape(dog.shape[0], -1)
    return _decode(score, cap, dog.shape)


def _decode(score: torch.Tensor, cap: int, shape) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top `cap` of (..., nL*H*W) flat scores -> (layer, r, c, valid)."""
    h, w = shape[-2:]
    k = min(cap, score.shape[-1])
    vals, idx = stable_top_k(score, k)
    if k < cap:  # pad up to the static cap
        vals = F.pad(vals, (0, cap - k), value=-1.0)
        idx = F.pad(idx, (0, cap - k))
    layer = idx // (h * w) + 1
    rem = idx % (h * w)
    return (layer.to(torch.int32), (rem // w).to(torch.int32),
            (rem % w).to(torch.int32), vals > 0.0)
