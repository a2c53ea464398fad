"""DoG scale-space extrema scan (reference C8a).

Twin of the 26-neighbour NMS in findScaleSpaceExtremaComputer
(src/sift.cpp:487-511) and of sift_tpu/ops/extrema.py: a pixel is a
candidate iff |val| > 8 (the literal threshold at src/sift.cpp:564) and
it is >= (resp. <=) every neighbour of its 3x3x3 DoG cube, with a 5 px
border margin. The top `cap` candidates by |response| fill the slots in
the order of a stable descending sort of the dense score field, so equal
scores keep the lower flat index first, as jax.lax.top_k does.

`top_candidates` (one frame) and `top_candidates_batch` (B frames, row b
equal to top_candidates(dog[b])) reach that order two ways:
- on the card, K2's compact scan appends each candidate's key to its
  frame's list and the select kernel takes the top `cap` keys
  (ops/extrema_cuda.py): no dense score field, no sort of it, no host
  synchronisation;
- on the CPU, `top_candidates_plain` / `top_candidates_batch_plain` sort
  the dense scores of the plain K2 (`_decode`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.ops.extrema_cuda import (  # noqa: F401
    _check_device, check_box, check_field, extrema_compact, extrema_mask,
    extrema_scores, extrema_scores_batch, extrema_scores_batch_plain,
    extrema_scores_plain, select_candidates, unpack_indices)

Candidates = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def stable_top_k(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lower index (jax.lax.top_k's
    order): (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_candidates_plain(dog: torch.Tensor, cap: int,
                         cfg: SIFTConfig = DEFAULT_CONFIG,
                         box=None) -> Candidates:
    """top_candidates by the plain K2 and a stable sort of its scores."""
    if box is None:
        score = extrema_scores_plain(dog, cfg)
    else:
        val = dog[1:1 + cfg.n_octave_layers]
        score = torch.where(extrema_mask(dog, cfg, box), val.abs(), -1.0)
    return _decode(score.reshape(-1), cap, dog.shape)


def top_candidates(dog: torch.Tensor, cap: int,
                   cfg: SIFTConfig = DEFAULT_CONFIG,
                   box=None) -> Candidates:
    """Up to `cap` NMS candidates ranked by |DoG response|.

    Returns (layer, r, c, valid), each (cap,); layer is the absolute
    DoG layer index (1..nL). Slots past the candidate count are invalid.
    box: (r_lo, r_hi, c_lo, c_hi), the pixels that may be candidates;
    default the border box, and any other box must lie inside it
    (extrema_cuda.check_box). CPU tensors take top_candidates_plain;
    CUDA tensors launch the compact scan and the select kernel. A field
    (nL*H*W) of more than 2^31 - 1 pixels raises on every device.
    """
    check_field(cfg.n_octave_layers, dog.shape[-2:])
    check_box(box, cfg, dog.shape[-2:])
    if _check_device(dog, "top_candidates"):
        return top_candidates_plain(dog, cap, cfg, box)
    return tuple(a[0] for a in _compact_select(dog[None], cap, cfg, box))


def top_candidates_batch_plain(dog: torch.Tensor, cap: int,
                               cfg: SIFTConfig = DEFAULT_CONFIG
                               ) -> Candidates:
    """top_candidates_batch by the plain K2-batch and a stable sort."""
    score = extrema_scores_batch_plain(dog, cfg).reshape(dog.shape[0], -1)
    return _decode(score, cap, dog.shape)


def top_candidates_batch(dog: torch.Tensor, cap: int,
                         cfg: SIFTConfig = DEFAULT_CONFIG) -> Candidates:
    """B frames: (B, D, H, W) -> (layer, r, c, valid), each (B, cap);
    row b equals top_candidates(dog[b], cap). One compact scan and one
    select launch for all frames on the card."""
    check_field(cfg.n_octave_layers, dog.shape[-2:])
    if _check_device(dog, "top_candidates_batch"):
        return top_candidates_batch_plain(dog, cap, cfg)
    return _compact_select(dog, cap, cfg)


def _compact_select(dog: torch.Tensor, cap: int, cfg: SIFTConfig,
                    box=None) -> Candidates:
    keys, count = extrema_compact(dog, cfg, box)
    return select_candidates(keys, count, cap, dog.shape[-2:])


def _decode(score: torch.Tensor, cap: int, shape) -> Candidates:
    """Top `cap` of (..., nL*H*W) flat scores -> (layer, r, c, valid)."""
    k = min(cap, score.shape[-1])
    vals, idx = stable_top_k(score, k)
    if k < cap:  # pad up to the static cap
        vals = F.pad(vals, (0, cap - k), value=-1.0)
        idx = F.pad(idx, (0, cap - k))
    return unpack_indices(idx, vals > 0.0, shape[-2:])
