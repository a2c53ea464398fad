"""Two-stage cascade matcher for map-scale descriptor sets.

Twin of sift_tpu/ops/match_cascade.py. The exact matcher (ops/match.py)
is O(N*M*128): fine for frame pairs, quadratic for matching a frame
against a map of 100k+ points. The cascade:

  stage 1 (coarse): project both sides to d' dimensions with a fixed
      random matrix, take squared-L2 distances in the projection as a
      matrix product (|b|^2 - 2ab; |a|^2 is constant per query row),
      and keep the top-C train rows per query;
  stage 2 (exact): gather those C rows' full descriptors and run the
      exact L1 top-2 and the ratio test among them (reference
      semantics, src/main.cpp:25-40).

Both top-k's are stable descending sorts, so ties go to the lower
index, as jax.lax.top_k's do. sift_tpu's match_cascade.py docstring
holds the measured decision agreement and hallucination rates behind
the default C = 64 and the downstream_verified rule.
"""

from __future__ import annotations

from typing import Optional

import torch

from sift_tpu_torch.ops.extrema import stable_top_k
from sift_tpu_torch.ops.match import Matches, _SENTINEL, mask_train


def projection(d: int, d_proj: int, seed: int) -> torch.Tensor:
    """(d, d_proj) Gaussian random projection with scale 1/sqrt(d), drawn
    from a torch.Generator seeded with `seed`. The JAX package draws its
    projection with jax.random, so the same seed gives a different
    matrix there; pass that matrix as `proj` to reproduce its results."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((d, d_proj), generator=gen,
                       dtype=torch.float32) / (d ** 0.5)


def match_ratio_cascade(query: torch.Tensor, train: torch.Tensor,
                        q_valid: Optional[torch.Tensor] = None,
                        t_valid: Optional[torch.Tensor] = None,
                        ratio: float = 0.86,
                        n_candidates: int = 64,
                        d_proj: int = 16,
                        proj: Optional[torch.Tensor] = None,
                        seed: int = 7,
                        tile: int = 512,
                        downstream_verified: bool = True) -> Matches:
    """Cascade kNN + Lowe ratio test: (N, D) x (M, D) -> Matches.

    proj: the (D, d_proj) projection; None draws `projection(D, d_proj,
    seed)`, which differs from the JAX package's draw for that seed.
    Queries are processed `tile` rows at a time, so the coarse distance
    matrix is at most (tile, M).

    downstream_verified: keep True only when the matches feed geometric
    verification (RANSAC), which absorbs the measured ~1-2 %
    hallucination rate on match-free queries. With False the candidate
    depth is raised to at least 128.
    """
    if not downstream_verified:
        n_candidates = max(n_candidates, 128)
    n, d = query.shape
    m = train.shape[0]
    dev = query.device
    if n == 0:
        return Matches(torch.zeros((0,), dtype=torch.int32, device=dev),
                       torch.zeros((0,), dtype=torch.int32, device=dev),
                       torch.zeros((0,), dtype=torch.float32, device=dev),
                       torch.zeros((0,), dtype=torch.bool, device=dev))
    if m < 2:
        # BFMatcher k=2 needs two train rows: nothing can be a good match
        return Matches(torch.arange(n, dtype=torch.int32, device=dev),
                       torch.zeros((n,), dtype=torch.int32, device=dev),
                       torch.full((n,), _SENTINEL, dtype=torch.float32,
                                  device=dev),
                       torch.zeros((n,), dtype=torch.bool, device=dev))
    c = min(n_candidates, m)
    if proj is None:
        proj = projection(d, d_proj, seed)
    proj = proj.to(device=dev, dtype=torch.float32)
    q32 = query.to(torch.float32)
    t32 = mask_train(train.to(torch.float32), t_valid)

    qp = q32 @ proj                                   # (N, d')
    tp = t32 @ proj                                   # (M, d')
    t_sq = (tp * tp).sum(dim=1)                       # (M,)

    idx, d1, d2 = [], [], []
    tile_n = min(tile, n)
    for s in range(0, n, tile_n):
        q_c = q32[s:s + tile_n]
        coarse = t_sq[None, :] - 2.0 * (qp[s:s + tile_n] @ tp.T)
        _, cand = stable_top_k(-coarse, c)            # (tile, C)
        dist = (q_c[:, None, :] - t32[cand]).abs().sum(dim=-1)
        neg, idx2 = stable_top_k(-dist, 2)
        idx.append(torch.gather(cand, 1, idx2[:, :1])[:, 0])
        d1.append(-neg[:, 0])
        d2.append(-neg[:, 1])
    idx, d1, d2 = torch.cat(idx), torch.cat(d1), torch.cat(d2)

    good = (d1 <= ratio * d2) & (d1 < _SENTINEL) & (d2 < _SENTINEL)
    if q_valid is not None:
        good = good & q_valid
    return Matches(torch.arange(n, dtype=torch.int32, device=dev),
                   idx.to(torch.int32), d1, good)
