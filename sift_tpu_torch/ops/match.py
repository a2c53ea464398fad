"""Brute-force kNN descriptor matching (reference C11).

Twin of BFMatcher(NORM_L1).knnMatch(query, train, k=2) plus the Lowe
ratio test `d1 <= ratio * d2` (src/main.cpp:25-40, ratio 0.86), and of
sift_tpu/ops/match.py. Descriptors live in fixed-capacity arrays with
validity masks: invalid train rows are overwritten with a sentinel so
their distances never win, and invalid query rows are filtered after
the fact. The top-2 search is K4 (ops/match_cuda.py).

Every function also takes G pairs along a leading axis -- query
(G, N, D), train (G, M, D), q_valid (G, N), t_valid (G, M) -- and then
returns (G, N) fields, as jax.vmap of sift_tpu's functions does; K4
matches all G pairs in one launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sift_tpu_torch.ops.match_cuda import knn2_l1_cuda
from sift_tpu_torch.utils.profiling import span

_SENTINEL = 1.0e6  # masked train descriptor value; L1 dist >= 1e8


class Knn2(NamedTuple):
    """Top-2 L1 match result per query row."""
    idx: torch.Tensor   # (N,) or (G, N) int32, best train index
    d1: torch.Tensor    # float32, best distance
    d2: torch.Tensor    # float32, second-best distance


def mask_train(train: torch.Tensor, t_valid: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Overwrite invalid train rows with a sentinel so they never match."""
    if t_valid is None:
        return train
    return torch.where(t_valid[..., None], train, _SENTINEL)


def knn2_l1(query: torch.Tensor, train: torch.Tensor,
            t_valid: Optional[torch.Tensor] = None) -> Knn2:
    """Top-2 L1 matcher: (N, D) x (M, D) -> Knn2, or G pairs
    (G, N, D) x (G, M, D) -> (G, N) fields; the lowest train index wins
    equal distances (BFMatcher's stable order)."""
    t = mask_train(train.to(torch.float32), t_valid)
    return Knn2(*knn2_l1_cuda(query.to(torch.float32), t))


class Matches(NamedTuple):
    """Ratio-test-filtered matches, padded to query capacity.

    good[i] is True iff query i is valid, its best train match is
    valid, and d1 <= ratio * d2 (src/main.cpp:38).
    """
    query_idx: torch.Tensor  # (N,) int32 (= arange), or (G, N)
    train_idx: torch.Tensor  # (N,) or (G, N) int32
    distance: torch.Tensor   # float32
    good: torch.Tensor       # bool


def match_ratio(query: torch.Tensor, train: torch.Tensor,
                q_valid: Optional[torch.Tensor] = None,
                t_valid: Optional[torch.Tensor] = None,
                ratio: float = 0.86) -> Matches:
    """knnMatch(k=2) + Lowe ratio test (src/main.cpp:25-40); of one
    pair, or of G pairs along a leading axis in one K4 launch."""
    with span("match.ratio"):
        r = knn2_l1(query, train, t_valid)
        good = r.d1 <= ratio * r.d2
        # a best hit on a sentinel row matched nothing real; with < 2
        # valid train rows d2 is the sentinel and the ratio test would
        # pass vacuously -- BFMatcher k=2 finds no pair either
        good = good & (r.d1 < _SENTINEL) & (r.d2 < _SENTINEL)
        if q_valid is not None:
            good = good & q_valid
        n = query.shape[-2]
        qidx = torch.arange(n, dtype=torch.int32, device=query.device)
        return Matches(qidx.expand(r.idx.shape).contiguous(), r.idx, r.d1,
                       good)
