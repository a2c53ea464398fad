"""Sharded brute-force matching (twin of sift_tpu/parallel/match.py).

`sharded_match_ratio` splits the QUERY rows over the mesh's first axis:
each rank runs K4 (ops/match.match_ratio) on its rows against the whole
train set, and one all_gather puts the rows back in order (top-2 is
row-independent). `sharded_match_ratio_train_sharded` splits the TRAIN
rows instead, for train sets too big to hold on every rank: each rank
runs K4 on its shard, then one all_gather of (d1, d2, idx + base) per
query -- 12 bytes a query, never the distance matrix -- is merged in
rank order.
"""

from __future__ import annotations

from typing import Optional

import torch

from sift_tpu_torch.ops import match as match_mod
from sift_tpu_torch.parallel.mesh import Mesh, all_gather, axis_index, \
    axis_size


def sharded_match_ratio(query: torch.Tensor, train: torch.Tensor,
                        mesh: Mesh,
                        q_valid: Optional[torch.Tensor] = None,
                        t_valid: Optional[torch.Tensor] = None,
                        ratio: float = 0.86) -> match_mod.Matches:
    """Query-sharded matcher: (N, D) x (M, D), N divisible by the mesh's
    first axis; every rank returns the whole (N,) Matches, equal to
    match_ratio's."""
    n = query.shape[0]
    shards = axis_size(mesh)
    if n % shards:
        raise ValueError(f"{n} query rows do not split over {shards} ranks")
    dev = mesh.device
    if q_valid is None:
        q_valid = torch.ones((n,), dtype=torch.bool)
    rows = slice(axis_index(mesh) * (n // shards),
                 (axis_index(mesh) + 1) * (n // shards))
    out = match_mod.match_ratio(
        query[rows].to(dev), train.to(dev), q_valid=q_valid[rows].to(dev),
        t_valid=None if t_valid is None else t_valid.to(dev), ratio=ratio)
    # query_idx restarts per shard; rebuild the global index
    return match_mod.Matches(
        torch.arange(n, dtype=torch.int32, device=dev),
        all_gather(out.train_idx, mesh), all_gather(out.distance, mesh),
        all_gather(out.good, mesh))


def merge_top2(d1: torch.Tensor, d2: torch.Tensor, idx: torch.Tensor):
    """(S, N) per-shard top-2 (shards in train-index order, idx global)
    -> the global (idx, d1, d2). A strict < keeps the earlier shard on
    equal distances, the lowest train index, as the single-device kernel
    does (sift_tpu/parallel/match.py:83-97)."""
    n = d1.shape[1]
    bd1 = torch.full((n,), float("inf"), device=d1.device)
    bd2 = torch.full((n,), float("inf"), device=d1.device)
    bi1 = torch.zeros((n,), dtype=idx.dtype, device=d1.device)
    for sd1, sd2, si1 in zip(d1, d2, idx):
        take = sd1 < bd1
        bd2 = torch.where(take, torch.minimum(bd1, sd2),
                          torch.minimum(bd2, sd1))
        bd1 = torch.where(take, sd1, bd1)
        bi1 = torch.where(take, si1, bi1)
    return bi1, bd1, bd2


def sharded_match_ratio_train_sharded(
        query: torch.Tensor, train: torch.Tensor, mesh: Mesh,
        q_valid: Optional[torch.Tensor] = None,
        t_valid: Optional[torch.Tensor] = None,
        ratio: float = 0.86) -> match_mod.Matches:
    """Train-sharded matcher: (N, D) x (M, D), M divisible by the mesh's
    first axis; every rank returns the whole (N,) Matches, equal to
    match_ratio's (the same ratio test and sentinel rules)."""
    n, m = query.shape[0], train.shape[0]
    shards = axis_size(mesh)
    if m % shards:
        raise ValueError(f"{m} train rows do not split over {shards} ranks")
    dev = mesh.device
    shard_m = m // shards
    base = axis_index(mesh) * shard_m
    rows = slice(base, base + shard_m)
    tv = None if t_valid is None else t_valid[rows].to(dev)
    r = match_mod.knn2_l1(query.to(dev), train[rows].to(dev), t_valid=tv)
    gathered = [all_gather(x[None], mesh)
                for x in (r.d1, r.d2, r.idx + base)]
    idx, d1, d2 = merge_top2(*gathered)
    s = match_mod._SENTINEL
    good = (d1 <= ratio * d2) & (d1 < s) & (d2 < s)
    if q_valid is not None:
        good = good & q_valid.to(dev)
    return match_mod.Matches(torch.arange(n, dtype=torch.int32, device=dev),
                             idx, d1, good)
