"""K4 wrapper: brute-force top-2 L1 matcher.

Counterpart of sift_tpu/ops/match_pallas.py, and of it under jax.vmap:
both functions take one pair, (N, D) x (M, D), or G pairs,
(G, N, D) x (G, M, D), which the kernel matches in one launch.
`knn2_l1_cuda` launches the CUDA kernel (csrc/knn2.cu) for CUDA tensors
and runs `knn2_l1_plain` for CPU tensors. Both sum |q - t| over the 128 dims in
order 0..127, so their distances are bit-identical, and both break
ties to the lowest train index: a min, then the lowest index at that
min, then the min with that column excluded (match_pallas.py:67-70).
Invalid train rows arrive pre-masked (ops.match.mask_train).

The kernel splits the train set into P splits of whole 64-row tiles
(`split_plan`), keeps a partial top-2 per split and query, and merges
the partials in split order: the other partial wins on a smaller d1,
or an equal d1 with a lower index (tests/test_torch_kernel_designs.py
models the rule against `knn2_l1_plain`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from sift_tpu_torch import _build

_INF = 3.0e38          # "no second neighbour", as match_pallas._INF
_QUERY_CHUNK = 256     # bounds the plain version's (chunk, M) temporaries
_QUERY_TILE = 64       # queries per block (csrc/knn2.cu kQB)
_TRAIN_TILE = 64       # train rows per shared-memory tile (kTT)


def _check_args(query: torch.Tensor, train: torch.Tensor) -> None:
    if (query.dtype != torch.float32 or train.dtype != torch.float32
            or query.dim() not in (2, 3) or train.dim() != query.dim()
            or query.shape[-1] != train.shape[-1]
            or query.shape[:-2] != train.shape[:-2]):
        raise ValueError(f"knn2 takes (N, D) and (M, D), or (G, N, D) and "
                         f"(G, M, D), float32, got "
                         f"{tuple(query.shape)} {query.dtype}, "
                         f"{tuple(train.shape)} {train.dtype}")
    if query.device != train.device:
        raise ValueError(f"query on {query.device}, train on {train.device}")


def split_span(m: int, p: int) -> int:
    """Train rows per split when M rows are cut into P splits of whole
    tiles (at least one tile); the last splits may be short or empty."""
    tiles = -(-m // _TRAIN_TILE)
    return max(1, -(-tiles // p)) * _TRAIN_TILE


def split_plan(n: int, m: int, n_sm: int, g: int = 1) -> Tuple[int, int]:
    """(P, rows per split) for G pairs of N queries and M train rows on a
    card with n_sm SMs: the fewest tiles per split that still give a
    grid of at least two blocks per SM, counting the G pairs' query
    tiles together, unless the train set has fewer tiles."""
    q_tiles = max(1, g * -(-n // _QUERY_TILE))
    m_tiles = -(-m // _TRAIN_TILE)
    want = -(-2 * n_sm // q_tiles)          # splits for two blocks per SM
    per = max(1, m_tiles // want)           # tiles per split
    p = max(1, -(-m_tiles // per))
    return p, split_span(m, p)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, m: int, g: int, device: torch.device
                ) -> Tuple[int, int]:
    """split_plan on `device`'s SM count: what the wrapper launches with,
    computed once for each (N, M, G, device); the main path's shapes are
    fixed by the config's caps."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return split_plan(n, m, n_sm, g)


def knn2_l1_plain(query: torch.Tensor, train: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: (N, D) x (M, D) -> (idx int32, d1, d2), each (N,);
    G pairs, (G, N, D) x (G, M, D) -> each (G, N), one pair at a time."""
    _check_args(query, train)
    lead, (n, d), m = query.shape[:-2], query.shape[-2:], train.shape[-2]
    idx = torch.zeros((*lead, n), dtype=torch.int32, device=query.device)
    d1 = torch.full((*lead, n), _INF, dtype=torch.float32,
                    device=query.device)
    d2 = torch.full((*lead, n), _INF, dtype=torch.float32,
                    device=query.device)
    if lead:
        for i in range(lead[0]):
            for out, r in zip((idx, d1, d2), knn2_l1_plain(query[i],
                                                            train[i])):
                out[i] = r
        return idx, d1, d2
    if m == 0:
        return idx, d1, d2
    cols = torch.arange(m, device=query.device)
    for s in range(0, n, _QUERY_CHUNK):
        q = query[s:s + _QUERY_CHUNK]
        dist = torch.zeros((q.shape[0], m), dtype=torch.float32,
                           device=query.device)
        for k in range(d):  # fixed summation order, as the kernel's
            dist = dist + (q[:, k, None] - train[None, :, k]).abs()
        m1 = dist.min(dim=1).values
        a1 = torch.where(dist == m1[:, None], cols, m).min(dim=1).values
        idx[s:s + _QUERY_CHUNK] = a1.to(torch.int32)
        d1[s:s + _QUERY_CHUNK] = m1
        d2[s:s + _QUERY_CHUNK] = torch.where(
            cols == a1[:, None], _INF, dist).min(dim=1).values
    return idx, d1, d2


def knn2_l1_cuda(query: torch.Tensor, train: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: per query row, the best train index and the best and
    second-best L1 distances, of one pair or of G pairs in one launch.
    CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check_args(query, train)
    if query.device.type == "cpu":
        return knn2_l1_plain(query, train)
    if query.device.type != "cuda":
        raise ValueError(f"knn2_l1_cuda: unsupported device {query.device}")
    if query.shape[-1] != 128:
        raise ValueError(f"K4 kernel takes D = 128, got {query.shape[-1]}")
    # the kernel copies rows in 16-byte chunks (cp.async): they must
    # start 16-byte aligned, as a fresh allocation does; a pair's rows
    # then are too (pair strides of N and M rows of 512 bytes)
    query, train = query.contiguous(), train.contiguous()
    if query.data_ptr() % 16:
        query = query.clone()
    if train.data_ptr() % 16:
        train = train.clone()
    lead = query.shape[:-2]
    g = query.shape[0] if lead else 1
    n, m = query.shape[-2], train.shape[-2]
    dev = query.device
    idx = torch.empty((*lead, n), dtype=torch.int32, device=dev)
    d1 = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    d2 = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    if g == 0:
        return idx, d1, d2
    p, span = launch_plan(n, m, g, dev)
    # one scratch allocation: the (P, G, N) partial d1, d2 and, as
    # int32, indices
    part = torch.empty((3, p, g, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().sift_knn2_l1(
            query.data_ptr(), train.data_ptr(), g, n, m, 128, p, span,
            part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
            idx.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_knn2_l1")
    knn2_l1_cuda.launches += 1
    return idx, d1, d2


knn2_l1_cuda.launches = 0
