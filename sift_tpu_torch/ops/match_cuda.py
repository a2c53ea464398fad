"""K4 wrapper: brute-force top-2 L1 matcher.

Counterpart of sift_tpu/ops/match_pallas.py. `knn2_l1_cuda` launches
the CUDA kernel (csrc/knn2.cu) for CUDA tensors and runs
`knn2_l1_plain` for CPU tensors. Both sum |q - t| over the 128 dims in
order 0..127, so their distances are bit-identical, and both break
ties to the lowest train index: a min, then the lowest index at that
min, then the min with that column excluded (match_pallas.py:67-70).
Invalid train rows arrive pre-masked (ops.match.mask_train).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sift_tpu_torch import _build

_INF = 3.0e38          # "no second neighbour", as match_pallas._INF
_QUERY_CHUNK = 256     # bounds the plain version's (chunk, M) temporaries


def _check_args(query: torch.Tensor, train: torch.Tensor) -> None:
    if (query.dtype != torch.float32 or train.dtype != torch.float32
            or query.dim() != 2 or train.dim() != 2
            or query.shape[1] != train.shape[1]):
        raise ValueError(f"knn2 takes (N, D) and (M, D) float32, got "
                         f"{tuple(query.shape)} {query.dtype}, "
                         f"{tuple(train.shape)} {train.dtype}")
    if query.device != train.device:
        raise ValueError(f"query on {query.device}, train on {train.device}")


def knn2_l1_plain(query: torch.Tensor, train: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: (N, D) x (M, D) -> (idx int32, d1, d2), each (N,)."""
    _check_args(query, train)
    n, d = query.shape
    m = train.shape[0]
    idx = torch.zeros((n,), dtype=torch.int32, device=query.device)
    d1 = torch.full((n,), _INF, dtype=torch.float32, device=query.device)
    d2 = torch.full((n,), _INF, dtype=torch.float32, device=query.device)
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
    second-best L1 distances. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check_args(query, train)
    if query.device.type == "cpu":
        return knn2_l1_plain(query, train)
    if query.device.type != "cuda":
        raise ValueError(f"knn2_l1_cuda: unsupported device {query.device}")
    if query.shape[1] != 128:
        raise ValueError(f"K4 kernel takes D = 128, got {query.shape[1]}")
    query = query.contiguous()
    train = train.contiguous()
    n, m = query.shape[0], train.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=query.device)
    d1 = torch.empty((n,), dtype=torch.float32, device=query.device)
    d2 = torch.empty((n,), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = _build.library().sift_knn2_l1(
            query.data_ptr(), train.data_ptr(), n, m, 128, idx.data_ptr(),
            d1.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_knn2_l1")
    knn2_l1_cuda.launches += 1
    return idx, d1, d2


knn2_l1_cuda.launches = 0
