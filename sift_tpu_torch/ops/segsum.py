"""Segment sums in a fixed order: `index_add_` whose rounding is the
same on every run and on every device.

    plan = make_plan(index, n_segments)     # once per index vector
    segment_sum(out, plan, x)               # out.index_add_(0, index, x)

`segment_sum` adds the rows of x into out's rows, `out[index[i]] +=
x[i]`, in ascending i, starting from out's value: index_add_'s meaning
and the order of a sequential loop, which is how index_add_ adds on the
CPU. It reaches that result two ways, bit for bit the same:
- on the card, one launch of csrc/segsum.cu, which reads each segment's
  rows in the plan's order and rounds every add on its own;
- on the CPU, `index_add_` itself (the plain version).

On the card index_add_ adds with atomics in no fixed order, so its
float sums round differently from run to run; the SfM back end's
accept/reject decisions then turn those ULPs into different maps. The
back end's float scatter-adds (sfm/ba.py, sfm/posegraph.py) go through
here.

A plan holds the index, and on the card the stable sort of it: the
source rows of each segment in ascending order (`perm`, int32) and
where each segment starts in perm (`offsets`, S + 1 int32). Making one
takes a few launches and no host synchronisation; indices must lie in
[0, n_segments), which the card's path does not check.

A plan may leave rows out (`valid`): the card then never reads them.
The BA's observation table is padded to a power of two with masked
rows at index 0, up to half the table, which would otherwise make one
segment a chain of thousands of adds of zero. Where the rows left out
are zeros (of either sign) and out holds no -0.0, as in a sum that
starts from zeros, leaving them out changes no bit: x + 0 is x for
every x but -0.0. The CPU's index_add_ adds every row.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from sift_tpu_torch import _build
from sift_tpu_torch.ops.extrema_cuda import _check_device


class Plan(NamedTuple):
    """The order of one index vector's segment sums."""
    index: torch.Tensor              # (O,) int64, as index_add_ takes it
    n_segments: int
    valid: Optional[torch.Tensor]    # (O,) bool rows summed; None: all
    perm: Optional[torch.Tensor]     # (O,) int32 source rows; card only
    offsets: Optional[torch.Tensor]  # (S + 1,) int32; card only


def make_plan(index: torch.Tensor, n_segments: int,
              valid: Optional[torch.Tensor] = None) -> Plan:
    """The plan of `index` (O,) over `n_segments` output rows, without
    the rows where `valid` (O,) is False; on the card its stable sort,
    on the CPU the index alone."""
    index = index.reshape(-1).long()
    if valid is not None:
        valid = valid.reshape(-1)
    if _check_device(index, "make_plan"):
        return Plan(index, int(n_segments), valid, None, None)
    return Plan(index, int(n_segments), valid,
                *order(index, n_segments, valid))


def order(index: torch.Tensor, n_segments: int,
          valid: Optional[torch.Tensor] = None):
    """(perm, offsets) of `index`: the source rows sorted by segment,
    ascending within one (a stable sort), and the start of each segment
    in that order, S + 1 entries, as int32. Rows where `valid` is False
    sort past the last segment, where no segment reads them."""
    key = index if valid is None else torch.where(valid, index, n_segments)
    sorted_idx, perm = torch.sort(key, stable=True)
    bounds = torch.arange(n_segments + 1, dtype=sorted_idx.dtype,
                          device=index.device)
    offsets = torch.searchsorted(sorted_idx, bounds)
    return perm.to(torch.int32), offsets.to(torch.int32)


def _check_args(out: torch.Tensor, plan: Plan, x: torch.Tensor) -> None:
    if out.shape[0] != plan.n_segments:
        raise ValueError(f"segment_sum: out has {out.shape[0]} rows, the "
                         f"plan {plan.n_segments} segments")
    if x.shape[0] != plan.index.shape[0] or x.shape[1:] != out.shape[1:]:
        raise ValueError(f"segment_sum: x {tuple(x.shape)} does not fit out "
                         f"{tuple(out.shape)} and {plan.index.shape[0]} "
                         "indices")
    if out.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("segment_sum: float32 tensors only")
    if not out.is_contiguous():
        raise ValueError("segment_sum: out must be contiguous")


def segment_sum(out: torch.Tensor, plan: Plan, x: torch.Tensor
                ) -> torch.Tensor:
    """out.index_add_(0, plan.index, x) in the fixed order; out (S, ...)
    contiguous and x (O, ...) float32 with the same trailing shape.
    Returns out, updated in place."""
    _check_args(out, plan, x)
    if _check_device(out, "segment_sum"):
        return out.index_add_(0, plan.index, x)
    if plan.perm is None:
        raise ValueError("segment_sum: a CUDA tensor needs a plan made on "
                         "the card")
    width = math.prod(out.shape[1:])
    if width == 0 or plan.n_segments == 0:
        return out
    src = x.contiguous()
    with torch.cuda.device(out.device):
        err = _build.library().sift_segsum(
            out.data_ptr(), src.data_ptr(), plan.perm.data_ptr(),
            plan.offsets.data_ptr(), plan.index.shape[0], plan.n_segments,
            width,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sift_segsum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
