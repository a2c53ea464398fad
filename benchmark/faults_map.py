"""The mapping cell's controls: changes to the program's back end that
have to make `correct` come out false in every run. Each replaces the
program's fixed-order segment sum (sift_tpu_torch.ops.segsum
.segment_sum, which sfm/ba.py and sfm/posegraph.py call) for the length
of a `with` block; the port's files are not touched. The CPU tests plant
them at a small size (benchmark/tests/test_bench_mapping.py), and
calibrate_map.py at the cell's own size on the card, for the readings
that set the gap limits' upper ends.

- `sums_unordered`: the sums in no fixed order, as the program summed
  before its fixed-order kernel: index_add_ on the card, which adds with
  atomics; on the CPU, where index_add_ is sequential, index_add_ over
  the rows in a random order drawn anew each call.
- `sums_bf16`: each segment sum rounded to bfloat16, the nearest
  precision below the configuration's float32.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

SEGSUM = "sift_tpu_torch.ops.segsum"


def _unordered(fn):
    gen = torch.Generator().manual_seed(0)

    def wrapped(out, plan, x):
        if out.device.type == "cuda":
            return out.index_add_(0, plan.index, x)
        order = torch.randperm(x.shape[0], generator=gen)
        return out.index_add_(0, plan.index[order], x[order])
    return wrapped


def _bf16(fn):
    def wrapped(out, plan, x):
        got = fn(out, plan, x)
        return got.copy_(got.to(torch.bfloat16).to(torch.float32))
    return wrapped


# name: (module of the port, function, wrapper)
CONTROLS = {
    "sums_unordered": (SEGSUM, "segment_sum", _unordered),
    "sums_bf16": (SEGSUM, "segment_sum", _bf16),
}


@contextlib.contextmanager
def planted(name: str):
    """The port with control `name` planted, inside the block."""
    modname, attr, wrap = CONTROLS[name]
    mod = importlib.import_module(modname)
    orig = getattr(mod, attr)
    planted_fn = wrap(orig)
    # the program counts its launches on the function's module name
    planted_fn.launches = getattr(orig, "launches", 0)
    setattr(mod, attr, planted_fn)
    try:
        yield
    finally:
        setattr(mod, attr, orig)
