"""Stage timing and profiler hook (twin of sift_tpu/utils/profiling.py).

Named, accumulating wall-clock stage timers. PyTorch returns before the
card finishes, so a stage that hands its outputs to `sink` ends with a
synchronisation of the CUDA devices those tensors live on; CPU tensors
need none. `torch_trace` wraps torch.profiler for a full trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def sync(tree) -> None:
    """Wait for the work behind every CUDA tensor in `tree` (one
    torch.cuda.synchronize per device); a no-op for CPU tensors."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating named stage timer.

    with timer.stage("pyramid"):       # times the enclosed block
        out = build(...)
        timer.sink(out)                # waits for out's device work
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, List[float]] = {}
        self._sink = None

    def sink(self, tree) -> None:
        self._sink = tree

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        self._sink = None
        t0 = time.perf_counter()
        yield self
        if self._sink is not None:
            sync(self._sink)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        """Median seconds per stage."""
        return {k: float(np.median(v)) for k, v in self.times.items()}

    def report(self) -> str:
        lines = [f"{k:>24s}: {v * 1e3:9.3f} ms"
                 for k, v in self.summary().items()]
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """torch.profiler trace of CPU and (when present) CUDA activity,
    written as a Chrome trace under log_dir; a no-op when log_dir is
    None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
