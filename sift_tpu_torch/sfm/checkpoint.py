"""Checkpoint/resume for SfM state (twin of sift_tpu/sfm/checkpoint.py,
npz only).

A BA problem snapshot is one .npz with sift_tpu's layout -- the seven
`_FIELDS` of BAProblem (indices as int32) plus `step` -- and a `.step`
sidecar holding the step, so a checkpoint moves between the packages:
sift_tpu's load_ba reads what save_ba writes, and load_ba here reads
sift_tpu's npz snapshots. sift_tpu's orbax snapshots (directories ending
in .orbax) are not readable here: there is no orbax on the card's
machine.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sift_tpu_torch.sfm.ba import BAProblem
from sift_tpu_torch.sfm.incremental import resolve_device

_FIELDS = ("cameras", "points", "cam_idx", "pt_idx", "uv", "mask",
           "fixed_cams")
# sift_tpu stores the observation indices as int32; BAProblem holds int64
_NPZ_DTYPES = {"cam_idx": np.int32, "pt_idx": np.int32}


def save_ba_step(dirpath: str, prob: BAProblem, step: int) -> str:
    """Save under the canonical `ba_<step>` name `latest()` orders by."""
    return save_ba(os.path.join(dirpath, f"ba_{step:08d}"), prob, step)


def save_ba(path: str, prob: BAProblem, step: int = 0) -> str:
    """Save a BA problem snapshot to `path`.npz; returns the written
    path. A `.step` sidecar beside it lets latest() order snapshots
    without reading them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f: getattr(prob, f).detach().cpu().numpy() for f in _FIELDS}
    for f, dt in _NPZ_DTYPES.items():
        arrays[f] = arrays[f].astype(dt)
    arrays["step"] = np.asarray(step)
    written = path + ".npz"
    np.savez(written, **arrays)
    with open(written + ".step", "w") as f:
        f.write(str(int(step)))
    return written


def load_ba(path: str, device=None) -> tuple[BAProblem, int]:
    """Load a snapshot written by save_ba (either package's npz) onto
    `device` (CUDA unless given, as the rest of the SfM path); returns
    (problem, step)."""
    if path.endswith(".orbax") or os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint; sift_tpu_torch "
                         f"reads npz checkpoints only (save with orbax "
                         f"absent, or convert to npz)")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    step = int(arrays.pop("step"))
    tensors = {f: torch.from_numpy(np.asarray(arrays[f])) for f in _FIELDS}
    for f in _NPZ_DTYPES:
        tensors[f] = tensors[f].long()
    dev = resolve_device(device)
    return BAProblem(**{f: t.to(dev) for f, t in tensors.items()}), step


def latest(dirpath: str, prefix: str = "ba_") -> Optional[str]:
    """Most recent checkpoint under dirpath, ordered by step: the
    `ba_<step>` name where present, else the `.step` sidecar, else the
    step inside the npz."""
    if not os.path.isdir(dirpath):
        return None
    cands = [f for f in os.listdir(dirpath)
             if f.startswith(prefix) and not f.endswith(".step")]
    if not cands:
        return None

    def step_of(name: str) -> int:
        stem = name.split(".")[0]
        try:
            return int(stem.rsplit("_", 1)[1])
        except (IndexError, ValueError):
            pass
        full = os.path.join(dirpath, name)
        try:                      # the sidecar save_ba writes
            with open(full + ".step") as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            pass
        if name.endswith(".npz"):     # the embedded step (header read)
            try:
                with np.load(full) as z:
                    return int(z["step"])
            except (OSError, ValueError, KeyError):
                pass
        return -1
    return os.path.join(dirpath, max(cands, key=step_of))
