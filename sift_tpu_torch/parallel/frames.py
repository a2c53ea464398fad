"""Data-parallel SIFT front end: a batch of frames split over the ranks
(twin of sift_tpu/parallel/frames.py, its "batch" mode).

Frames are the batch dimension, split over the mesh's first axis: each
rank runs sift.detect_and_compute_batch on its B / n frames (K1-batch,
the compact scan and select, K3-ori and K3-desc on its card), with no
communication until one all_gather at the end gives every rank the
whole batch, as a JAX caller reads the sharded result.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sift_tpu_torch import sift
from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.parallel.mesh import Mesh, all_gather, axis_index, \
    axis_size
from sift_tpu_torch.types import Keypoints


def gather_keypoints(kp: Keypoints, mesh: Mesh) -> Keypoints:
    """Each field all_gathered along its first axis, in rank order."""
    return Keypoints(**{f.name: all_gather(getattr(kp, f.name), mesh)
                        for f in dataclasses.fields(kp)})


def batched_detect_and_compute(imgs: torch.Tensor, mesh: Mesh,
                               cfg: SIFTConfig = DEFAULT_CONFIG
                               ) -> Tuple[Keypoints, torch.Tensor]:
    """(B, H, W) frames, the same on every rank -> (Keypoints with
    (B, N) fields, (B, N, 128) descriptors) on every rank; row b equals
    detect_and_compute_batch's row b. B must be divisible by the mesh's
    first axis."""
    n = axis_size(mesh)
    b = imgs.shape[0]
    if b % n:
        raise ValueError(f"{b} frames do not split over {n} ranks")
    per = b // n
    start = axis_index(mesh) * per
    local = imgs[start:start + per].to(mesh.device)
    kp, desc = sift.detect_and_compute_batch(local, cfg)
    return gather_keypoints(kp, mesh), all_gather(desc, mesh)
