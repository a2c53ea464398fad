"""Keypoint container.

The reference carries keypoints as std::vector<cv::KeyPoint>
(src/sift.cpp:59-91). As in sift_tpu, keypoints live in fixed-capacity
struct-of-arrays with a validity mask, so no stage needs the host to
learn a count.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Keypoints:
    """Padded keypoint batch. All fields are (N,) tensors, or (B, N) for
    the B frames of sift.detect_and_compute_batch (`frame(b)` gives
    frame b's (N,) view).

    x/y in base-image coordinates, size the full-resolution diameter,
    angle in degrees (the reference's 360-minus convention), response
    = |contrast|; octave/layer unpacked; r/c the integer extremum
    coordinates in octave space. See sift_tpu.types.Keypoints.
    """

    x: torch.Tensor
    y: torch.Tensor
    size: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor   # int32
    layer: torch.Tensor    # int32
    r: torch.Tensor        # int32, octave-space row
    c: torch.Tensor        # int32, octave-space col
    valid: torch.Tensor    # bool

    @property
    def capacity(self) -> int:
        """Slots per frame (the last axis)."""
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    @staticmethod
    def zeros(n: int, device: torch.device | str = "cpu",
              frames: tuple = ()) -> "Keypoints":
        """n invalid slots: (N,) fields, or frames + (N,), e.g. (B, N)."""
        shape = (*frames, n)
        f = torch.zeros(shape, dtype=torch.float32, device=device)
        i = torch.zeros(shape, dtype=torch.int32, device=device)
        return Keypoints(x=f, y=f, size=f, angle=f, response=f,
                         octave=i, layer=i, r=i, c=i,
                         valid=torch.zeros(shape, dtype=torch.bool,
                                           device=device))

    def frame(self, b: int) -> "Keypoints":
        """Frame b of a (B, N) batch, as an (N,) view."""
        return Keypoints(**{f.name: getattr(self, f.name)[b]
                            for f in dataclasses.fields(self)})

    def gather(self, idx: torch.Tensor) -> "Keypoints":
        """Slots idx along the last axis: (K,) of (N,) fields, or (B, K)
        of (B, N) fields, frame by frame."""
        return Keypoints(**{f.name: getattr(self, f.name).gather(-1, idx)
                            for f in dataclasses.fields(self)})

    @staticmethod
    def concatenate(parts: Sequence["Keypoints"]) -> "Keypoints":
        """Parts joined along the last (slot) axis."""
        return Keypoints(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts], dim=-1)
            for f in dataclasses.fields(Keypoints)})
