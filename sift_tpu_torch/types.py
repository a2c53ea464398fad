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
    """Padded keypoint batch. All fields are (N,) tensors.

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
        return self.x.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    @staticmethod
    def zeros(n: int, device: torch.device | str = "cpu") -> "Keypoints":
        f = torch.zeros((n,), dtype=torch.float32, device=device)
        i = torch.zeros((n,), dtype=torch.int32, device=device)
        return Keypoints(x=f, y=f, size=f, angle=f, response=f,
                         octave=i, layer=i, r=i, c=i,
                         valid=torch.zeros((n,), dtype=torch.bool,
                                           device=device))

    def gather(self, idx: torch.Tensor) -> "Keypoints":
        return Keypoints(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})

    @staticmethod
    def concatenate(parts: Sequence["Keypoints"]) -> "Keypoints":
        return Keypoints(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(Keypoints)})
