"""End-to-end object-detection pipeline (reference C1).

Twin of the reference demo (src/main.cpp:10-72) and of
sift_tpu/pipeline.py: SIFT on scene and object, kNN-match
object -> scene with ratio 0.86, RANSAC homography, object corners
projected into the scene. Everything runs on the device of the input
tensors; CPU tensors take the plain PyTorch version of every kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch import sift
from sift_tpu_torch.ops import match as match_mod
from sift_tpu_torch.geometry import (find_homography_ransac,
                                     perspective_transform)


class ObjectDetection(NamedTuple):
    """Everything the reference demo computes."""
    scene_kp: Keypoints
    object_kp: Keypoints
    scene_desc: torch.Tensor
    object_desc: torch.Tensor
    matches: match_mod.Matches
    H: torch.Tensor              # (3, 3) object -> scene
    inliers: torch.Tensor        # (N,) over match slots
    n_inliers: torch.Tensor
    found: torch.Tensor          # () bool
    corners: torch.Tensor        # (4, 2) object corners in scene coords


def detect_object(scene_gray, object_gray,
                  cfg: SIFTConfig = DEFAULT_CONFIG) -> ObjectDetection:
    """Full demo flow on two grayscale images (values 0..255), given as
    (H, W) tensors (both on one device) or NumPy arrays (run on the CPU).

    Object plays the kNN query role (descriptors1), scene the train
    role (descriptors0), as in main() (src/main.cpp:10-72).
    """
    scene = torch.as_tensor(scene_gray, dtype=torch.float32)
    obj = torch.as_tensor(object_gray, dtype=torch.float32)
    if scene.device != obj.device:
        raise ValueError(f"scene on {scene.device}, object on {obj.device}")
    kps, ds = sift.detect_and_compute(scene, cfg)
    kpo, do = sift.detect_and_compute(obj, cfg)
    m = match_mod.match_ratio(do, ds, q_valid=kpo.valid, t_valid=kps.valid,
                              ratio=cfg.match_ratio)
    tidx = m.train_idx.long()
    src = torch.stack([kpo.x, kpo.y], dim=1)
    dst = torch.stack([kps.x[tidx], kps.y[tidx]], dim=1)
    hres = find_homography_ransac(src, dst, valid=m.good)
    h, w = obj.shape
    corners = torch.tensor([[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]],
                           dtype=torch.float32,
                           device=obj.device)          # src/main.cpp:58-60
    return ObjectDetection(
        scene_kp=kps, object_kp=kpo, scene_desc=ds, object_desc=do,
        matches=m, H=hres.H, inliers=hres.inliers,
        n_inliers=hres.n_inliers, found=hres.ok,
        corners=perspective_transform(corners, hres.H))
