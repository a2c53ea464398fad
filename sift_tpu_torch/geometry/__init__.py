"""Geometric verification: RANSAC homography + perspective transform
(reference C12, src/main.cpp:44-68), and the multi-view geometry of the
SfM path in its own modules (lie, triangulation, fivepoint, epipolar,
pnp), exported from here as sift_tpu.geometry exports them."""

from sift_tpu_torch.geometry.homography import (
    find_homography_ransac, perspective_transform, HomographyResult)

__all__ = ["find_homography_ransac", "perspective_transform",
           "HomographyResult"]
