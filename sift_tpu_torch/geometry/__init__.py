"""Geometric verification: RANSAC homography + perspective transform
(reference C12, src/main.cpp:44-68)."""

from sift_tpu_torch.geometry.homography import (
    find_homography_ransac, perspective_transform, HomographyResult)

__all__ = ["find_homography_ransac", "perspective_transform",
           "HomographyResult"]
