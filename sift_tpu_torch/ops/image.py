"""Image ingest ops (reference src/main.cpp:79-87).

The reference calls cvtColor(..., COLOR_RGB2GRAY) on BGR data, so the
R and B luma weights are swapped; the swapped conversion is reproduced
with OpenCV's 14-bit fixed-point rounding because it shifts every gray
value and so every threshold decision downstream.
"""

from __future__ import annotations

import torch

# OpenCV fixed-point luma weights, yuv_shift = 14
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_SHIFT = 14


def bgr_to_gray_swapped_u8(img_bgr_u8: torch.Tensor) -> torch.Tensor:
    """cvtColor(bgr, COLOR_RGB2GRAY) twin on uint8 (..., 3) BGR input:
    channel 0 (B) takes the R weight. Returns float32 gray in 0..255."""
    b = img_bgr_u8[..., 0].to(torch.int32)
    g = img_bgr_u8[..., 1].to(torch.int32)
    r = img_bgr_u8[..., 2].to(torch.int32)
    y = (b * _R2Y + g * _G2Y + r * _B2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.to(torch.float32)


def rgb_to_gray_swapped_u8(img_rgb_u8: torch.Tensor) -> torch.Tensor:
    """Same conversion for RGB-ordered input (e.g. loaded via PIL)."""
    return bgr_to_gray_swapped_u8(img_rgb_u8.flip(-1))


def downsample_nearest_2x(img: torch.Tensor) -> torch.Tensor:
    """cv::resize INTER_NEAREST to (cols/2, rows/2) (src/sift.cpp:254):
    dst(y, x) = src(2y, 2x)."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    return img[..., 0:2 * h2:2, 0:2 * w2:2]
