"""Host-side image ingest (reference src/main.cpp:79-87).

Decoding happens on the host with cv2 when present, else PIL; the
optional 960x960 scene resize and the reference's swapped gray
conversion run in NumPy. Mirror of sift_tpu/io.py, plus the plain gray
read (read_gray_u8) of the mapping path's frames and textures.
"""

from __future__ import annotations

import numpy as np


def _decode_bgr(path: str) -> np.ndarray:
    """Read an image file as uint8 BGR (cv::imread semantics)."""
    try:
        import cv2
    except ImportError:
        from PIL import Image
        rgb = np.asarray(Image.open(path).convert("RGB"))
        return rgb[..., ::-1]
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cv2 failed to read {path}")
    return img


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv::resize INTER_LINEAR with half-pixel centers, of an (H, W) or
    (H, W, C) image; integer images come back rounded, in their dtype."""
    try:
        import cv2
    except ImportError:
        h, w = img.shape[:2]
        yy = (np.arange(out_h) + 0.5) * h / out_h - 0.5
        xx = (np.arange(out_w) + 0.5) * w / out_w - 0.5
        y0 = np.clip(np.floor(yy).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xx).astype(int), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        extra = (None,) * (img.ndim - 2)
        fy = np.clip(yy - y0, 0, 1)[(slice(None), None) + extra]
        fx = np.clip(xx - x0, 0, 1)[(None, slice(None)) + extra]
        a = img[y0][:, x0].astype(np.float64)
        b = img[y0][:, x1].astype(np.float64)
        c = img[y1][:, x0].astype(np.float64)
        d = img[y1][:, x1].astype(np.float64)
        out = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
               + c * fy * (1 - fx) + d * fy * fx)
        if np.issubdtype(img.dtype, np.integer):
            return np.clip(np.rint(out), 0, 255).astype(img.dtype)
        return out.astype(img.dtype)
    return cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)


def _gray_swapped_np(bgr_u8: np.ndarray) -> np.ndarray:
    """NumPy twin of ops.image.bgr_to_gray_swapped_u8."""
    b = bgr_u8[..., 0].astype(np.int64)
    g = bgr_u8[..., 1].astype(np.int64)
    r = bgr_u8[..., 2].astype(np.int64)
    y = (b * 4899 + g * 9617 + r * 1868 + (1 << 13)) >> 14
    return y.astype(np.float32)


def read_image(path: str, resized: bool = False) -> np.ndarray:
    """Twin of readImage (src/main.cpp:79-87): decode, optionally
    resize to 960x960 (scene only), swapped gray, float32 0..255."""
    bgr = _decode_bgr(path)
    if resized:
        bgr = resize_bilinear(bgr, 960, 960)
    return _gray_swapped_np(bgr)


def read_gray_u8(path: str) -> np.ndarray:
    """(H, W) uint8 gray with cv::COLOR_BGR2GRAY's fixed-point weights
    (the usual channel order, unlike the reference's swapped ingest):
    how cv2.imread(path, IMREAD_GRAYSCALE) reads a PNG."""
    bgr = _decode_bgr(path).astype(np.int64)
    y = (bgr[..., 2] * 4899 + bgr[..., 1] * 9617 + bgr[..., 0] * 1868
         + (1 << 13)) >> 14
    return y.astype(np.uint8)
