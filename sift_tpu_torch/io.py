"""Host-side image ingest (reference src/main.cpp:79-87).

Decoding happens on the host with cv2 when present, else PIL; the
optional 960x960 scene resize and the reference's swapped gray
conversion run in NumPy. Mirror of sift_tpu/io.py.
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


def _resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int
                        ) -> np.ndarray:
    """cv::resize INTER_LINEAR with half-pixel centers."""
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
        fy = np.clip(yy - y0, 0, 1)[:, None, None]
        fx = np.clip(xx - x0, 0, 1)[None, :, None]
        a = img[y0][:, x0].astype(np.float64)
        b = img[y0][:, x1].astype(np.float64)
        c = img[y1][:, x0].astype(np.float64)
        d = img[y1][:, x1].astype(np.float64)
        out = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
               + c * fy * (1 - fx) + d * fy * fx)
        return np.clip(np.rint(out), 0, 255).astype(img.dtype)
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
        bgr = _resize_bilinear_np(bgr, 960, 960)
    return _gray_swapped_np(bgr)
