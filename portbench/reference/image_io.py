"""Image file IO + the pipeline's 1024² center-crop loader.

`resize_and_crop` reproduces the resize-shorter-side-then-center-crop
of reference pipeline.py:41-88 / `loas_base_img` pipeline.py:289-293
(whose misspelling we do not carry over). PIL is used when present;
otherwise a raw-numpy PPM/NPY fallback keeps the path importable in
minimal environments.
"""

from __future__ import annotations

import numpy as np


def load_image(path) -> np.ndarray:
    """→ (H, W, 3) uint8."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        if str(path).endswith(".npy"):
            return np.load(path)
        raise


def _bilinear_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pure-numpy bilinear resize (align_corners=False / half-pixel
    centers). Host-side preprocessing — kept off the accelerator."""
    src = np.asarray(img, np.float32)
    sh, sw = src.shape[:2]
    ys = (np.arange(h) + 0.5) * sh / h - 0.5
    xs = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, sw - 1)
    y1 = np.clip(y0 + 1, 0, sh - 1)
    x1 = np.clip(x0 + 1, 0, sw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = src[y0][:, x0]
    b = src[y0][:, x1]
    c = src[y1][:, x0]
    d = src[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy


def resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Resize shorter side to `size`, center crop to size×size."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    img = _bilinear_resize(img, nh, nw)
    top = (nh - size) // 2
    left = (nw - size) // 2
    return img[top : top + size, left : left + size]


def resize_and_crop(path_or_array, size: int = 1024) -> np.ndarray:
    """1024² center-crop loader → float32 (H, W, 3) in [0, 255]."""
    img = (
        load_image(path_or_array)
        if isinstance(path_or_array, (str, bytes))
        else np.asarray(path_or_array)
    )
    return resize_center_crop(img, size)


def to_model_range(img: np.ndarray) -> np.ndarray:
    """uint8/[0,255] → [-1, 1] float32."""
    return np.asarray(img, np.float32) / 127.5 - 1.0


def from_model_range(x) -> np.ndarray:
    """[-1, 1] → uint8."""
    arr = np.asarray(x, np.float32)
    return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
