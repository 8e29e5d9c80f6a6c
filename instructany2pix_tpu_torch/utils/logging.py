"""Training metrics: `MetricLogger` prints one JSON line per logged step
and appends it to a file, and dumps image grids as PNGs;
`embedding_heatmap` renders a codec embedding as an image for the
generation preview. Counterpart of the JAX package's `utils/logging.py`
without its optional wandb mirror.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from ..codecs.image_io import save_image


class MetricLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        line = json.dumps({"step": step, "t": round(time.time() - self._t0, 2), **metrics})
        print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def dump_images(self, step: int, images, out_dir: str = "train_images") -> str:
        """Tile (N, H, W, 3) uint8 frames into one grid PNG; returns its path."""
        os.makedirs(out_dir, exist_ok=True)
        arr = np.asarray(images)
        n, h, w, c = arr.shape
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        grid = np.zeros((rows * h, cols * w, c), arr.dtype)
        for i in range(n):
            r, cc = divmod(i, cols)
            grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = arr[i]
        path = os.path.join(out_dir, f"step_{step}.png")
        save_image(path, grid)
        return path


def embedding_heatmap(vec, size: int = 128) -> np.ndarray:
    """An embedding vector as a (size, size, 3) uint8 heatmap: padded to a
    square, min-max scaled, nearest-upsampled, blue (low) to red (high)."""
    v = np.asarray(vec, np.float32).reshape(-1)
    side = int(np.ceil(np.sqrt(v.size)))
    pad = np.zeros(side * side, np.float32)
    pad[: v.size] = v
    img = pad.reshape(side, side)
    lo, hi = img.min(), img.max()
    img = (img - lo) / (hi - lo + 1e-8)
    rep = max(1, size // side)
    img = np.repeat(np.repeat(img, rep, 0), rep, 1)
    u8 = (img * 255).astype(np.uint8)
    return np.stack([u8, np.full_like(u8, 48), 255 - u8], axis=-1)
