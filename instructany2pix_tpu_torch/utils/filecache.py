"""mtime-keyed LRU cache for decoded and preprocessed media files,
counterpart of the JAX package's `utils/filecache.py`.

Each request pays a PNG decode and a resize per media file, and again for
the base image: host work in front of the card's stages. Edits re-reference
the same files (the same base image across a user's edits), so a small
cache removes that work on repeats, while keying on the file's mtime and
size keeps overwritten files fresh. `IA2P_MEDIA_CACHE=0` turns it off and
`IA2P_MEDIA_CACHE_N` sets its size (32), as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable


class FileCache:
    """LRU over (abspath, mtime_ns, size, tag) → computed value."""

    def __init__(self, max_items: int = 32):
        self.max_items = max_items
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, path: str, tag: Hashable, compute: Callable[[], Any]) -> Any:
        try:
            st = os.stat(path)
            key = (os.path.abspath(path), st.st_mtime_ns, st.st_size, tag)
        except OSError:
            return compute()  # not a file: not cached
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
        val = compute()
        with self._lock:
            self._d[key] = val
            self._d.move_to_end(key)
            self.misses += 1
            while len(self._d) > self.max_items:
                self._d.popitem(last=False)
        return val

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


# process-wide cache shared by the pipeline and the batched server
MEDIA_CACHE = FileCache(max_items=int(os.environ.get("IA2P_MEDIA_CACHE_N", "32")))


def cached(path: str, tag: Hashable, compute: Callable[[], Any]) -> Any:
    if os.environ.get("IA2P_MEDIA_CACHE", "1") == "0":
        return compute()
    return MEDIA_CACHE.get(path, tag, compute)
