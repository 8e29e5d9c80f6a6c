"""ctypes binding for the repository's native threaded feature loader.

`load_feature_batch(paths, dim)` fills a (N, dim) float32 batch from
.npz/.npy feature files with the C++ thread pool of
`native/feature_loader.cpp`, loading the same `native/libia2p_loader.so`
the JAX package loads (built with `make -C native`). This shim neither
copies nor builds the C++: when the library is absent it reads the files
with numpy. Missing or unreadable files become zero rows.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libia2p_loader.so")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(LIB_PATH):
        return None
    lib = ctypes.CDLL(LIB_PATH)
    lib.ia2p_load_features.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
    ]
    lib.ia2p_load_features.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def load_numpy(paths: Sequence[str], dim: int, entry: str = "state") -> np.ndarray:
    """The numpy path: each file's `entry` flattened, cut or zero-padded to
    `dim`; zero rows for files that cannot be read."""
    out = np.zeros((len(paths), dim), np.float32)
    for i, p in enumerate(paths):
        try:
            x = np.load(p) if p.endswith(".npy") else np.load(p)[entry]
        except (OSError, KeyError, ValueError):
            continue  # zero row: missing media
        x = np.asarray(x, np.float32).reshape(-1)[:dim]
        out[i, : len(x)] = x
    return out


def load_feature_batch(paths: Sequence[str], dim: int, entry: str = "state",
                       n_threads: int = 8) -> np.ndarray:
    """→ (len(paths), dim) float32; zero rows for unreadable files."""
    lib = _get_lib()
    if lib is None:
        return load_numpy(paths, dim, entry)
    n = len(paths)
    out = np.zeros((n, dim), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ia2p_load_features(arr, n, entry.encode(),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dim, n_threads)
    return out
