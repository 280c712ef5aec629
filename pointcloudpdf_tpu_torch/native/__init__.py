# Copied from pointcloudpdf_tpu/native/__init__.py (build lands in the port's _build/); keep in step.
"""Native (C++) host-side runtime components, loaded via ctypes.

The device path is PyTorch and CUDA; these natives replace the
reference's host-side hot loops (the GridSample voxel dedup,
transform.py:788-925).  Built on first use with g++ -O3 from the source
beside this file into ``pointcloudpdf_tpu_torch/_build/``, without
``-march=native`` and under a name that holds a hash of the source, so
that a build copied to another host is safe to load; every entry
point has a numpy branch with the same result, so the data path works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SRC = os.path.join(_HERE, "csrc", "voxel_hash.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC")   # portable code: the build may travel


def _so_path() -> str:
    # Named after the source and the flags, as ops/_cuda.library_path names
    # the kernels' library: a build of another source is never loaded.
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD, f"_voxel_hash_{digest.hexdigest()[:16]}.so")


_SO_PATH = _so_path()
_lock = threading.Lock()
_lib = None
_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if not os.path.isfile(_SO_PATH):
                os.makedirs(_BUILD, exist_ok=True)
                tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", *_FLAGS, _SRC, "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _SO_PATH)
            lib = ctypes.CDLL(_SO_PATH)
            lib.voxel_unique.restype = ctypes.c_int64
            lib.voxel_unique.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.fnv_hash_rows.restype = None
            lib.fnv_hash_rows.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def fnv_hash(grid: np.ndarray) -> Optional[np.ndarray]:
    """(N, 3) int voxel coords -> (N,) uint64 FNV-1a keys (or None)."""
    lib = _load()
    if lib is None:
        return None
    grid = np.ascontiguousarray(grid, np.int32)
    out = np.empty(len(grid), np.uint64)
    lib.fnv_hash_rows(_ptr(grid, ctypes.c_int32), len(grid),
                      _ptr(out, ctypes.c_uint64))
    return out


def voxel_unique(keys: np.ndarray
                 ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]]:
    """O(N) hash dedup: (order, inverse, counts, starts).

    ``order`` groups point indices by voxel (CSR via ``starts``);
    ``inverse`` maps each point to its voxel id (first-occurrence order);
    ``counts`` has one entry per voxel.  Returns None without the native.
    """
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    n = len(keys)
    inverse = np.empty(n, np.int64)
    counts = np.zeros(n, np.int64)
    order = np.empty(n, np.int64)
    starts = np.empty(n + 1, np.int64)
    num = lib.voxel_unique(
        _ptr(keys, ctypes.c_uint64), n, _ptr(inverse, ctypes.c_int64),
        _ptr(counts, ctypes.c_int64), _ptr(order, ctypes.c_int64),
        _ptr(starts, ctypes.c_int64),
    )
    return order, inverse, counts[:num], starts[: num + 1]
