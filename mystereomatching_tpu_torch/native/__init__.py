"""Host runtime of the NL path: the 3x3 median prefilter and the grid MST.

Counterpart of ``mystereomatching_tpu/native`` (its ``median3x3`` and
``mst_grid``), with this package's own copy of the C++ source,
``nl_runtime.cpp``. At first use the source is compiled with the host C++
compiler (``$CXX``, else ``c++`` on ``PATH``) into a shared library under
``build/native/`` at the repository root, keyed by a hash of the source
and the flags, and loaded with ctypes. Raises when no compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nl_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler for the NL host runtime: set CXX or put c++ on PATH")
    return cxx


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnl_runtime_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime unless a library of the same source exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}")
    res = subprocess.run([compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.msm_median3x3_u8.argtypes = [u8p, u8p] + [ctypes.c_int] * 3
        lib.msm_median3x3_u8.restype = None
        lib.msm_mst_grid_n.argtypes = [u8p] + [ctypes.c_int] * 4 + [i32p] * 3
        lib.msm_mst_grid_n.restype = None
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def median3x3(img: np.ndarray) -> np.ndarray:
    """3x3 median with a replicate border of a uint8 [H, W] or [H, W, C] image."""
    lib = _load()
    src = np.ascontiguousarray(img, np.uint8)
    ch = 1 if src.ndim == 2 else src.shape[2]
    dst = np.empty_like(src)
    lib.msm_median3x3_u8(_ptr(src, ctypes.c_uint8), _ptr(dst, ctypes.c_uint8),
                         src.shape[0], src.shape[1], ch)
    return dst


def mst_grid(image: np.ndarray, neighbors: int = 4
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rooted minimum spanning tree of the 4- or 8-neighbour grid of a uint8
    [H, W] or [H, W, C] image: (parent, weight, BFS order), int32 [H*W]
    each, node 0 the root and its own parent."""
    if neighbors not in (4, 8):
        raise ValueError(f"mst_grid: neighbors must be 4 or 8, got {neighbors}")
    lib = _load()
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    n = h * w
    parent, weight, order = (np.empty(n, np.int32) for _ in range(3))
    lib.msm_mst_grid_n(_ptr(img, ctypes.c_uint8), h, w, ch, neighbors,
                       _ptr(parent, ctypes.c_int32), _ptr(weight, ctypes.c_int32),
                       _ptr(order, ctypes.c_int32))
    return parent, weight, order
