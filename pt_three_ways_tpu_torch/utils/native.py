"""ctypes bindings for the port's native host library (csrc/pt3native.cpp).

The counterpart of the JAX package's ``utils/native.py``, over the port's
own copy of its C++ source. The library is built with g++ at first use into
``<repo>/build/torch_native/libpt3native.so`` (again when the source is
newer), written under a temporary name and moved into place, so concurrent
processes never load half a file. Every entry point has a pure-Python
fallback that gives the same result: ``PT3_NO_NATIVE=1`` forces the
fallbacks, and they are taken when no compiler exists.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from .morton import morton_order as _morton_order_py

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pt3native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libpt3native.so")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def build() -> str:
    """Compile the library (atomically replacing any older build); returns
    its path. Raises RuntimeError when there is no compiler or it fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _stale() -> bool:
    return (not os.path.exists(LIB_PATH)
            or os.path.getmtime(SOURCE) > os.path.getmtime(LIB_PATH))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f64 = np.ctypeslib.ndpointer(np.float64)
    i32 = np.ctypeslib.ndpointer(np.int32)
    lib.pt3_obj_parse.restype = ctypes.c_void_p
    lib.pt3_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.pt3_obj_error.restype = ctypes.c_char_p
    lib.pt3_obj_error.argtypes = [ctypes.c_void_p]
    lib.pt3_obj_num_tris.restype = ctypes.c_int64
    lib.pt3_obj_num_tris.argtypes = [ctypes.c_void_p]
    lib.pt3_obj_num_mats.restype = ctypes.c_int64
    lib.pt3_obj_num_mats.argtypes = [ctypes.c_void_p]
    lib.pt3_obj_copy.argtypes = [ctypes.c_void_p, f64, i32, f64]
    lib.pt3_obj_free.argtypes = [ctypes.c_void_p]
    lib.pt3_morton_order.argtypes = [f64, ctypes.c_int64, i32]
    lib.pt3_raw_merge.restype = ctypes.c_int32
    lib.pt3_raw_merge.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                                  ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None when ``PT3_NO_NATIVE``
    is set or it cannot be built (the callers then take the Python paths)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("PT3_NO_NATIVE"):
            return None
        try:
            if _stale():
                build()
            _LIB = _bind(ctypes.CDLL(LIB_PATH))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
        return _LIB


def parse_obj_native(obj_path: str, mtl_dir: str):
    """Native OBJ/MTL parse -> (verts [n, 3, 3] f64, mat_ids [n] i32,
    mats [m, 9] f64: emission 3, diffuse 3, ior, reflectivity, cone), or
    None when the library is unavailable. Raises ValueError with the
    reference's wording on malformed input."""
    lib = load()
    if lib is None:
        return None
    handle = lib.pt3_obj_parse(obj_path.encode(), mtl_dir.encode())
    try:
        err = lib.pt3_obj_error(handle)
        if err:
            raise ValueError(err.decode())
        n = lib.pt3_obj_num_tris(handle)
        m = lib.pt3_obj_num_mats(handle)
        verts = np.empty((n, 3, 3), np.float64)
        mat_ids = np.empty((n,), np.int32)
        mats = np.empty((max(m, 1), 9), np.float64)
        if n:
            lib.pt3_obj_copy(handle, verts.reshape(-1), mat_ids, mats.reshape(-1))
        return verts, mat_ids, mats[:m]
    finally:
        lib.pt3_obj_free(handle)


def morton_order(points: np.ndarray) -> np.ndarray:
    """Spatial (Morton) ordering permutation for [n, 3] points; the native
    order equals utils/morton.morton_order's."""
    pts = np.ascontiguousarray(points, np.float64)
    lib = load()
    if lib is None:
        return _morton_order_py(pts)
    order = np.empty((pts.shape[0],), np.int32)
    lib.pt3_morton_order(pts.reshape(-1), pts.shape[0], order)
    return order


def raw_merge_native(paths, out_path: str) -> bool:
    """Merges the ``.raw`` files ``paths`` into ``out_path`` natively (the
    bytes utils/framebuffer.merge would write); False when the library is
    unavailable. Raises IOError with the reference's wording."""
    lib = load()
    if lib is None:
        return False
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    err = ctypes.create_string_buffer(512)
    if lib.pt3_raw_merge(arr, len(paths), os.fsencode(out_path), err, 512) != 0:
        raise IOError(err.value.decode())
    return True
