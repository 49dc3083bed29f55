"""Spatial (Morton) ordering of triangle centroids.

The pure-Python form of ``utils/native.morton_order`` (the native library,
csrc/pt3native.cpp, computes the same permutation and falls back to this);
the scene builder sorts triangles with it so consecutive 64-row chunks are
compact in space for the intersector's two-level box hierarchy.
"""

from __future__ import annotations

import numpy as np


def morton_order(points: np.ndarray) -> np.ndarray:
    """Spatial (Morton) ordering permutation for [n, 3] points."""
    pts = np.ascontiguousarray(points, np.float64)
    lo = pts.min(0)
    rng = np.where(pts.max(0) - lo > 0, pts.max(0) - lo, 1.0)
    q = np.clip(((pts - lo) / rng) * 1023.0, 0, 1023).astype(np.uint32)

    def expand(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)
