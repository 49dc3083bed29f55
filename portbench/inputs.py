"""Inputs the benchmark makes from ``--seed`` and hands to both sides.

Everything here is a function of the seed alone: the same seed gives the
same frames, pixels, keys, materials and target on every run.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .reference import rng

M63 = (1 << 63) - 1


def frame_seed(seed: int, i: int) -> int:
    """The render seed of frame ``i`` of a run seeded ``seed`` (nonzero)."""
    h = hashlib.sha256(f"frame:{int(seed)}:{int(i)}".encode()).digest()
    return (int.from_bytes(h[:8], "little") & M63) or 1


def check_pixels(seed: int, i: int, n: int, width: int, height: int):
    """``n`` distinct pixels (xs, ys) of frame ``i``, drawn from the seed."""
    g = np.random.default_rng([int(seed) & M63, int(i), 0xC4EC])
    flat = g.choice(width * height, size=min(n, width * height), replace=False)
    return flat % width, flat // width


def step_key(seed: int, i: int):
    """Key words of training step ``i``: ``fold_in(seed_key(seed), i)``."""
    return rng.fold_in(rng.seed_key(seed), i)


def _factor(seed: int, row: np.ndarray, col: int) -> float:
    """A factor in [0.8, 1.2) keyed by the seed and the row's values (to six
    digits), so both sides perturb a material alike whatever its row."""
    key = ",".join(f"{float(v):.6g}" for v in row)
    h = hashlib.sha256(f"perturb:{int(seed)}:{key}:{col}".encode()).digest()
    return 0.8 + 0.4 * int.from_bytes(h[:8], "little") / 2.0 ** 64


def perturb(rows: np.ndarray, seed: int, scale: float) -> np.ndarray:
    """Float32 material rows [M, 9] with emission and diffuse (columns 0-5)
    scaled by factors within ``1 +- scale``, per row and column."""
    rows = np.asarray(rows, np.float32)
    out = rows.astype(np.float64)
    for i, row in enumerate(rows):
        for c in range(6):
            out[i, c] *= 1.0 + (_factor(seed, row, c) - 1.0) / 0.2 * scale
    return out.astype(np.float32)


def target(seed: int, n: int, device, scale: float = 0.3) -> torch.Tensor:
    """The target image [n, 3] float32 in [0, scale), drawn on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & M63)
    return torch.rand((n, 3), generator=g, device=device) * scale
