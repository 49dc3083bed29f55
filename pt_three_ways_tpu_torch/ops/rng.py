"""Counter-based stateless RNG: threefry2x32, draw for draw as ``jax.random``.

The reference threads a mutable mt19937 per worker (seeded seed+passIndex,
src/oo/Renderer.cpp:99). Like the JAX package, the port draws every random
number as a pure function of (seed, pass, tile, purpose, array index), so
renders are bit-reproducible under any tiling and resume.

This module reproduces ``jax.random.PRNGKey`` / ``fold_in`` / ``uniform``
(float32 and, under ``jax_enable_x64``, float64) bit for bit, in the
``jax_threefry_partitionable=True`` layout that jax 0.9 uses by default:
``uniform(key, shape)`` hashes the flat index ``i`` of each element as the
counter pair (i >> 32, i & 0xFFFFFFFF); a 32-bit draw xors the two output
words, a 64-bit draw concatenates them (first word high). Keys are
explicit: a key is an int64 tensor ``[2]`` holding the two uint32 words,
passed by the caller; there is no global generator.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF`` masks (torch's
uint32 lacks most operators on the CPU). Threefry needs only add, xor and
rotate, so no product ever leaves 64 bits. That plain version (``uniform``)
is the CPU's path and the reference; on a CUDA device ``uniforms`` launches
kernel K11 (``csrc/threefry.cu``, ``uniform_kernel``), which gives the same
bits in one launch.
"""

from __future__ import annotations

import math

import torch

from ..utils import tracing
from . import _cuda

# Stream labels so distinct uses of the same (seed, pass) never collide.
CAMERA_STREAM = 0x0C0FFEE
FIRST_BOUNCE_STREAM = 0x1B0B0
BOUNCE_STREAM_BASE = 0x2000000
# Seed stream for the in-kernel counter RNG (ops/kernel_rng.py): folded from
# the base key only, so its draws are invariant to dispatch tiling.
KERNEL_RNG_STREAM = 0x6B524E47  # "kRNG"

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors or
    Python ints; the same schedule as jax's ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _words(key: torch.Tensor):
    k = key.tolist()
    return int(k[0]) & _M32, int(k[1]) & _M32


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & M32)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair (0, data)."""
    k1, k2 = _words(key)
    o1, o2 = threefry2x32(k1, k2, 0, int(data) & _M32)
    return torch.tensor([o1, o2], dtype=torch.int64)


def random_bits(key: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """uint32 bits (in int64) of ``jax.random.bits`` for ``shape``."""
    b1, b2 = _hash_words(key, shape, device)
    return (b1 ^ b2).reshape(shape)


def _hash_words(key: torch.Tensor, shape, device):
    k1, k2 = _words(key)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return threefry2x32(k1, k2, idx >> 32, idx & _M32)


def uniform(key: torch.Tensor, shape, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)``: the top mantissa-width bits
    of the draw as the mantissa of a float in [1, 2), minus 1. float32 takes
    23 bits of the 32-bit draw; float64 takes 52 of the 64-bit draw
    ``(b1 << 32) | b2``, built as ``(b1 << 20) | (b2 >> 12)`` so no value
    leaves int64."""
    if dtype == torch.float64:
        b1, b2 = _hash_words(key, shape, device)
        mant = ((b1 << 20) | (b2 >> 12)).reshape(shape)
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    if dtype != torch.float32:
        raise ValueError(f"uniform: unsupported dtype {dtype}")
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def base_key(seed: int) -> torch.Tensor:
    return PRNGKey(seed)


def pass_key(key: torch.Tensor, pass_index) -> torch.Tensor:
    """Per-sample-pass key (analogue of mt19937(seed + pass))."""
    return fold_in(key, pass_index)


def tile_key(key: torch.Tensor, tile_index) -> torch.Tensor:
    """Per-dispatch-tile / per-device fold so shards draw disjoint streams."""
    return fold_in(key, tile_index)


def stream_key(key: torch.Tensor, stream: int) -> torch.Tensor:
    return fold_in(key, stream)


_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}


def uniform_kernel(key: torch.Tensor, shape, device, dtype=torch.float32) -> torch.Tensor:
    """``uniform`` on a CUDA device by K11, one launch; bit for bit the plain
    version's values. Raises for another dtype or a failed launch. Counts
    its calls in ``uniform_kernel.launches`` and, while tracing is on, the
    elements drawn in the counter ``rng.kernel_draws``."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"uniform: unsupported dtype {dtype}")
    k1, k2 = _words(key)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    err = _cuda.lib().pt3_threefry_uniform(k1, k2, out.numel(), out.data_ptr(),
                                           _KERNEL_DTYPES[dtype], _cuda.stream_ptr(out.device))
    _cuda.check(err, "pt3_threefry_uniform")
    uniform_kernel.launches += 1
    tracing.count("rng.kernel_draws", out.numel())
    return out


uniform_kernel.launches = 0


def uniforms(key: torch.Tensor, shape, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """U[0,1) of the given shape and dtype (float32 or float64);
    counter-based over the flat index: K11 on a CUDA device, the plain
    version elsewhere. Traced as ``pt3.rng``."""
    with tracing.span("pt3.rng", device):
        if torch.device(device).type == "cuda":
            return uniform_kernel(key, shape, device, dtype)
        return uniform(key, shape, device, dtype)
