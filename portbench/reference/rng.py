"""The random streams the path tracer draws from, written out plainly.

Two generators, both pure functions of counters, so a reference can draw
the numbers of any single lane without drawing the rest:

* threefry-2x32 (20 rounds), in the ``jax.random`` conventions: a key is
  two uint32 words, ``fold_in(key, d)`` hashes the counter pair (0, d),
  and ``uniform(key, shape)`` hashes the flat index ``i`` of each element
  as the pair (i >> 32, i & 0xFFFFFFFF), xors the two output words and
  keeps the top 23 bits as a float32 mantissa in [1, 2), minus 1;
* the per-event hash of the in-kernel generator: murmur3 finalisers
  (fmix32) of ``lane * P1 + (sample * 256 + depth) * P2`` plus one seed
  word per channel (u, v, p).

uint32 values are held in int64 tensors and masked after each step.
Keys may be tensors, one key per element, so lanes of different frames,
samples and tiles are drawn in one call.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

# stream labels of the program's draws
CAMERA_STREAM = 0x0C0FFEE
FIRST_BOUNCE_STREAM = 0x1B0B0
BOUNCE_STREAM_BASE = 0x2000000
KERNEL_RNG_STREAM = 0x6B524E47

_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
P1, P2 = 0x9E3779B1, 0x85EBCA77


def threefry(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint32 words (ints or int64 tensors)."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    a = (x1 + k1) & M32
    b = (x2 + k2) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & M32
            b = (((b << r) & M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def seed_key(seed: int):
    seed = int(seed)
    return ((seed >> 32) & M32, seed & M32)


def fold_in(key, data):
    """Key words folded with ``data`` (an int or an int64 tensor)."""
    return threefry(key[0], key[1], 0 * data if torch.is_tensor(data) else 0, data & M32)


def bits_to_unit(bits):
    """uint32 -> the float32 in [0, 1) of its top 23 bits."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_at(key, flat_index):
    """float32 uniforms of ``uniform(key, shape)`` at the given flat indices."""
    a, b = threefry(key[0], key[1], flat_index >> 32, flat_index & M32)
    return bits_to_unit(a ^ b)


def _mul32(x, c: int):
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def channel_seeds(base):
    """The three channel seed words of the in-kernel generator of a frame
    whose key words are ``base`` (ints or tensors): from the key
    ``fold_in(base, KERNEL_RNG_STREAM)``."""
    k0, k1 = fold_in(base, KERNEL_RNG_STREAM)
    mix = _mul32(k1, P1)
    base = (k0, k1 ^ 0x243F6A88, (k0 + 0xB7E15163) & M32)
    return tuple(fmix32((b + mix) & M32) for b in base)


def event_uniforms(lane, sample, depth, seeds):
    """(u, v, p) float32 of the in-kernel generator for int64 tensors of
    lane ids, sample indices and depths; ``seeds``: three words or three
    int64 tensors."""
    h = (_mul32(lane & M32, P1) + _mul32((sample * 256 + depth) & M32, P2)) & M32
    return tuple(bits_to_unit(fmix32((h + s) & M32)) for s in seeds)
