"""The port's counter-based RNG against JAX, bit for bit.

Threefry (ops/rng.py) must equal ``jax.random`` draw for draw under this
jax's ``jax_threefry_partitionable`` layout: that equality is what lets the
golden images gate the port. Kernel K1 (ops/kernel_rng.py, the in-kernel
hash of the krng megakernel) must equal the JAX package's
``ops/kernel_rng.py``. Tolerance: none (bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.ops import kernel_rng as kj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu_torch.ops import _cuda
from pt_three_ways_tpu_torch.ops import kernel_rng as kt
from pt_three_ways_tpu_torch.ops import rng as rt

SEEDS = [0, 1, 11, 12345, 2**31 - 1, 2**32 + 7]
FOLDS = [0, 3, rj.CAMERA_STREAM, rj.FIRST_BOUNCE_STREAM, rj.BOUNCE_STREAM_BASE,
         rj.KERNEL_RNG_STREAM, 2**32 - 1]


def _key_np(key):
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_equal(seed):
    kj_ = jax.random.PRNGKey(seed)
    kt_ = rt.PRNGKey(seed)
    np.testing.assert_array_equal(_key_np(kj_), kt_.numpy())
    for d in FOLDS:
        np.testing.assert_array_equal(
            _key_np(jax.random.fold_in(kj_, d)), rt.fold_in(kt_, d).numpy()
        )
    # the render's key chain: fold(fold(base, sample), tile), then streams
    a = rj.stream_key(jax.random.fold_in(jax.random.fold_in(rj.base_key(seed), 5), 2),
                      rj.CAMERA_STREAM)
    b = rt.stream_key(rt.fold_in(rt.fold_in(rt.base_key(seed), 5), 2), rt.CAMERA_STREAM)
    np.testing.assert_array_equal(_key_np(a), b.numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (4, 33), (3, 17, 4), (2, 1000)])
def test_uniform_bit_equal(shape):
    for seed in (0, 11, 99991):
        for d in (0, 1, rj.BOUNCE_STREAM_BASE):
            k = jax.random.fold_in(jax.random.PRNGKey(seed), d)
            a = np.asarray(jax.random.uniform(k, shape, dtype=jnp.float32))
            b = rt.uniform(rt.fold_in(rt.PRNGKey(seed), d), shape).numpy()
            assert b.dtype == np.float32 and b.shape == a.shape
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniforms_on_cpu_take_the_plain_path(monkeypatch, dtype):
    """On a CPU tensor ``uniforms`` never loads the CUDA kernels (K11 is the
    card's path) and stays bit-equal to the plain ``uniform``."""

    def no_lib():
        raise AssertionError("uniforms loaded the CUDA kernels on the CPU")

    monkeypatch.setattr(_cuda, "lib", no_lib)
    launches = rt.uniform_kernel.launches
    view = torch.int32 if dtype == torch.float32 else torch.int64
    key = rt.stream_key(rt.fold_in(rt.fold_in(rt.base_key(9), 1), 0), rt.CAMERA_STREAM)
    for shape in [(1,), (3, 7), (4, 1000)]:
        for device in ("cpu", torch.device("cpu")):
            got = rt.uniforms(key, shape, device, dtype)
            assert got.dtype == dtype and got.device.type == "cpu"
            assert torch.equal(got.view(view), rt.uniform(key, shape, "cpu", dtype).view(view))
    assert rt.uniform_kernel.launches == launches


def test_kernel_rng_hash_bit_equal(rng_np):
    h = rng_np.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    ht = torch.from_numpy(h.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(kj.fmix32(jnp.asarray(h))).astype(np.int64), kt.fmix32(ht).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(kj.uniform_from_bits(jnp.asarray(h))).view(np.int32),
        kt.uniform_from_bits(ht).numpy().view(np.int32),
    )
    lane = rng_np.integers(0, 2**31, size=(1, 512)).astype(np.uint32)
    sd = rng_np.integers(0, 2**32, size=(1, 512), dtype=np.uint64).astype(np.uint32)
    k0, k1 = np.uint32(0x12345678), np.uint32(0x9ABCDEF0)
    seeds_j = kj.channel_seeds(jnp.uint32(k0), jnp.uint32(k1))
    seeds_t = kt.channel_seeds(int(k0), int(k1))
    assert [int(s) for s in np.asarray(seeds_j).ravel()] == seeds_t
    seeds_col = torch.tensor(seeds_t, dtype=torch.int64).reshape(3, 1)
    lane_t = torch.from_numpy(lane.astype(np.int64))
    sd_t = torch.from_numpy(sd.astype(np.int64))
    ref = kj.event_uniforms_rows(jnp.asarray(lane), jnp.asarray(sd), seeds_j)
    got = kt.event_uniforms_rows(lane_t, sd_t, seeds_col)
    premixed = kt.event_uniforms_premixed(
        (kt.mul32(lane_t, kt._IN_P1) + kt.mul32(sd_t, kt._IN_P2)) & 0xFFFFFFFF, seeds_col
    )
    for r, g, p in zip(ref, got, premixed):
        np.testing.assert_array_equal(np.asarray(r).view(np.int32), g.numpy().view(np.int32))
        np.testing.assert_array_equal(g.numpy().view(np.int32), p.numpy().view(np.int32))


def test_acos01_and_key_words_bit_equal(rng_np):
    x = rng_np.random(20000).astype(np.float32)
    x[:3] = [0.0, 1.0, 0.5]
    np.testing.assert_array_equal(
        np.asarray(kj.acos01(jnp.asarray(x))).view(np.int32),
        kt.acos01(torch.from_numpy(x)).numpy().view(np.int32),
    )
    key_j = rj.stream_key(rj.base_key(7), rj.KERNEL_RNG_STREAM)
    key_t = rt.stream_key(rt.base_key(7), rt.KERNEL_RNG_STREAM)
    assert tuple(int(w) for w in kj.key_words(key_j)) == kt.key_words(key_t)
    # the incremental depth term equals the direct one
    for s0, s, d in [(0, 0, 1), (8, 3, 4), (2**20, 63, 255)]:
        direct = kt.mul32(((s0 + s) * 256 + d) & 0xFFFFFFFF, kt._IN_P2)
        assert kt.sd_term(s0, s, d) == direct
        assert (kt.sd_term(s0, s, 1) + (d - 1) * kt._IN_P2) & 0xFFFFFFFF == direct
