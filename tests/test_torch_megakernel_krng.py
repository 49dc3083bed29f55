"""Kernel K4's plain version (ops/megakernel.fused_passes_krng on CPU
tensors) against the JAX package's ``fused_passes_krng`` in Pallas interpret
mode, on the same first-bounce state, lane ids and key words; and K4 with
tail compaction against the same launch run to exhaustion.

Tolerances: as for K5 (tests/test_torch_megakernel.py): per-lane ``acc``
rtol 1e-4 / atol 1e-5 and equal ``cnt`` on >= 99 % of lanes (the packed
winner folds the row into t's low bits, so a near-tie may flip either way),
tile-mean ``acc`` rtol 1e-3. Tail compaction changes only the float32
grouping of each lane's sum at level boundaries: counts equal, ``acc``
within a few ulp (rtol 1e-6); in replay mode the continuation carries each
lane's sum on, so ``acc``, counts and residual slots are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.ops import kernel_rng as krj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.pallas_megakernel import PackedSceneFused as PFj
from pt_three_ways_tpu.ops.pallas_megakernel import fused_passes_krng as fk_j
from pt_three_ways_tpu_torch.models.integrator import lane_ids_for
from pt_three_ways_tpu_torch.ops import kernel_rng as krt
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.ops import rng as rt
from test_torch_megakernel import (  # noqa: F401 (one_torch_thread: autouse fixture)
    NB,
    S,
    W,
    assert_lanes_agree,
    first_bounce_tables,
    one_torch_thread,
)


def _lanes_and_keys(seed=7):
    n = W * W
    px = torch.arange(n, dtype=torch.int32) % W
    py = torch.arange(n, dtype=torch.int32) // W
    lanes = lane_ids_for(px, py, W, 4)
    # the JAX package's lane ids for the same pixels
    lj = ((py.numpy() * W + px.numpy())[:, None] * 4 + np.arange(4)[None, :]).reshape(-1)
    np.testing.assert_array_equal(lanes.numpy(), lj)
    kw_j = krj.key_words(rj.stream_key(rj.base_key(seed), rj.KERNEL_RNG_STREAM))
    kw_t = krt.key_words(rt.stream_key(rt.base_key(seed), rt.KERNEL_RNG_STREAM))
    assert tuple(int(w) for w in kw_j) == kw_t
    return lanes, kw_j, kw_t


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_k4_plain_matches_jax_interpret(name):
    sj, st, state0, _ = first_bounce_tables(name)
    lanes, kw_j, kw_t = _lanes_and_keys()
    pk_t = mk.PackedSceneFused(st)
    acc_j, cnt_j = fk_j(PFj(sj), sj.environment, jnp.asarray(state0),
                        jnp.asarray(lanes.numpy()), kw_j, 3, 1e-4, NB, S, interpret=True)
    acc_t, cnt_t = mk.fused_passes_krng(pk_t, torch.from_numpy(state0), lanes, kw_t, 3,
                                        1e-4, NB, S)
    assert mk.fused_passes_krng.launches == 0
    assert_lanes_agree(acc_t.numpy(), cnt_t.numpy(), np.asarray(acc_j), np.asarray(cnt_j))


def test_k4_tail_compaction_matches_exhaustion():
    _, st, state0, _ = first_bounce_tables("suzanne", n_passes=4, seed=3)
    lanes, _, kw_t = _lanes_and_keys(3)
    pk = mk.PackedSceneFused(st)
    s0 = torch.from_numpy(state0)
    full, cnt_full = mk.fused_passes_krng(pk, s0, lanes, kw_t, 0, 1e-4, NB, 4)
    for levels in (1, 2):
        tail, cnt_tail = mk.fused_passes_krng(pk, s0, lanes, kw_t, 0, 1e-4, NB, 4,
                                              tail_frac=0.125, tail_levels=levels, block=128)
        np.testing.assert_array_equal(cnt_tail.numpy(), cnt_full.numpy())
        np.testing.assert_allclose(tail.numpy(), full.numpy(), rtol=1e-6, atol=1e-7)
    # replay runs to exhaustion only, as in the JAX package
    with pytest.raises(ValueError):
        mk.fused_passes_krng(pk, s0, lanes, kw_t, 0, 1e-4, NB, 4, replay=True,
                             tail_frac=0.125)
    with pytest.raises(ValueError):
        mk.fused_passes_krng(pk, torch.zeros(650, 4), torch.zeros(4), kw_t, 0, 1e-4, NB, 65)
