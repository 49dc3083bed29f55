"""K10 (ops/megakernel.bounce_step) and the compacting wavefront
(models/integrator.trace_passes_compact) on the CPU, on cornell at 16²
(K = 2x2, depth 4, S = 3): the JAX package's tests/test_megakernel.py
``mesh_scene`` configuration.

  * K10's plain version against the JAX ``bounce_step(interpret=True,
    with_hit=True)`` on two bounces of the same states and uniforms (every
    third lane dead, the accumulator rows random; the second bounce starts
    from the JAX output): ``cnt`` equal
    on every lane; state, t and idx per lane (rtol 1e-4 / atol 1e-5) on >=
    99 % of lanes (the interpret-mode kernel's triangle reciprocal starts
    from a bfloat16 estimate, so a near-tie may flip a winner); dead lanes
    copied through.
  * The port's ``trace_passes_compact`` against the sum of the port's
    ``trace_pass`` over the same keys (the contract of
    tests/test_megakernel.py ``test_compact_passes_match_pass_sum``) and
    against the table-mode K5 (``trace_passes_fused``, the same estimator):
    rtol / atol 3e-4, and equal ray counts with K5.
  * K10's plain version is invariant under the lanes' order: on a stable
    partition of a cornell and a suzanne state (live lanes first, as
    ``trace_passes_compact`` builds it), two bounces scattered back equal
    the run on the unpartitioned state bit for bit (state, counts and the
    winner record). The card's K10 relies on it: its wholly dead warps skip
    the search, which only a packed state gives it.
  * Against the JAX package's ``trace_passes_compact``
    (``pallas-interpret``): the same near-tie flips (in its camera stage and
    its K10) change whole paths, here 3 of 256 pixels and 6 of 9,262 rays;
    so pixels agree to rtol / atol 3e-4 on >= 98 %, the image means to
    2e-3 and the ray counts to 0.1 %.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models.catalog import create_scene as create_j
from pt_three_ways_tpu.models.integrator import _first_bounce_state as fbs_j
from pt_three_ways_tpu.models.integrator import trace_passes_compact as compact_j
from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.pallas_megakernel import PackedSceneFused as PFj
from pt_three_ways_tpu.ops.pallas_megakernel import bounce_step as bounce_step_j
from pt_three_ways_tpu.utils.render_params import RenderParams as RPj
from pt_three_ways_tpu_torch.models import integrator as integ
from pt_three_ways_tpu_torch.models.catalog import create_scene as create_t
from pt_three_ways_tpu_torch.models.scene import SceneBuilder as SBt
from pt_three_ways_tpu_torch.models.scene import auto_epsilon
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.utils.render_params import RenderParams as RPt
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

W = 16
S = 3
N = W * W
KW = dict(width=W, height=W, samples_per_pixel=1, first_bounce_u_samples=2,
          first_bounce_v_samples=2, max_depth=4, seed=7)



@functools.lru_cache(maxsize=None)
def _scenes():
    bj, bt = SBj(), SBt()
    cam_j = create_j(bj, "cornell", RPj(width=W, height=W))
    cam_t = create_t(bt, "cornell", RPt(width=W, height=W))
    return bj.build(), cam_j, bt.build(), cam_t


def _pixels():
    px = np.arange(N, dtype=np.int32) % W
    py = np.arange(N, dtype=np.int32) // W
    return px, py


def test_bounce_step_plain_matches_jax():
    sj, cam_j, st, _ = _scenes()
    pj = RPj(**KW, intersector="pallas-interpret")
    px, py = _pixels()
    key = jax.random.fold_in(jax.random.fold_in(rj.base_key(7), 0), 0)
    rows, _, unif = jax.jit(lambda k: fbs_j(sj, cam_j, pj, k, jnp.asarray(px), jnp.asarray(py),
                                            1024, "xla"))(key)
    n = rows.shape[1]
    acc = np.random.default_rng(3).uniform(0.0, 1.0, (3, n)).astype(np.float32)
    state = np.concatenate([np.asarray(rows), acc])
    state[9, ::3] = 0.0  # closed cornell: no path dies in two bounces
    pk = mk.PackedSceneFused(st)
    for d in range(2):
        un = np.array(unif[4 * d:4 * d + 4])
        out_j, cnt_j, t_j, i_j = (np.asarray(x) for x in bounce_step_j(
            PFj(sj), sj.environment, jnp.asarray(state), jnp.asarray(un), pj.epsilon,
            interpret=True, with_hit=True))
        out_t, cnt_t, t_t, i_t = (x.numpy() for x in mk.bounce_step(
            pk, torch.from_numpy(state), torch.from_numpy(un), pj.epsilon, with_hit=True))
        assert mk.bounce_step.launches == 0
        np.testing.assert_array_equal(cnt_t, cnt_j)
        np.testing.assert_array_equal(cnt_t, state[9] != 0)
        assert 0 < cnt_t.sum() < n
        lane_ok = (np.all(np.isclose(out_t, out_j, rtol=1e-4, atol=1e-5), axis=0)
                   & np.isclose(t_t, t_j, rtol=1e-4, atol=1e-5) & (i_t == i_j))
        assert lane_ok.mean() >= 0.99, lane_ok.mean()
        dead = state[9] == 0
        np.testing.assert_array_equal(out_t[:, dead], state[:, dead])
        assert np.isinf(t_t[dead]).all() and (i_t[dead] == 0).all()
        # without the record: the same state and counts
        out2, cnt2 = mk.bounce_step(pk, torch.from_numpy(state), torch.from_numpy(un),
                                    pj.epsilon)
        np.testing.assert_array_equal(out2.numpy(), out_t)
        np.testing.assert_array_equal(cnt2.numpy(), cnt_t)
        state = np.array(out_j)


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_bounce_step_plain_is_lane_order_invariant(name):
    bt = SBt()
    params = RPt(**KW, intersector="kernel")
    cam = create_t(bt, name, params)
    scene = bt.build()
    px, py = (torch.from_numpy(a) for a in _pixels())
    key = rt.fold_in(rt.fold_in(rt.base_key(7), 0), 0)
    rows, _, unif = integ._first_bounce_state(scene, cam, params, key, px, py, 1024, "kernel")
    n = rows.shape[1]
    acc = torch.from_numpy(np.random.default_rng(5).uniform(0.0, 1.0, (3, n)).astype(np.float32))
    state = torch.cat([rows, acc])
    state[9, ::3] = 0.0
    pk = mk.PackedSceneFused(scene)
    eps = auto_epsilon(scene, cam)
    for d in range(2):
        un = unif[4 * d:4 * d + 4]
        whole = mk.bounce_step_plain(pk, state, un, eps, with_hit=True)
        perm = torch.argsort((state[9] == 0.0).to(torch.int32), stable=True)
        assert 0 < int(whole[1].sum()) < n
        part = mk.bounce_step_plain(pk, state[:, perm], un[:, perm], eps, with_hit=True)
        for x, y in zip(whole, part):
            back = torch.empty_like(y)
            back[..., perm] = y
            assert torch.equal(x, back)
        state = whole[0]


def test_compact_matches_jax_compact():
    sj, cam_j, st, cam_t = _scenes()
    px, py = _pixels()
    rad_j, n_j = compact_j(sj, cam_j, RPj(**KW, intersector="pallas-interpret"), rj.base_key(7),
                           0, 0, jnp.asarray(px), jnp.asarray(py), S, with_ray_count=True)
    rad_t, n_t = integ.trace_passes_compact(
        st, cam_t, RPt(**KW, intersector="kernel"), rt.base_key(7), 0, 0,
        torch.from_numpy(px), torch.from_numpy(py), S, with_ray_count=True)
    rad_t, rad_j = rad_t.numpy(), np.asarray(rad_j)
    pix_ok = np.all(np.isclose(rad_t, rad_j, rtol=3e-4, atol=3e-4), axis=1)
    assert pix_ok.mean() >= 0.98, pix_ok.mean()
    np.testing.assert_allclose(rad_t.mean(axis=0), rad_j.mean(axis=0), rtol=2e-3)
    assert abs(int(n_t) - int(n_j)) <= 1e-3 * int(n_j)


def test_compact_matches_pass_sum_and_k5():
    _, _, st, cam_t = _scenes()
    params = RPt(**KW, intersector="kernel")
    px, py = (torch.from_numpy(a) for a in _pixels())
    base = rt.base_key(7)
    rad, n_rays = integ.trace_passes_compact(st, cam_t, params, base, 0, 0, px, py, S,
                                             with_ray_count=True)
    expect = np.zeros((N, 3), np.float64)
    for s in range(S):
        key = rt.fold_in(rt.fold_in(base, s), 0)
        expect += integ.trace_pass(st, cam_t, params, key, px, py).numpy()
    np.testing.assert_allclose(rad.numpy(), expect, rtol=3e-4, atol=3e-4)
    # the table-mode regenerating kernel K5 runs the same estimator
    fused, cnts = integ.trace_passes_fused(st, cam_t, params.replace(rng_mode="table"), base,
                                           0, 0, px, py, S, with_lane_counts=True)
    np.testing.assert_allclose(rad.numpy(), fused.numpy(), rtol=3e-4, atol=3e-4)
    assert int(n_rays) == S * N + int(cnts.sum())
