"""Kernel K5's plain version (ops/megakernel.fused_passes on CPU tensors)
against the JAX package's ``fused_passes`` in Pallas interpret mode, on the
same first-bounce state and uniform tables (the JAX rows [S*nb*4, N]
regrouped lane-major for the port, ``megakernel.lane_major_table``).

The camera stage feeding both (integrator._first_bounce_state) is checked
against the JAX package's compiled one: origins, throughputs, liveness and
the threefry uniform rows bit for bit; the first-bounce directions and the
acos rows to 1e-6 relative (the port's CPU rounding follows XLA's fused
multiply-adds as contracted in a whole compiled render, which the golden
images gate bit for bit; compiled on its own, this stage contracts a few
products differently).

Tolerances: per lane, ``acc`` within rtol 1e-4 / atol 1e-5 and ``cnt``
equal on >= 99 % of lanes (the interpret-mode kernel starts its triangle
reciprocal from a bfloat16 estimate, so a near-tie can flip a lane's path);
tile-mean ``acc`` within rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models.catalog import create_scene as create_j
from pt_three_ways_tpu.models.integrator import _first_bounce_state as fbs_j
from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.pallas_megakernel import PackedSceneFused as PFj
from pt_three_ways_tpu.ops.pallas_megakernel import fused_passes as fp_j
from pt_three_ways_tpu.utils.render_params import RenderParams as RPj
from pt_three_ways_tpu_torch.models.catalog import create_scene as create_t
from pt_three_ways_tpu_torch.models.integrator import _first_bounce_state as fbs_t
from pt_three_ways_tpu_torch.models.scene import SceneBuilder as SBt
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.utils.render_params import RenderParams as RPt

W = 16
S = 2
NB = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of small ops: with one intra-op
    thread a test worker does not wait on the barriers of a thread pool that
    the other workers' processes oversubscribe (tens of times slower under
    the parallel test run). Test files that import it get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def first_bounce_tables(name, n_passes=S, seed=7):
    """(JAX scene, port scene, state0 [S*10, N], unif [S*nb*4, N]) from the
    JAX camera stage, after checking the port's stage against it."""
    kw = dict(width=W, height=W, first_bounce_u_samples=2,
              first_bounce_v_samples=2, max_depth=NB + 1)
    bj, bt = SBj(), SBt()
    cam_j = create_j(bj, name, RPj(**kw))
    cam_t = create_t(bt, name, RPt(**kw))
    sj, st = bj.build(), bt.build()
    pj, pt = RPj(**kw), RPt(**kw)
    n = W * W
    px = np.arange(n, dtype=np.int32) % W
    py = np.arange(n, dtype=np.int32) // W
    run_j = jax.jit(lambda key: fbs_j(sj, cam_j, pj, key, jnp.asarray(px),
                                      jnp.asarray(py), 1024, "xla"))
    states, unifs = [], []
    for s in range(n_passes):
        kj = jax.random.fold_in(jax.random.fold_in(rj.base_key(seed), s), 0)
        kt = rt.fold_in(rt.fold_in(rt.base_key(seed), s), 0)
        st_j, base_j, un_j = (np.asarray(x) for x in run_j(kj))
        st_t, base_t, un_t = fbs_t(st, cam_t, pt, kt, torch.from_numpy(px),
                                   torch.from_numpy(py), 1024, "xla")
        st_t = st_t.numpy()
        dir_rows = slice(3, 6)
        np.testing.assert_array_equal(np.delete(st_j, [3, 4, 5], axis=0),
                                      np.delete(st_t, [3, 4, 5], axis=0))
        np.testing.assert_allclose(st_t[dir_rows], st_j[dir_rows], rtol=1e-6, atol=1e-7)
        assert (st_t[dir_rows] == st_j[dir_rows]).mean() > 0.9
        np.testing.assert_array_equal(base_j, base_t.numpy())
        np.testing.assert_array_equal(un_j[0::4], un_t.numpy()[0::4])  # u rows
        np.testing.assert_array_equal(un_j[2::4], un_t.numpy()[2::4])  # v rows
        np.testing.assert_array_equal(un_j[3::4], un_t.numpy()[3::4])  # p rows
        # acos(u) rows: XLA's arccos vs a float64-evaluated one
        np.testing.assert_allclose(un_t.numpy()[1::4], un_j[1::4], rtol=1e-6, atol=1e-7)
        states.append(st_j)
        unifs.append(un_j)
    return sj, st, np.concatenate(states), np.concatenate(unifs)


def assert_lanes_agree(acc_t, cnt_t, acc_j, cnt_j):
    lane_ok = np.all(np.isclose(acc_t, acc_j, rtol=1e-4, atol=1e-5), axis=0) & (cnt_t == cnt_j)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    np.testing.assert_allclose(acc_t.mean(axis=1), acc_j.mean(axis=1), rtol=1e-3)


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_k5_plain_matches_jax_interpret(name):
    sj, st, state0, unif = first_bounce_tables(name)
    pk_t = mk.PackedSceneFused(st)
    assert pk_t.no_glossy == (name == "suzanne")
    acc_j, cnt_j = fp_j(PFj(sj), sj.environment, jnp.asarray(state0), jnp.asarray(unif),
                        1e-4, NB, S, interpret=True)
    acc_t, cnt_t = mk.fused_passes(pk_t, torch.from_numpy(state0),
                                   mk.lane_major_table(torch.from_numpy(unif), NB, S), 1e-4, NB,
                                   S)
    assert mk.fused_passes.launches == 0
    assert_lanes_agree(acc_t.numpy(), cnt_t.numpy(), np.asarray(acc_j), np.asarray(cnt_j))
    assert cnt_t.sum() > 0


@pytest.mark.parametrize("cone", [0.0, 5e-5])
def test_first_bounce_state_glossy_flag_keeps_rows(cone):
    """The camera stage's ``no_glossy`` flag only skips the cone sample: True
    and False give bit-equal rows and a zero cone-angle gradient on suzanne
    as built (every cone angle 0) and with every cone angle at 5e-5, above
    a pack's 1e-9 threshold and below ``cone_sample``'s mirror cut-off
    (1e-4). A render passes its pack's flag and the training paths pass
    False on this invariant. A glossy cone (0.2) moves the rows, so the
    specular branch is taken."""
    kw = dict(width=W, height=W, first_bounce_u_samples=2, first_bounce_v_samples=2,
              max_depth=NB + 1)
    b = SBt()
    cam = create_t(b, "suzanne", RPt(**kw))
    scene = b.build()
    px = torch.arange(W * W, dtype=torch.int32) % W
    py = torch.arange(W * W, dtype=torch.int32) // W
    key = rt.fold_in(rt.fold_in(rt.base_key(5), 0), 0)

    def stage(angle, no_glossy):
        ca = torch.full_like(scene.materials.cone_angle, angle).requires_grad_()
        sc = scene._replace(materials=scene.materials._replace(cone_angle=ca))
        rows, _, _ = fbs_t(sc, cam, RPt(**kw), key, px, py, 1024, "xla", want_unif=False,
                           no_glossy=no_glossy)
        grad, = torch.autograd.grad(rows[:9].sum(), ca, allow_unused=True)
        return rows.detach(), torch.zeros_like(ca) if grad is None else grad

    rows_t, grad_t = stage(cone, True)
    rows_f, grad_f = stage(cone, False)
    assert torch.equal(rows_t, rows_f)
    assert not grad_t.any() and not grad_f.any()
    assert not torch.equal(stage(0.2, False)[0], rows_f)


def test_next_alive_table():
    state0 = torch.zeros((3 * 10, 4))
    state0[9::10] = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [1, 1, 0, 0]])
    nexta = mk.next_alive_table(state0, 3)
    np.testing.assert_array_equal(
        nexta.numpy(),
        [[0, 1, 3, 3], [2, 1, 3, 3], [2, 2, 3, 3], [3, 3, 3, 3]],
    )
    words = mk.alive_mask_words(state0, 3)
    np.testing.assert_array_equal(words.numpy(), [[5, 6, 0, 0], [0, 0, 0, 0]])


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_k5_plain_on_stream_pack_matches_fused_pack_and_jax(name):
    """Table mode takes a ``PackedSceneStream`` (the card's K5 culls its
    search by the pack's window boxes): on the CPU the plain version gives
    the ``PackedSceneFused`` run's acc and counts bit for bit, and agrees
    with the JAX kernel in interpret mode as above."""
    sj, st, state0, unif = first_bounce_tables(name)
    acc_j, cnt_j = fp_j(PFj(sj), sj.environment, jnp.asarray(state0), jnp.asarray(unif),
                        1e-4, NB, S, interpret=True)
    table = mk.lane_major_table(torch.from_numpy(unif), NB, S)
    runs = [mk.fused_passes(pack(st), torch.from_numpy(state0), table, 1e-4, NB, S)
            for pack in (mk.PackedSceneFused, mk.PackedSceneStream)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert_lanes_agree(runs[1][0].numpy(), runs[1][1].numpy(), np.asarray(acc_j),
                       np.asarray(cnt_j))


def test_trace_passes_fused_table_mode_builds_stream_pack(monkeypatch):
    """``trace_passes_fused`` in table mode packs the scene with its window
    boxes (a ``PackedSceneStream``, which the card's K5 needs), and its
    radiance equals the same call on a ``PackedSceneFused``."""
    from pt_three_ways_tpu_torch.models import integrator as integ

    params = RPt(width=8, height=8, first_bounce_u_samples=2, first_bounce_v_samples=2,
                 max_depth=NB + 1, rng_mode="table", intersector="kernel")
    sb = SBt()
    camera = create_t(sb, "suzanne", params)
    scene = sb.build()
    px = torch.arange(64, dtype=torch.int32) % 8
    py = torch.arange(64, dtype=torch.int32) // 8
    packs = []
    fp = mk.fused_passes
    monkeypatch.setattr(mk, "fused_passes", lambda pk, *a: packs.append(type(pk)) or fp(pk, *a))
    key = rt.base_key(3)
    rad = integ.trace_passes_fused(scene, camera, params, key, 0, 0, px, py, S)
    ref = integ.trace_passes_fused(scene, camera, params, key, 0, 0, px, py, S,
                                   packed=mk.PackedSceneFused(scene))
    assert packs == [mk.PackedSceneStream, mk.PackedSceneFused]
    assert torch.equal(rad, ref) and float(rad.sum()) > 0


def test_lane_major_table_matches_bounce_rows():
    """K5's lane-major table holds the row-major table's values: the camera
    stage's ``bounce_rows(lane_major=True)`` equals ``lane_major_table`` of
    its rows, which ``fused_passes_plain`` reads lane by lane as the rows
    were read."""
    from pt_three_ways_tpu_torch.models import integrator as integ

    key = rt.base_key(9)
    rows = integ.bounce_rows(key, NB, 40, "cpu")
    lm = integ.bounce_rows(key, NB, 40, "cpu", lane_major=True)
    assert lm.shape == (NB, 40, 4)
    assert torch.equal(lm, mk.lane_major_table(rows, NB, 1))
    assert torch.equal(lm[1, 7], rows[4:8, 7])
