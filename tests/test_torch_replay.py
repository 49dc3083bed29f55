"""The training path's pieces against the JAX package's, on the CPU.

Each test carries one JAX scene and camera into the port
(``models/scene.from_jax_arrays``), so both packages trace the same tables.
The JAX side runs its Pallas kernels in interpret mode
(``intersector="pallas-interpret"``); the port side uses
``intersector="kernel"``, whose wrappers take the kernels' plain versions
for CPU tensors.

  * K7 (``fused_bounces``, with residuals) against the JAX kernel on the
    same first-bounce state and uniform rows: per lane ``acc`` within rtol
    1e-4 / atol 1e-5, counts and winner indices equal on >= 99 % of lanes
    (the interpret-mode kernel refines its triangle reciprocal from another
    start, so a near-tie may flip a lane's winner, as in
    tests/test_torch_megakernel.py); the saved states and distances of the
    agreeing lanes within rtol 1e-4 / atol 1e-5 for >= 99 % of values and
    all within 1e-3 (a glossy cone sample goes through sin/cos and a basis
    around the mirror direction: on cornell a few direction components, and
    the distances they lead to, differ by ~1.5e-4 between the two
    roundings).
  * K8 (``bounce_bwd_step``) against the JAX kernel plus ``replay.py``'s
    mat_id segment-sum, on the JAX forward's own residuals so both
    linearise at the same points: input-state cotangents within rtol 1e-4 /
    atol 1e-5 of the largest on >= 99 % of lanes (a lane whose event choice
    is a near-tie may take the other branch), material and environment
    gradients within 1e-4 of their largest entry.
  * ``trace_pass_replay``: the value within rtol 1e-5, and the gradients
    w.r.t. materials, environment and camera within rtol 1e-4 / atol 1e-4
    of each field's largest entry (float32 sums over a few hundred lanes in
    other orders; the port's CPU rounding follows XLA's compiled code), the
    ior gradient within 1e-3 of its largest entry: a material at the
    Fresnel sentinel with ior 1 has r_perp = 0 up to rounding, so its ior
    gradient is rounding noise (measured 3.5e-4 of the largest on cornell).
  * The port's ``kernel_bwd=True`` against ``kernel_bwd=False`` (the plain
    replay through ``bounce_from_hits``): rtol 1e-5 / atol 1e-5 of the
    largest entry, as the JAX package's own test.
  * The emission gradient against central finite differences, and albedo
    recovery by gradient descent, on the replay path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models.catalog import create_scene as create_j
from pt_three_ways_tpu.models.integrator import _first_bounce_state as fbs_j
from pt_three_ways_tpu.models.replay import trace_pass_replay as replay_j
from pt_three_ways_tpu.models.scene import SceneBuilder as SBj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.pallas_megakernel import PackedSceneFused as PFj
from pt_three_ways_tpu.ops.pallas_megakernel import bounce_bwd_step as bwd_j
from pt_three_ways_tpu.ops.pallas_megakernel import fused_bounces as fb_j
from pt_three_ways_tpu.utils.render_params import RenderParams as RPj
from pt_three_ways_tpu_torch.models.materials import MaterialSpec
from pt_three_ways_tpu_torch.models.replay import trace_pass_replay
from pt_three_ways_tpu_torch.models.scene import SceneBuilder, from_jax_arrays
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.ops import rng as rt
from pt_three_ways_tpu_torch.ops.camera import make_camera
from pt_three_ways_tpu_torch.utils.render_params import RenderParams
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

SIDE = 6
NB = 3  # max_depth 4
SEED = 9


def jax_arrays(scene, camera) -> dict:
    d = {}
    for grp in ("spheres", "triangles", "materials"):
        part = getattr(scene, grp)
        for f in part._fields:
            d[f"{grp}.{f}"] = np.asarray(getattr(part, f))
    d["environment"] = np.asarray(scene.environment)
    for f in camera._fields:
        d[f"camera.{f}"] = np.asarray(getattr(camera, f))
    return d


def make_pair(name, side=SIDE, max_depth=NB + 1, seed=SEED):
    """(JAX params, scene, camera, port params, scene, camera, px, py)."""
    kw = dict(width=side, height=side, samples_per_pixel=1, seed=seed,
              first_bounce_u_samples=2, first_bounce_v_samples=2, max_depth=max_depth)
    bj = SBj()
    cam_j = create_j(bj, name, RPj(**kw))
    sj = bj.build()
    st, cam_t = from_jax_arrays(jax_arrays(sj, cam_j))
    n = side * side
    px = np.arange(n, dtype=np.int32) % side
    py = np.arange(n, dtype=np.int32) // side
    return (RPj(intersector="pallas-interpret", **kw), sj, cam_j,
            RenderParams(intersector="kernel", **kw), st, cam_t, px, py)


@pytest.fixture(scope="module", params=["cornell", "suzanne"])
def forward(request):
    """The JAX camera stage and JAX K7 (interpret, with residuals) on it."""
    pj, sj, cam_j, pt, st, cam_t, px, py = make_pair(request.param)
    key = jax.random.fold_in(jax.random.fold_in(rj.base_key(SEED), 0), 0)
    state, _, unif = jax.jit(
        lambda k: fbs_j(sj, cam_j, pj, k, jnp.asarray(px), jnp.asarray(py), 1024, "xla")
    )(key)
    packed = PFj(sj)
    out = fb_j(packed, sj.environment, state[0:3], state[3:6], state[6:9], state[9] != 0.0,
               unif, pj.epsilon, NB, interpret=True, with_residuals=True)
    return dict(sj=sj, st=st, packed=packed, eps=pj.epsilon,
                state=np.asarray(state), unif=np.asarray(unif),
                jax=[np.asarray(x) for x in out])


def test_k7_matches_jax_fused_bounces(forward):
    state, unif = (torch.tensor(forward[k]) for k in ("state", "unif"))
    pk = mk.PackedSceneFused(forward["st"])
    acc, cnt, states, ts, idxs = (
        x.numpy() for x in mk.fused_bounces(pk, state[0:3], state[3:6], state[6:9],
                                            state[9] != 0.0, unif, forward["eps"], NB,
                                            with_residuals=True))
    acc_j, cnt_j, states_j, ts_j, idxs_j = forward["jax"]
    lane_ok = (np.isclose(acc, acc_j, rtol=1e-4, atol=1e-5).all(axis=0)
               & (cnt == cnt_j) & (idxs == idxs_j).all(axis=0))
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    for got, ref in ((states, states_j), (ts, ts_j)):
        got, ref = got[:, lane_ok], ref[:, lane_ok]
        assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).mean() >= 0.99
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    assert cnt.sum() > state.shape[1]  # the paths went past their first bounce


def _segment_sum(sj, d_tri, d_sph):
    """replay.py's mat_id segment-sum: per-primitive table rows -> [M, 9]."""
    n_mat = sj.materials.ior.shape[0]
    g = np.zeros((9, n_mat), np.float64)
    for dtab, row0, mat_id in ((d_tri, 21, sj.triangles.mat_id),
                               (d_sph, 3, sj.spheres.mat_id)):
        mat_id = np.asarray(mat_id)
        if mat_id.size:
            onehot = (mat_id[:, None] == np.arange(n_mat)[None, :]).astype(np.float64)
            g += np.asarray(dtab, np.float64)[row0:row0 + 9, :mat_id.size] @ onehot
    return g.T


def test_k8_matches_jax_bounce_bwd_step(forward):
    _, _, states_j, ts_j, idxs_j = forward["jax"]
    pk = mk.PackedSceneFused(forward["st"])
    n = states_j.shape[1]
    gen = np.random.default_rng(SEED)
    for d in range(NB):
        cot = gen.normal(size=(13, n)).astype(np.float32)
        rows = slice(13 * d, 13 * d + 13)
        unif_d = forward["unif"][4 * d:4 * d + 4]
        ci_j, dtri_j, dsph_j, denv_j = (np.asarray(x) for x in bwd_j(
            forward["packed"], forward["sj"].environment, states_j[rows], ts_j[d], idxs_j[d],
            unif_d, cot, forward["eps"], interpret=True))
        dmat_j = _segment_sum(forward["sj"], dtri_j, dsph_j)
        ci, dmat, denv = (x.numpy() for x in mk.bounce_bwd_step(
            pk, torch.from_numpy(states_j[rows]), torch.from_numpy(ts_j[d]),
            torch.from_numpy(idxs_j[d]), torch.from_numpy(unif_d), torch.from_numpy(cot)))
        assert np.isfinite(ci).all() and np.isfinite(dmat).all()
        scale = np.abs(ci_j).max()
        lane_ok = np.isclose(ci, ci_j, rtol=1e-4, atol=1e-5 * scale).all(axis=0)
        assert lane_ok.mean() >= 0.99, (d, lane_ok.mean())
        np.testing.assert_allclose(dmat, dmat_j, rtol=0, atol=1e-4 * np.abs(dmat_j).max(),
                                   err_msg=f"bounce {d}")
        np.testing.assert_allclose(denv, denv_j, rtol=0, atol=1e-4 * max(np.abs(denv_j).max(), 1e-6))


def _port_value_and_grads(st, cam, p, key, px, py, w, kernel_bwd=True):
    mats = [m.clone().requires_grad_() for m in st.materials]
    env = st.environment.clone().requires_grad_()
    cam_l = [c.clone().requires_grad_() for c in cam]
    sc = st._replace(materials=type(st.materials)(*mats), environment=env)
    out = trace_pass_replay(sc, type(cam)(*cam_l), p, key, torch.from_numpy(px),
                            torch.from_numpy(py), kernel_bwd=kernel_bwd)
    v = torch.sum(out * torch.from_numpy(w))
    gs = torch.autograd.grad(v, mats + [env] + cam_l, allow_unused=True)
    return float(v), [np.zeros(x.shape, np.float32) if g is None else g.numpy()
                      for g, x in zip(gs, mats + [env] + cam_l)]


def _assert_grads_close(got, ref, rtol, names, noisy=()):
    """Each field within rtol (and rtol of its largest entry); fields named
    in ``noisy`` within 10x that."""
    for g, r, name in zip(got, ref, names):
        r = np.asarray(r)
        assert np.isfinite(g).all(), name
        tol = rtol * (10 if name in noisy else 1)
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_trace_pass_replay_value_and_grads_match_jax(name):
    pj, sj, cam_j, pt, st, cam_t, px, py = make_pair(name)
    w = np.random.default_rng(SEED).normal(size=(px.size, 3)).astype(np.float32)
    key_j = rj.pass_key(rj.base_key(SEED), 0)
    key_t = rt.pass_key(rt.base_key(SEED), 0)

    def f(m, c, e):
        sc = sj._replace(materials=m, environment=e)
        return jnp.sum(replay_j(sc, c, pj, key_j, jnp.asarray(px), jnp.asarray(py)) * w)

    v_j, (gm, gc, ge) = jax.jit(jax.value_and_grad(f, (0, 1, 2)))(
        sj.materials, cam_j, sj.environment)
    ref = list(gm) + [ge] + list(gc)
    v, got = _port_value_and_grads(st, cam_t, pt, key_t, px, py, w)
    np.testing.assert_allclose(v, float(v_j), rtol=1e-5)
    names = ([f"materials.{f}" for f in gm._fields] + ["environment"]
             + [f"camera.{f}" for f in gc._fields])
    _assert_grads_close(got, ref, 1e-4, names, noisy=("materials.ior",))
    assert max(np.abs(g).max() for g in got[:6]) > 0.0


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_kernel_backward_matches_plain_replay(name):
    """K8 (here its plain version) with the segment-free material sum
    against the plain replay of bounce_from_hits at the saved winners (the
    JAX package's tests/test_replay.py test of the same name)."""
    _, _, _, pt, st, cam_t, px, py = make_pair(name, side=8, seed=6)
    w = np.random.default_rng(6).normal(size=(px.size, 3)).astype(np.float32)
    key = rt.pass_key(rt.base_key(6), 0)
    v0, g0 = _port_value_and_grads(st, cam_t, pt, key, px, py, w, kernel_bwd=False)
    v1, g1 = _port_value_and_grads(st, cam_t, pt, key, px, py, w, kernel_bwd=True)
    np.testing.assert_allclose(v1, v0, rtol=1e-6)
    _assert_grads_close(g1, g0, 1e-5, [str(i) for i in range(len(g0))])


def test_emission_gradient_matches_finite_differences():
    """Emission enters the estimator linearly, so a central difference at
    fixed draws equals the gradient up to float32 noise: an anchor for K8's
    (here its plain version's) material gradient that does not lean on the
    JAX package (its tests/test_replay.py emission FD test)."""
    _, _, _, pt, st, cam_t, px, py = make_pair("cornell")
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(px.size, 3)).astype(np.float32))
    key = rt.pass_key(rt.base_key(SEED), 0)
    xs, ys = torch.from_numpy(px), torch.from_numpy(py)

    def loss(emission):
        sc = st._replace(materials=st.materials._replace(emission=emission))
        return torch.sum(trace_pass_replay(sc, cam_t, pt, key, xs, ys) * w)

    e0 = st.materials.emission.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(e0), [e0])
    gen = np.random.default_rng(2)
    for _ in range(2):
        de = torch.from_numpy(gen.normal(size=tuple(e0.shape)).astype(np.float32)) * 1e-2
        with torch.no_grad():
            fd = (float(loss(e0 + de)) - float(loss(e0 - de))) / 2.0
        ad = float(torch.sum(g * de))
        assert abs(fd - ad) < 2e-3 * max(abs(fd), 1.0), (fd, ad)


def test_recovers_albedo_on_the_replay_path():
    """Matched-RNG inverse rendering (tests/test_inverse_rendering.py's
    albedo case) through trace_pass_replay: the image is an analytic
    function of the materials at fixed draws, so descent recovers the
    albedo to 1e-3."""

    def build(albedo):
        sb = SceneBuilder()
        sb.add_sphere((0, 0, 4), 1.5, MaterialSpec.make_diffuse(albedo))
        sb.add_sphere((3, 3, 0), 2.0, MaterialSpec.make_light((6, 6, 6)))
        sb.set_environment_colour((0.05, 0.05, 0.05))
        return sb.build()

    params = RenderParams(width=16, height=16, first_bounce_u_samples=2,
                          first_bounce_v_samples=2, max_depth=3, seed=21,
                          intersector="kernel")
    camera = make_camera((0, 0, 0), (0, 0, 4), (0, 1, 0), 16, 16, 55.0)
    xs = torch.arange(256, dtype=torch.int32) % 16
    ys = torch.arange(256, dtype=torch.int32) // 16
    true_albedo = (0.7, 0.25, 0.45)
    key = rt.base_key(77)
    target = trace_pass_replay(build(true_albedo), camera, params, key, xs, ys)
    scene = build((0.3, 0.6, 0.2))
    diffuse = scene.materials.diffuse.clone()
    l0 = None
    for _ in range(40):
        d = diffuse.clone().requires_grad_()
        sc = scene._replace(materials=scene.materials._replace(diffuse=d))
        loss = torch.mean((trace_pass_replay(sc, camera, params, key, xs, ys) - target) ** 2)
        (g,) = torch.autograd.grad(loss, [d])
        diffuse = diffuse - 3.0 * g
        l0 = float(loss) if l0 is None else l0
    assert float(loss) < l0 * 1e-6
    np.testing.assert_allclose(diffuse[0].numpy(), true_albedo, atol=1e-3)
