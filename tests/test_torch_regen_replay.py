"""The regenerating replay training path (``models/replay.trace_passes_replay``:
K4 in replay mode forward, K9's reverse walk backward) against the JAX
package's, on the CPU, at the JAX package's own sizes for it
(tests/test_replay.py ``_setup_regen``: side 10, K = 2x2, depth 4, S = 3).

The JAX scene and camera are carried into the port
(``models/scene.from_jax_arrays``); the JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions (``intersector=
"kernel"`` on CPU tensors).

  * K4's replay mode against the JAX kernel's on the same first-bounce
    states: per lane ``acc`` within rtol 1e-4 / atol 1e-5, ``cnt`` equal to
    the number of JAX slots with s < S, on >= 99 % of lanes (a near-tie may
    flip a winner, as in tests/test_torch_megakernel_krng.py); on those
    lanes the port's slots j < cnt hold the JAX slots' values within rtol
    1e-4 / atol 1e-5 for >= 99 % of values and all within 1e-3 (on cornell
    a glossy cone sample's direction, and the positions and distances after
    it, differ by up to 2.4e-4 between the two roundings, as K7's residuals
    do in tests/test_torch_replay.py); ``acc`` and ``cnt`` bit-equal to K4
    without replay.
  * K9 against the JAX ``regen_replay_bwd`` plus ``replay.py``'s mat_id
    segment-sum, on the JAX forward's own residuals: ``d_state0`` within
    rtol 1e-4 / atol 1e-5 of its largest on >= 99 % of lanes, material and
    environment gradients within 1e-4 of their largest entry.
  * ``trace_passes_replay``: the radiance bit-equal to the port's
    ``trace_passes_fused`` (kernel RNG, no tail, no sort); the value within
    rtol 1e-5 and the gradients (materials, environment, camera) within
    1e-4 of each field's largest entry of the JAX package's (ior 1e-3, the
    rounding noise of an ior-1 Fresnel material, tests/test_torch_replay.py;
    the camera centre 1e-3: on cornell its net gradient, 7e-4, is what is
    left of per-lane terms that cancel, and the two packages' float32 sums
    in other orders leave 2.3e-7 of it, 3e-7 of the largest camera
    gradient), over the pixels whose paths take the same winners in both packages
    (>= 99 %; ``_agreeing_pixels``);
    K9 against the autograd oracle (``kernel_bwd=False``) within 5e-5; the
    fused S-sample gradient equal to the sum of S single-sample gradients
    within 1e-5; the emission gradient against central finite differences;
    ``sort_key``: the radiance bit-equal, gradients within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt_three_ways_tpu.models.integrator import _first_bounce_state as fbs_j
from pt_three_ways_tpu.models.replay import trace_passes_replay as regen_j
from pt_three_ways_tpu.ops import kernel_rng as krj
from pt_three_ways_tpu.ops import rng as rj
from pt_three_ways_tpu.ops.pallas_megakernel import RRES
from pt_three_ways_tpu.ops.pallas_megakernel import PackedSceneFused as PFj
from pt_three_ways_tpu.ops.pallas_megakernel import fused_passes_krng as fk_j
from pt_three_ways_tpu.ops.pallas_megakernel import regen_replay_bwd as bwd_j
from pt_three_ways_tpu_torch.models.integrator import lane_ids_for, trace_passes_fused
from pt_three_ways_tpu_torch.models.replay import trace_passes_replay
from pt_three_ways_tpu_torch.ops import kernel_rng as krt
from pt_three_ways_tpu_torch.ops import megakernel as mk
from pt_three_ways_tpu_torch.ops import rng as rt
from test_torch_replay import _assert_grads_close, _segment_sum, make_pair
from test_torch_megakernel import one_torch_thread  # noqa: F401 (autouse fixture)

SIDE = 10
NB = 3  # max_depth 4
S = 3
SEED = 9


def _pair(name):
    return make_pair(name, side=SIDE, max_depth=NB + 1, seed=SEED)


def _weights(n, seed=SEED):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _value_and_grads(st, cam, p, px, py, w, sample0=0, n_passes=S, **kw):
    """sum(trace_passes_replay * w) and its gradients w.r.t. the five
    material fields, the environment and every camera field."""
    mats = [m.clone().requires_grad_() for m in st.materials]
    env = st.environment.clone().requires_grad_()
    cam_l = [c.clone().requires_grad_() for c in cam]
    sc = st._replace(materials=type(st.materials)(*mats), environment=env)
    out = trace_passes_replay(sc, type(cam)(*cam_l), p, rt.base_key(SEED), sample0, 0,
                              torch.from_numpy(px), torch.from_numpy(py), n_passes, **kw)
    extra = None
    if isinstance(out, tuple):
        out, extra = out[0], out[1:]
    v = torch.sum(out * torch.from_numpy(w))
    gs = torch.autograd.grad(v, mats + [env] + cam_l, allow_unused=True)
    grads = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
             for g, x in zip(gs, mats + [env] + cam_l)]
    return out.detach(), float(v), grads, extra


@pytest.fixture(scope="module", params=["cornell", "suzanne"])
def regen(request):
    """The JAX camera stage for S passes, and JAX K4 in replay mode on it."""
    pj, sj, cam_j, pt, st, cam_t, px, py = _pair(request.param)
    fbs = jax.jit(lambda k: fbs_j(sj, cam_j, pj, k, jnp.asarray(px), jnp.asarray(py), 1024,
                                  "xla", want_unif=False)[0])
    base = rj.base_key(SEED)
    state0 = np.concatenate([np.asarray(fbs(jax.random.fold_in(jax.random.fold_in(base, s), 0)))
                             for s in range(S)])
    lanes = lane_ids_for(torch.from_numpy(px), torch.from_numpy(py), SIDE, 4)
    kw_j = krj.key_words(rj.stream_key(base, rj.KERNEL_RNG_STREAM))
    kw_t = krt.key_words(rt.stream_key(rt.base_key(SEED), rt.KERNEL_RNG_STREAM))
    packed = PFj(sj)
    acc_j, cnt_j, res_j, nit_j = fk_j(packed, sj.environment, jnp.asarray(state0),
                                      jnp.asarray(lanes.numpy()), kw_j, 0, pj.epsilon, NB, S,
                                      interpret=True, replay=True)
    return dict(sj=sj, st=st, packed=packed, eps=pj.epsilon, state0=state0, lanes=lanes,
                kw_j=kw_j, kw_t=kw_t,
                jax=[np.asarray(x) for x in (acc_j, cnt_j, res_j, nit_j)])


def test_k4_replay_matches_jax(regen):
    pk = mk.PackedSceneFused(regen["st"])
    s0 = torch.from_numpy(regen["state0"])
    args = (pk, s0, regen["lanes"], regen["kw_t"], 0, regen["eps"], NB, S)
    acc, cnt, res = mk.fused_passes_krng(*args, replay=True)
    acc0, cnt0 = mk.fused_passes_krng(*args)
    assert torch.equal(acc, acc0) and torch.equal(cnt, cnt0)
    acc, cnt, res = acc.numpy(), cnt.numpy(), res.numpy()
    acc_j, cnt_j, res_j, _ = regen["jax"]
    n = acc.shape[1]
    assert res.shape == (S * NB, 13, n)
    slots_j = res_j[:, :n].reshape(S * NB, RRES, n)[:, :13]  # [slot, row, lane]
    live_j = (slots_j[:, 11] < S).sum(axis=0)
    np.testing.assert_array_equal(cnt_j, live_j)
    j = np.arange(S * NB)[:, None]
    real = j < cnt[None, :]
    assert (res[:, 11][real] < S).all() and (res[:, 12][real] >= 1).all()
    assert (res[~np.broadcast_to(real[:, None, :], res.shape)] == 0).all()  # unwritten
    lane_ok = np.isclose(acc, acc_j, rtol=1e-4, atol=1e-5).all(axis=0) & (cnt == cnt_j)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    slot_ok = np.broadcast_to((real & lane_ok[None, :])[:, None, :], res.shape)
    got, ref = res[slot_ok], slots_j[slot_ok]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).mean() >= 0.99
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    assert cnt.sum() > n  # paths went on past their first bounce and refilled
    with pytest.raises(ValueError):
        mk.fused_passes_krng(*args, replay=True, stream=True)


def test_k4_replay_culled_matches_uncull_bitwise(regen):
    """K4 replay's culled search (the window boxes of a PackedSceneStream
    at window 64) takes the unculled scan's winners: slots, counts and
    ``acc`` bit for bit."""
    s0 = torch.from_numpy(regen["state0"])
    args = (s0, regen["lanes"], regen["kw_t"], 0, regen["eps"], NB, S)
    full = mk.fused_passes_krng(mk.PackedSceneFused(regen["st"]), *args, replay=True)
    culled_pk = mk.PackedSceneStream(regen["st"], window=64)
    calls = []
    search = mk.stream_search_plain

    def counted(*a, **kw):
        calls.append(1)
        return search(*a, **kw)

    mk.stream_search_plain = counted
    try:
        culled = mk.fused_passes_krng(culled_pk, *args, replay=True)
    finally:
        mk.stream_search_plain = search
    assert calls  # the culled search ran
    for got, want in zip(culled, full):
        assert torch.equal(got, want)


@pytest.mark.parametrize("levels", [1, 2])
def test_k4_replay_refuses_tail_compaction(regen, levels):
    """K4's replay mode runs without tail compaction, as the JAX package's
    does: a launch that asks for both raises ``ValueError``, at one level
    of continuations or two."""
    s0 = torch.from_numpy(regen["state0"])
    args = (s0, regen["lanes"], regen["kw_t"], 0, regen["eps"], NB, S)
    pk = mk.PackedSceneStream(regen["st"], window=64)
    with pytest.raises(ValueError, match="tail compaction"):
        mk.fused_passes_krng(pk, *args, replay=True, tail_frac=0.125, tail_levels=levels,
                             block=32)


@pytest.mark.parametrize("shuffled", [False, True])
def test_k9_matches_jax_regen_replay_bwd(regen, shuffled):
    """``shuffled``: the port walks the lanes in a random order (the lane ids,
    slots, counts and cotangents permuted alike), so that the counts within
    each group of 32 lanes differ as in an unsorted chain; its d_state0 is
    permuted back before the comparison."""
    acc_j, cnt_j, res_j, nit_j = regen["jax"]
    n = acc_j.shape[1]
    acc_bar = np.random.default_rng(SEED).normal(size=(3, n)).astype(np.float32)
    d0_j, dtri_j, dsph_j, denv_j = (np.asarray(x) for x in bwd_j(
        regen["packed"], regen["sj"].environment, jnp.asarray(regen["lanes"].numpy()),
        regen["kw_j"], 0, jnp.asarray(res_j), jnp.asarray(nit_j), jnp.asarray(acc_bar),
        regen["eps"], NB, S, interpret=True))
    dmat_j = _segment_sum(regen["sj"], dtri_j, dsph_j)
    # the JAX slots in the port's layout (rows 0..12 of each RRES block)
    res = np.ascontiguousarray(res_j[:, :n].reshape(S * NB, RRES, n)[:, :13])
    pk = mk.PackedSceneFused(regen["st"])
    perm = np.random.default_rng(SEED).permutation(n) if shuffled else np.arange(n)
    if shuffled:
        assert any(len(set(cnt_j[perm[i:i + 32]])) > 1 for i in range(0, n, 32))
    d0, dmat, denv = (x.numpy() for x in mk.regen_replay_bwd(
        pk, regen["lanes"][perm], regen["kw_t"], 0, torch.from_numpy(res[:, :, perm]),
        torch.from_numpy(cnt_j[perm]), torch.from_numpy(acc_bar[:, perm]), S))
    d0[:, perm] = d0.copy()
    assert mk.regen_replay_bwd.launches == 0
    assert np.isfinite(d0).all() and np.isfinite(dmat).all()
    assert (d0.reshape(S, 10, n)[:, 9] == 0).all()
    scale = np.abs(d0_j).max()
    lane_ok = np.isclose(d0, d0_j, rtol=1e-4, atol=1e-5 * scale).all(axis=0)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    np.testing.assert_allclose(dmat, dmat_j, rtol=0, atol=1e-4 * np.abs(dmat_j).max())
    np.testing.assert_allclose(denv, denv_j, rtol=0, atol=1e-4 * max(np.abs(denv_j).max(), 1e-6))


def _agreeing_pixels(pj, sj, cam_j, st, cam_t, pt, px, py):
    """Pixels whose S paths take the same winners in both packages. A
    material without emission hides a path that took another winner, so
    both render with every material emissive (a distinct colour each):
    a path that differs shows in its pixel. On cornell one lane of pixel 8
    differs: the JAX interpret-mode kernel, whose triangle reciprocal starts
    from a bfloat16 estimate, puts a hit point 1.9e-5 from the port's, and
    the next bounce re-hits the same triangle at t = 1.2e-4, just above the
    epsilon. Such a lane moves the emission gradient of a black material by
    a few per cent, far outside the gradient gates."""
    n_mat = int(st.materials.ior.shape[0])
    glow = (np.arange(1, n_mat + 1)[:, None] * np.array([[0.1, 0.2, 0.3]])).astype(np.float32)
    sjg = sj._replace(materials=sj.materials._replace(emission=jnp.asarray(glow)))
    stg = st._replace(materials=st.materials._replace(emission=torch.from_numpy(glow)))
    img_j = np.asarray(jax.jit(lambda: regen_j(sjg, cam_j, pj, rj.base_key(SEED), 0, 0,
                                               jnp.asarray(px), jnp.asarray(py), S))())
    img_t = trace_passes_replay(stg, cam_t, pt, rt.base_key(SEED), 0, 0, torch.from_numpy(px),
                                torch.from_numpy(py), S).numpy()
    ok = np.isclose(img_t, img_j, rtol=1e-4, atol=1e-5).all(axis=1)
    assert ok.mean() >= 0.99, ok.mean()
    return ok


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_trace_passes_replay_matches_jax_and_production_forward(name):
    pj, sj, cam_j, pt, st, cam_t, px, py = _pair(name)
    w = _weights(px.size) * _agreeing_pixels(pj, sj, cam_j, st, cam_t, pt, px, py)[:, None]
    base_j = rj.base_key(SEED)

    def f(m, c, e):
        sc = sj._replace(materials=m, environment=e)
        return jnp.sum(regen_j(sc, c, pj, base_j, 0, 0, jnp.asarray(px), jnp.asarray(py), S) * w)

    v_j, (gm, gc, ge) = jax.jit(jax.value_and_grad(f, (0, 1, 2)))(
        sj.materials, cam_j, sj.environment)
    out, v, got, _ = _value_and_grads(st, cam_t, pt, px, py, w)
    ref = trace_passes_fused(st, cam_t, pt, rt.base_key(SEED), 0, 0, torch.from_numpy(px),
                             torch.from_numpy(py), S)
    assert torch.equal(out, ref)  # K4 with replay residuals = the production forward
    np.testing.assert_allclose(v, float(v_j), rtol=1e-5)
    names = ([f"materials.{f}" for f in gm._fields] + ["environment"]
             + [f"camera.{f}" for f in gc._fields])
    _assert_grads_close(got, list(gm) + [ge] + list(gc), 1e-4, names,
                        noisy=("materials.ior", "camera.centre"))
    assert max(np.abs(g).max() for g in got[:6]) > 0.0


@pytest.mark.parametrize("name", ["cornell", "suzanne"])
def test_kernel_backward_matches_autograd_oracle(name):
    """K9 (here its plain version) against the reverse walk replayed
    through bounce_from_hits under autograd (the JAX package's
    test_regen_replay_kernel_backward_matches_xla_backward)."""
    _, _, _, pt, st, cam_t, px, py = _pair(name)
    w = _weights(px.size)
    _, v0, g0, _ = _value_and_grads(st, cam_t, pt, px, py, w, kernel_bwd=False)
    _, v1, g1, _ = _value_and_grads(st, cam_t, pt, px, py, w, kernel_bwd=True)
    np.testing.assert_allclose(v1, v0, rtol=1e-6)
    _assert_grads_close(g1, g0, 5e-5, [str(i) for i in range(len(g0))])


def test_fused_gradient_equals_sum_of_single_sample_gradients():
    """The draws depend only on (lane, sample, depth), so for a linear loss
    the S-sample chain's gradient is the sum of S one-sample chains': any
    error in the reverse walk's sample-boundary resets breaks this."""
    _, _, _, pt, st, cam_t, px, py = _pair("cornell")
    w = _weights(px.size)
    _, _, fused, _ = _value_and_grads(st, cam_t, pt, px, py, w)
    singles = [_value_and_grads(st, cam_t, pt, px, py, w, sample0=s, n_passes=1)[2]
               for s in range(S)]
    for i, g in enumerate(fused[:6]):
        total = sum(sg[i] for sg in singles)
        scale = max(np.abs(total).max(), 1e-4)
        np.testing.assert_allclose(g, total, rtol=1e-5, atol=1e-5 * scale, err_msg=str(i))


def test_emission_gradient_matches_finite_differences():
    """Emission enters linearly, so a central difference at fixed draws
    equals the gradient up to float32 noise: an anchor that does not lean
    on the JAX package."""
    _, _, _, pt, st, cam_t, px, py = _pair("cornell")
    w = torch.from_numpy(_weights(px.size, 1))
    xs, ys = torch.from_numpy(px), torch.from_numpy(py)

    def loss(emission):
        sc = st._replace(materials=st.materials._replace(emission=emission))
        return torch.sum(trace_passes_replay(sc, cam_t, pt, rt.base_key(SEED), 0, 0, xs, ys,
                                             S) * w)

    e0 = st.materials.emission.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(e0), [e0])
    gen = np.random.default_rng(2)
    for _ in range(2):
        de = torch.from_numpy(gen.normal(size=tuple(e0.shape)).astype(np.float32)) * 1e-2
        with torch.no_grad():
            fd = (float(loss(e0 + de)) - float(loss(e0 - de))) / 2.0
        ad = float(torch.sum(g * de))
        assert abs(fd - ad) < 2e-3 * max(abs(fd), 1.0), (fd, ad)


def test_sort_key_is_exact():
    """The feedback sort permutes lanes inside the chain: the radiance is
    bit-equal, the gradients equal up to float32 summation order; the lane
    counts come back in unsorted lane order and chain into the next key."""
    _, _, _, pt, st, cam_t, px, py = _pair("suzanne")
    w = _weights(px.size)
    out0, v0, g0, (cnt0,) = _value_and_grads(st, cam_t, pt, px, py, w, with_lane_counts=True)
    key = cnt0 + torch.from_numpy(np.random.default_rng(3).integers(0, 4, cnt0.shape[0]))
    out1, v1, g1, (cnt1,) = _value_and_grads(st, cam_t, pt, px, py, w, sort_key=key,
                                             with_lane_counts=True)
    assert torch.equal(out1, out0) and torch.equal(cnt1, cnt0)
    _assert_grads_close(g1, g0, 1e-5, [str(i) for i in range(len(g0))])
    _, _, _, (nrays,) = _value_and_grads(st, cam_t, pt, px, py, w, with_ray_count=True)
    assert int(nrays) == S * px.size + int(cnt0.sum())
