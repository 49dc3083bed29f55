"""Path-replay differentiable rendering over kernel K7 (the training path).

The port of the JAX package's ``models/replay.py`` (``trace_pass_replay``):

  * FORWARD: the camera stage (``integrator._first_bounce_state``: kernel
    K2 and the K-fold first bounce, in PyTorch, differentiable), then all
    ``nb`` later bounces of the sample pass in ONE launch of K7
    (``ops/megakernel.fused_bounces``), which also writes each bounce's
    input state [13, N] and winner (t, packed idx).
    K7 culls its winner search by the window boxes of a
    ``PackedSceneStream`` (the winners are the unculled scan's bit for
    bit); the CPU's plain version scans every triangle.
  * BACKWARD: no re-intersection. Per bounce, in reverse, the VJP of the
    shading bounce at the SAVED state and winner: kernel K8
    (``bounce_bwd_step``, the adjoint written by hand in CUDA; on the CPU its
    plain version, ``torch.func.vjp`` of the same function), which also sums
    the material and environment gradients over lanes. ``kernel_bwd=False``
    instead replays ``integrator.bounce_from_hits`` under autograd at the
    saved winners (``_hits_from_saved``): the test oracle, as in the JAX
    package, chosen only by that argument. The winner distance's ray
    derivative is the implicit-function-theorem formula of K2's VJP
    (``ops/intersect_kernel.winner_t_vjp``).

``trace_passes_replay`` is the port of ``trace_passes_replay``, the
REGENERATING replay chain for ``n_passes`` samples at once:

  * FORWARD: one camera stage per sample (``integrator.regen_front``, the
    render's front end: K2 inside, differentiable), then ONE launch of K4
    in replay mode (``ops/megakernel.fused_passes_krng(replay=True)``): a
    dead lane reloads its next sample's first-bounce state, and every live
    iteration writes one residual slot (input state, winner, sample,
    depth). The launch culls its winner search by the window boxes of a
    ``PackedSceneStream`` at window 64; the radiance, counts and slots are
    bit-equal to an unculled launch. It runs without tail compaction, as in the JAX package (K4
    refuses replay with it): its threads take their lanes from a queue, so
    no warp idles behind its longest lane.
  * BACKWARD: kernel K9 (``regen_replay_bwd``) walks each lane's realized
    slots in reverse and returns the first-bounce states' cotangent, which
    autograd carries through the S camera stages (K2's VJP). The feedback
    sort's permutation lives inside the chain, residuals stay in sorted
    lane space, and every transpose is a gather. ``kernel_bwd=False``
    replays ``bounce_from_hits`` under autograd over the same slots: the
    test oracle.

Both chains take the geometry's pack (``packed``, a ``PackedSceneStream``:
Woop rows, window boxes, normals) built once per geometry, by the caller or
else per call, and refresh only its material rows each step
(``PackedSceneStream.with_materials``).

Estimator: the likelihood-ratio branch weight (``integrator.branch_weight``,
primal exactly 1) is applied in the replay; the discrete decisions (event
choice, winner, liveness) are constants; the zero-throughput kill is on, so
a material sitting exactly at 0 albedo gets no gradient through later
bounces (``parallel/train.py``'s ``fused="off"`` keeps that corner).
Reference for the estimator: src/dod/Scene.cpp:124-179.
"""

from __future__ import annotations

import math

import torch

from ..ops import kernel_rng as kr
from ..ops import rng
from ..ops.intersect import Hits, hits_from_winner
from ..ops.intersect_kernel import winner_t_vjp
from ..ops.megakernel import (
    PackedSceneStream,
    bounce_bwd_step,
    fused_bounces,
    fused_passes_krng,
    regen_replay_bwd,
)
from ..utils import tracing
from ..utils.render_params import RenderParams
from .integrator import (
    PathState,
    _first_bounce_state,
    bounce_from_hits,
    camera_stage,
    lane_ids_for,
    regen_front,
    resolve_intersector,
    sort_order,
)
from .materials import MaterialTable


class _WinnerT(torch.autograd.Function):
    """Identity on the saved winner distance, with the analytic ray
    derivative as its backward (t_saved and g are constants)."""

    @staticmethod
    def forward(ctx, org, dirn, t_saved, g):
        ctx.save_for_backward(dirn, t_saved, g)
        return t_saved.clone()

    @staticmethod
    def backward(ctx, t_bar):
        dirn, t, g = ctx.saved_tensors
        d_org, d_dir = winner_t_vjp(g, dirn, t, t_bar)
        return d_org, d_dir, None, None


def _hits_from_saved(scene, org, dirn, t_saved, pidx) -> Hits:
    """Differentiable Hits from a SAVED winner (t, packed idx), without a
    winner search; gradients reach (org, dirn) through ``_WinnerT``."""
    n_tri = scene.num_triangles
    hit = torch.isfinite(t_saved)
    tri_win = (pidx < n_tri) & hit
    zero = torch.zeros_like(pidx)
    i_t = torch.where(tri_win, pidx, zero)
    i_s = torch.where(tri_win | ~hit, zero, pidx - n_tri)
    og, dg = org.detach(), dirn.detach()
    if n_tri > 0:
        g_tri = scene.triangles.woop.reshape(n_tri, 12)[i_t.long(), 8:11].T
    else:
        g_tri = torch.zeros_like(og)
    if scene.num_spheres > 0:
        t0 = torch.where(hit, t_saved, torch.zeros_like(t_saved))
        g_sph = og + t0 * dg - scene.spheres.centre[i_s.long()].T
    else:
        g_sph = torch.zeros_like(og)
    g = torch.where(tri_win, g_tri, g_sph).detach()
    t = _WinnerT.apply(org, dirn, t_saved, g)
    return hits_from_winner(scene, org, dirn, t, tri_win, i_t, i_s)


def _rows_to_state(rows) -> PathState:
    return PathState(org=rows[0:3], dirn=rows[3:6], beta=rows[6:9],
                     acc=rows[10:13], alive=rows[9] != 0.0)


def _state_to_rows(st: PathState):
    return torch.cat([st.org, st.dirn, st.beta, st.alive.to(torch.float32)[None, :],
                      st.acc], dim=0)


class _Chain(torch.autograd.Function):
    """The nb-bounce chain of one sample pass: K7 with residuals forward,
    the per-bounce replay VJP backward. Inputs: the five material fields,
    the environment, the first-bounce state [13, N] and the uniforms
    [nb, 4, N]; ``geo_scene`` carries the (constant) geometry and
    ``geo_pack`` its ``PackedSceneStream``."""

    @staticmethod
    def forward(ctx, emission, diffuse, ior, reflectivity, cone_angle, environment,
                state0_rows, unifs, geo_scene, geo_pack, nb, eps, kernel_bwd):
        mats = MaterialTable(emission, diffuse, ior, reflectivity, cone_angle)
        pk = geo_pack.with_materials(mats, environment)
        n = state0_rows.shape[1]
        r = state0_rows
        acc, _, states, ts, idxs = fused_bounces(
            pk, r[0:3], r[3:6], r[6:9], r[9] != 0.0, unifs.reshape(4 * nb, n), eps, nb,
            with_residuals=True,
        )
        # the kernel accumulates from zero: add state0's acc rows back
        acc = acc + r[10:13]
        states.view(nb, 13, n)[:, 10:13] += r[10:13]
        ctx.save_for_backward(*mats, environment, unifs, states, ts, idxs)
        ctx.pk = pk
        ctx.geo_scene = geo_scene
        ctx.nb = nb
        ctx.kernel_bwd = kernel_bwd
        return acc

    @staticmethod
    def backward(ctx, acc_bar):
        *mats, env, unifs, states, ts, idxs = ctx.saved_tensors
        nb = ctx.nb
        n = acc_bar.shape[1]
        cot = torch.cat([acc_bar.new_zeros((10, n)), acc_bar])
        states = states.view(nb, 13, n)
        if ctx.kernel_bwd:
            pk = ctx.pk
            d_mat = torch.zeros((pk.n_mat, 9), dtype=torch.float32, device=cot.device)
            d_env = torch.zeros((3,), dtype=torch.float32, device=cot.device)
            for d in reversed(range(nb)):
                cot, dm, de = bounce_bwd_step(pk, states[d], ts[d], idxs[d], unifs[d], cot)
                d_mat = d_mat + dm
                d_env = d_env + de
            grads = (d_mat[:, 0:3], d_mat[:, 3:6], d_mat[:, 6], d_mat[:, 7], d_mat[:, 8])
            grads = tuple(g.to(m.dtype) for g, m in zip(grads, mats))
            return (*grads, d_env.to(env.dtype), cot, None, None, None, None, None, None)
        with torch.enable_grad():
            leaves = [m.detach().requires_grad_() for m in (*mats, env)]
            total = [torch.zeros_like(x) for x in leaves]
            scene = ctx.geo_scene._replace(materials=MaterialTable(*leaves[:5]),
                                           environment=leaves[5])
            for d in reversed(range(nb)):
                rows = states[d].detach().requires_grad_()
                st = _rows_to_state(rows)
                hits = _hits_from_saved(scene, st.org, st.dirn, ts[d], idxs[d])
                u = unifs[d]  # (u, acos u, v, p): the replay consumes (u, v, p)
                new = bounce_from_hits(scene, st, hits, u[0], u[2], u[3], kill_dead=True)
                gs = torch.autograd.grad(_state_to_rows(new), (*leaves, rows), cot,
                                         allow_unused=True)
                for i, g in enumerate(gs[:6]):
                    if g is not None:
                        total[i] = total[i] + g
                cot = gs[6] if gs[6] is not None else torch.zeros_like(cot)
        return (*total, cot, None, None, None, None, None, None)


def trace_pass_replay(scene, camera, params: RenderParams, key, px, py,
                      tri_chunk: int = 1024, with_ray_count: bool = False,
                      kernel_bwd: bool = True, packed=None):
    """Differentiable 1-spp pass with the K7 forward: a drop-in for
    ``integrator.trace_pass`` on the training path (same RNG streams, same
    estimator, zero-throughput kill always on). Differentiable w.r.t.
    scene.materials, scene.environment and the camera. Needs the kernel
    backend (CUDA kernels on the card, their plain versions on the CPU).
    ``packed``: the geometry's ``PackedSceneStream`` (built here when
    None). The camera part, K7's uniforms included, is
    ``integrator._first_bounce_state`` (traced as ``pt3.camera``)."""
    k = params.first_bounce_samples
    r0 = px.shape[0]
    dev = px.device
    backend = resolve_intersector(params, dev)
    if backend != "kernel":
        raise ValueError("trace_pass_replay needs the kernel intersector")

    geo = packed if packed is not None else PackedSceneStream(scene)
    if params.preview:
        _, hits0, mat0 = camera_stage(scene, camera, params, key, px, py, tri_chunk, backend,
                                      geo)
        return torch.where(hits0.hit, mat0.diffuse, scene.environment[:, None].expand(3, r0)).T
    nb = max(params.max_depth - 1, 0)
    # the materials change every step: no pack's glossy flag holds for them
    rows, base, unif_rows = _first_bounce_state(scene, camera, params, key, px, py, tri_chunk,
                                                backend, want_unif=nb > 0, packed=geo)

    with tracing.span("pt3.sync.nrays"):  # a copy from host memory waits for the card
        nrays = torch.tensor(r0, dtype=torch.int64, device=dev)
    if nb == 0:
        acc = torch.zeros((3, r0 * k), device=dev)
    else:
        state0_rows = torch.cat([rows, torch.zeros((3, r0 * k), device=dev)])  # [13, R*K]
        m = scene.materials
        acc = _Chain.apply(m.emission, m.diffuse, m.ior, m.reflectivity, m.cone_angle,
                           scene.environment, state0_rows,
                           unif_rows.reshape(nb, 4, r0 * k), scene, geo, nb,
                           float(params.epsilon), kernel_bwd)
        # live-lane count: the lanes alive into bounce 1 (the later bounces
        # are counted inside the chain and not returned, as in the JAX package)
        nrays = nrays + (rows[9] != 0.0).sum()

    # a lane that missed never lived: its path mean is exactly 0
    radiance = (base + acc.reshape(3, r0, k).mean(dim=2)).T
    if with_ray_count:
        return radiance, nrays
    return radiance


def _regen_oracle(geo_scene, mats, env, lane_ids, key_words, sample0, resid, cnt,
                  acc_bar, s_count):
    """The regenerating chain's backward without K9: the same reverse walk
    (slots from the last down, a lane active while j < cnt, the cotangent
    reset at sample changes), each bounce replayed through
    ``bounce_from_hits`` at its saved winner under autograd. Inactive lanes
    get a zero state with a unit direction (the plain bounce has no guards
    for a zero one). Returns (five material gradients, d_env, d_state0)."""
    n = acc_bar.shape[1]
    dev = acc_bar.device
    f32 = dict(dtype=torch.float32, device=dev)
    cnt = cnt.to(torch.int64)
    seeds = torch.tensor(kr.channel_seeds(int(key_words[0]), int(key_words[1])),
                         dtype=torch.int64, device=dev).reshape(3, 1)
    hlane = kr.mul32(lane_ids.to(torch.int64) & 0xFFFFFFFF, kr._IN_P1)
    cot = torch.cat([torch.zeros((10, n), **f32), acc_bar])
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    d0 = torch.zeros((s_count, 10, n), **f32)
    lanes = torch.arange(n, device=dev)
    with torch.enable_grad():
        leaves = [m.detach().requires_grad_() for m in (*mats, env)]
        total = [torch.zeros_like(x) for x in leaves]
        scene = geo_scene._replace(materials=MaterialTable(*leaves[:5]), environment=leaves[5])
        for j in reversed(range(resid.shape[0])):
            active = j < cnt
            if not bool(active.any()):
                continue
            blk = resid[j]
            s = torch.where(active, blk[11].to(torch.int64), 0)
            d = torch.where(active, blk[12].to(torch.int64), 1)
            newseg = active & (s != prev)
            cot = torch.cat([torch.where(newseg, 0.0, cot[0:10]), cot[10:13]])
            u, v, p = kr.event_uniforms_premixed(
                ((hlane + kr.sd_term(sample0, s, d)) & 0xFFFFFFFF)[None, :], seeds)
            rows = torch.cat([
                torch.where(active, blk[0:5], 0.0), torch.where(active, blk[5], 1.0)[None],
                torch.where(active, blk[6:9], 0.0), active.to(torch.float32)[None],
                torch.zeros((3, n), **f32)]).requires_grad_()
            st = _rows_to_state(rows)
            t = torch.where(active, blk[9], math.inf)
            pidx = torch.where(active, blk[10], 0.0).to(torch.int32)
            hits = _hits_from_saved(scene, st.org, st.dirn, t, pidx)
            new = bounce_from_hits(scene, st, hits, u, v, p, kill_dead=True)
            gs = torch.autograd.grad(_state_to_rows(new), (*leaves, rows), cot,
                                     allow_unused=True)
            for i, g in enumerate(gs[:6]):
                if g is not None:
                    total[i] = total[i] + g
            cin = gs[6] if gs[6] is not None else torch.zeros_like(cot)
            start = active & (d == 1)
            d0[s[start], 0:9, lanes[start]] = cin[0:9, start].T
            cot = torch.where(active, cin, cot)
            prev = torch.where(active, s, prev)
    return (*total, d0.reshape(s_count * 10, n))


def _regen_launch(pk, state0, lane_ids, key_words, sample0, order, inv, eps, nb,
                  s_count, replay):
    """K4 on the feedback sort's lane order (``order``; ``inv`` unsorts the
    outputs). With ``replay`` also the residuals and the lane ids, both in
    sorted lane space, and the counter ``k4.replay_slots``."""
    if order is not None:
        state0 = state0[:, order]
        lane_ids = lane_ids[order]
    out = fused_passes_krng(pk, state0, lane_ids, key_words, sample0, eps, nb, s_count,
                            replay=replay)
    acc, cnt = out[0], out[1]
    if replay:  # a lane's count is its realized slots (and its live bounces)
        tracing.count("k4.replay_slots", cnt)
    if order is not None:
        acc = acc[:, inv]
        cnt = cnt[inv]
    return (acc, cnt, out[2], out[1], lane_ids) if replay else (acc, cnt)


class _RegenChain(torch.autograd.Function):
    """S regenerating passes of every lane: K4 in replay mode forward, the
    reverse walk backward (K9, or ``_regen_oracle`` when ``kernel_bwd`` is
    False). Inputs: the five material fields, the environment and the
    first-bounce states [S*10, N]; the lane ids, key words, sample0, the
    feedback sort's (order, inv) and the (constant) geometry and its
    ``PackedSceneStream`` ride along. Outputs: acc [3, N] and the per-lane
    counts [N] (not differentiable)."""

    @staticmethod
    def forward(ctx, emission, diffuse, ior, reflectivity, cone_angle, environment,
                state0, lane_ids, key_words, sample0, order, inv, geo_scene, geo_pack, nb,
                s_count, eps, kernel_bwd):
        mats = MaterialTable(emission, diffuse, ior, reflectivity, cone_angle)
        pk = geo_pack.with_materials(mats, environment)
        acc, cnt, resid, cnt_sorted, lanes_sorted = _regen_launch(
            pk, state0, lane_ids, key_words, sample0, order, inv, eps, nb, s_count, True)
        ctx.save_for_backward(*mats, environment, lanes_sorted, resid, cnt_sorted)
        ctx.pk = pk
        ctx.geo_scene = geo_scene
        ctx.key_words = key_words
        ctx.sample0 = sample0
        ctx.order, ctx.inv = order, inv
        ctx.s_count = s_count
        ctx.kernel_bwd = kernel_bwd
        ctx.mark_non_differentiable(cnt)
        return acc, cnt

    @staticmethod
    def backward(ctx, acc_bar, _cnt_bar):
        *mats, env, lane_ids, resid, cnt = ctx.saved_tensors
        if ctx.order is not None:
            acc_bar = acc_bar[:, ctx.order]  # into the residuals' sorted lane space
        acc_bar = acc_bar.to(torch.float32).contiguous()
        if ctx.kernel_bwd:
            d_state0, d_mat, d_env = regen_replay_bwd(ctx.pk, lane_ids, ctx.key_words,
                                                      ctx.sample0, resid, cnt, acc_bar,
                                                      ctx.s_count)
            grads = (d_mat[:, 0:3], d_mat[:, 3:6], d_mat[:, 6], d_mat[:, 7], d_mat[:, 8])
            grads = tuple(g.to(m.dtype) for g, m in zip(grads, mats))
            d_env = d_env.to(env.dtype)
        else:
            *grads, d_env, d_state0 = _regen_oracle(
                ctx.geo_scene, mats, env, lane_ids, ctx.key_words, ctx.sample0, resid, cnt,
                acc_bar, ctx.s_count)
        if ctx.order is not None:
            d_state0 = d_state0[:, ctx.inv]
        return (*grads, d_env, d_state0) + (None,) * 11


def trace_passes_replay(scene, camera, params: RenderParams, base_key, sample0: int,
                        tile_idx: int, px, py, n_passes: int, tri_chunk: int = 1024,
                        with_ray_count: bool = False, kernel_bwd: bool = True,
                        sort_key=None, with_lane_counts: bool = False, packed=None):
    """Differentiable ``n_passes`` sample passes through the REGENERATING
    replay chain: the training-path drop-in for
    ``integrator.trace_passes_fused`` (kernel RNG, no tail compaction),
    whose radiance it equals bit for bit. Returns the radiance SUM over the
    passes [R, 3]; differentiable w.r.t. scene.materials, scene.environment
    and the camera. Keys follow fold(fold(base_key, sample0 + s), tile_idx).

    ``sort_key`` [R*K]: the feedback work-sort (bit-exact for the radiance,
    exact for gradients: the permutation is applied inside the chain).
    ``with_ray_count`` adds camera rays + live bounces; ``with_lane_counts``
    this call's per-lane bounce counts, to chain into the next sort key. A
    forward that needs no gradient launches K4 without residuals.
    ``packed``: the geometry's ``PackedSceneStream`` (built here when
    None)."""
    dev = px.device
    if resolve_intersector(params, dev) != "kernel" or params.preview:
        raise ValueError("trace_passes_replay needs the kernel intersector, no preview")
    nb = max(params.max_depth - 1, 0)
    k = params.first_bounce_samples
    r0 = px.shape[0]

    geo = packed if packed is not None else PackedSceneStream(scene)
    # the materials change every step: no pack's glossy flag holds for them
    base_sum, state0, _ = regen_front(scene, camera, params, base_key, sample0, tile_idx, px,
                                      py, n_passes, tri_chunk, geo, False)
    with tracing.span("pt3.sync.nrays"):
        nrays = torch.tensor(n_passes * r0, dtype=torch.int64, device=dev)
    cnt = torch.zeros((r0 * k,), dtype=torch.int32, device=dev)
    if nb == 0:
        radiance = base_sum.T
    else:
        lane_ids = lane_ids_for(px, py, params.width, k)
        order, inv = sort_order(sort_key) if sort_key is not None else (None, None)
        kw = kr.key_words(rng.stream_key(base_key, rng.KERNEL_RNG_STREAM))
        m = scene.materials
        diff = (m.emission, m.diffuse, m.ior, m.reflectivity, m.cone_angle,
                scene.environment, state0)
        eps = float(params.epsilon)
        if torch.is_grad_enabled() and any(x.requires_grad for x in diff):
            acc, cnt = _RegenChain.apply(*diff, lane_ids, kw, sample0, order, inv, scene, geo,
                                         nb, n_passes, eps, kernel_bwd)
        else:
            acc, cnt = _regen_launch(geo.with_materials(m, scene.environment), state0,
                                     lane_ids, kw, sample0, order, inv, eps, nb, n_passes,
                                     False)
        path_mean = acc.reshape(3, r0, k).mean(dim=2)
        radiance = (base_sum + path_mean).T
        nrays = nrays + cnt.sum()
    out = (radiance,)
    if with_ray_count:
        out = out + (nrays,)
    if with_lane_counts:
        out = out + (cnt,)
    return out if len(out) > 1 else radiance
