"""Path-replay differentiable rendering over kernel K7 (the training path).

The port of the JAX package's ``models/replay.py`` (``trace_pass_replay``):

  * FORWARD: the camera stage (kernel K2 and the K-fold first bounce, in
    PyTorch, differentiable), then all ``nb`` later bounces of the sample
    pass in ONE launch of K7 (``ops/megakernel.fused_bounces``), which also
    writes each bounce's input state [13, N] and winner (t, packed idx).
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

Estimator: the likelihood-ratio branch weight (``integrator.branch_weight``,
primal exactly 1) is applied in the replay; the discrete decisions (event
choice, winner, liveness) are constants; the zero-throughput kill is on, so
a material sitting exactly at 0 albedo gets no gradient through later
bounces (``parallel/train.py``'s ``fused="off"`` keeps that corner).
Reference for the estimator: src/dod/Scene.cpp:124-179.
"""

from __future__ import annotations

import torch

from ..ops import rng
from ..ops.camera import generate_rays
from ..ops.intersect import Hits, hits_from_winner, intersect_scene
from ..ops.intersect_kernel import winner_t_vjp
from ..ops.megakernel import PackedSceneFused, bounce_bwd_step, fused_bounces
from ..utils.render_params import RenderParams
from .integrator import (
    GatheredMat,
    PathState,
    _expand,
    _first_bounce_uniforms,
    bounce_from_hits,
    bounce_rows,
    branch_weight,
    effective_reflectivity,
    gather_materials,
    resolve_intersector,
    sample_direction,
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
    [nb, 4, N]; ``geo_scene`` carries the (constant) geometry."""

    @staticmethod
    def forward(ctx, emission, diffuse, ior, reflectivity, cone_angle, environment,
                state0_rows, unifs, geo_scene, nb, eps, kernel_bwd):
        mats = MaterialTable(emission, diffuse, ior, reflectivity, cone_angle)
        pk = PackedSceneFused(geo_scene._replace(materials=mats, environment=environment))
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
            return (*grads, d_env.to(env.dtype), cot, None, None, None, None, None)
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
        return (*total, cot, None, None, None, None, None)


def trace_pass_replay(scene, camera, params: RenderParams, key, px, py,
                      tri_chunk: int = 1024, with_ray_count: bool = False,
                      kernel_bwd: bool = True):
    """Differentiable 1-spp pass with the K7 forward: a drop-in for
    ``integrator.trace_pass`` on the training path (same RNG streams, same
    estimator, zero-throughput kill always on). Differentiable w.r.t.
    scene.materials, scene.environment and the camera. Needs the kernel
    backend (CUDA kernels on the card, their plain versions on the CPU)."""
    nu = params.first_bounce_u_samples
    nv = params.first_bounce_v_samples
    k = nu * nv
    eps = params.epsilon
    r0 = px.shape[0]
    dev = px.device
    backend = resolve_intersector(params, dev)
    if backend != "kernel":
        raise ValueError("trace_pass_replay needs the kernel intersector")

    # camera + first hit + stratified K expansion: the streams and math of
    # integrator.trace_pass (zero-throughput kill on)
    cam_u = rng.uniforms(rng.stream_key(key, rng.CAMERA_STREAM), (4, r0), dev)
    org0, dir0 = generate_rays(camera, px, py, cam_u)
    hits0 = intersect_scene(scene, org0, dir0, eps, tri_chunk, backend)
    mat0 = gather_materials(scene.materials, hits0.mat_id)
    miss_colour = scene.environment[:, None].expand(3, r0)
    if params.preview:
        return torch.where(hits0.hit, mat0.diffuse, miss_colour).T

    u0, v0, p0 = _first_bounce_uniforms(params, key, r0, dev)
    refl0 = effective_reflectivity(mat0, hits0, dir0)
    spec0 = (p0 < refl0[:, None]).reshape(-1)
    hits0x = Hits(*(_expand(f, k) for f in hits0))
    mat0x = GatheredMat(*(_expand(f, k) for f in mat0))
    dir1 = sample_direction(mat0x, hits0x, _expand(dir0, k), u0.reshape(-1),
                            v0.reshape(-1), spec0)
    beta1 = torch.where(spec0, torch.ones((3, r0 * k), device=dev), mat0x.diffuse) \
        * branch_weight(_expand(refl0, k), spec0)
    alive1 = hits0x.hit & torch.any(beta1 != 0.0, dim=0)
    state0_rows = torch.cat([hits0x.pos, dir1, beta1, alive1.to(torch.float32)[None, :],
                             torch.zeros((3, r0 * k), device=dev)], dim=0)  # [13, R*K]

    nb = max(params.max_depth - 1, 0)
    nrays = torch.tensor(r0, dtype=torch.int64, device=dev)
    if nb == 0:
        acc = torch.zeros((3, r0 * k), device=dev)
    else:
        unifs = bounce_rows(key, nb, r0 * k, dev).reshape(nb, 4, r0 * k)
        m = scene.materials
        acc = _Chain.apply(m.emission, m.diffuse, m.ior, m.reflectivity, m.cone_angle,
                           scene.environment, state0_rows, unifs, scene, nb, float(eps),
                           kernel_bwd)
        # live-lane count: alive1 enters bounce 1 (the later bounces are
        # counted inside the chain and not returned, as in the JAX package)
        nrays = nrays + alive1.sum()

    path_mean = acc.reshape(3, r0, k).mean(dim=2)
    hit_colour = mat0.emission + path_mean
    radiance = torch.where(hits0.hit, hit_colour, miss_colour).T
    if with_ray_count:
        return radiance, nrays
    return radiance
