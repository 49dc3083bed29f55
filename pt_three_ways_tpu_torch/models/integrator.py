"""Wavefront path integrator — the flagship ("dod") way.

The reference's recursive radiance (src/dod/Scene.cpp:124-179,
src/oo/Renderer.cpp:60-91) as a wavefront over SoA tensors, exactly as the
JAX package's ``models/integrator.py``:

  * camera ray -> first hit; miss returns the environment colour; preview
    returns the material diffuse;
  * stratified firstBounceU x firstBounceV (u, v) grid at depth 0 as a
    K-fold ray multiplicity sharing the first hit; 1 sample per bounce after;
  * per event: p < reflectivity (Fresnel, or the fixed reflectivity when
    >= 0) chooses a cone sample around the mirror direction vs a cosine
    hemisphere sample tinted by diffuse;
  * emission added per shading event; hard depth cutoff returning black.

Three paths, each after the one camera stage ``_first_bounce_state`` (as
are models/replay.py's): ``trace_pass`` (one sample pass, one bounce per
loop step — the path the CPU render and the golden images use; it runs in
the camera's dtype, float32 or, on the CPU, float64, and with
``params.remat`` recomputes each bounce in the backward),
``trace_passes_fused`` (the camera stages of S passes, ``regen_front``,
then ONE regenerating megakernel launch: kernel K5 with table uniforms or
K4 with in-kernel RNG, in stream mode for scenes above the resident range,
``uses_stream``) and ``trace_passes_compact`` (the compacting wavefront:
per bounce, the live lanes packed first, then kernel K10; no CLI path uses
it). All draws come from the same threefry streams as the JAX package
(ops/rng.py).

On a card, a stage that nothing differentiates (``uses_camera_kernel``: a
render in float32) runs as kernel K13 (``ops/camera_kernel``) beside K2 and
K11: five launches and no read by the host, the eager stage's rows bit for
bit. The eager stage is K13's plain version: the CPU, float64 and training
run it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import camera_kernel, intersect_kernel, rng
from ..ops.camera import Camera, generate_rays
from ..ops.intersect import Hits, intersect_scene
from ..ops.intersect_kernel import PackedScene
from ..ops.material_grad import material_grad
from ..ops.megakernel import PackedSceneFused
from ..ops.vecmath import (
    Onb,
    cone_sample,
    facos,
    hemisphere_sample,
    onb_from_z,
    reflect,
    reflectance,
)
from ..utils import tracing
from ..utils.render_params import RenderParams
from .materials import MaterialTable


def resolve_intersector(params: RenderParams, device) -> str:
    """'auto' -> the CUDA kernels ('kernel') on a CUDA device, the broadcast
    scan ('xla') elsewhere. 'kernel' on the CPU runs the kernels' plain
    versions."""
    mode = params.intersector
    if mode == "auto":
        mode = "kernel" if torch.device(device).type == "cuda" else "xla"
    if mode not in ("xla", "kernel"):
        raise ValueError(f"unknown intersector {params.intersector!r}")
    return mode


def resolve_rng_mode(params: RenderParams) -> str:
    """'auto' -> in-kernel counter RNG ('kernel'); 'table' keeps the
    precomputed threefry uniforms (bit-compatible with trace_pass)."""
    if params.rng_mode == "auto":
        return "kernel"
    return params.rng_mode


def uses_stream(params: RenderParams, scene, device) -> bool:
    """True when the regenerating megakernel runs in stream mode (K4 with
    K6, ops/megakernel.PackedSceneStream): the kernel intersector with the
    in-kernel RNG, no preview, ``fused`` not "off", dead paths killed, and
    more triangles than the resident K4's measured range
    (ops/megakernel.scene_fits_resident). The JAX package's gate is its
    VMEM budget; the conditions are its ``uses_stream``'s."""
    if (scene is None or params.preview or params.fused == "off"
            or not params.kill_dead_paths):
        return False
    if resolve_intersector(params, device) != "kernel" or resolve_rng_mode(params) != "kernel":
        return False
    from ..ops import megakernel

    return not megakernel.scene_fits_resident(scene)


def _tensors(*trees):
    for t in trees:
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, tuple):
            yield from _tensors(*t)


def differentiated(scene, camera) -> bool:
    """True where autograd follows the camera stage: grad mode is on and a
    camera, geometry or material tensor requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(scene, camera))


def uses_camera_kernel(scene, camera, backend: str, device) -> bool:
    """True when the camera stage runs as K13 (``ops/camera_kernel``): on a
    CUDA ``device`` with a float32 camera and the kernel backend, where the
    stage is not ``differentiated`` (the rule of ``gather_materials`` for
    K12). The stage then also needs a ``PackedSceneFused`` (every render's
    pack). The CPU, float64 and training take the eager stage."""
    return (torch.device(device).type == "cuda" and backend == "kernel"
            and camera.centre.dtype == torch.float32 and not differentiated(scene, camera))


class GatheredMat(NamedTuple):
    emission: torch.Tensor  # [3, R]
    diffuse: torch.Tensor  # [3, R]
    ior: torch.Tensor  # [R]
    reflectivity: torch.Tensor  # [R]
    cone_angle: torch.Tensor  # [R]


class _MaterialGather(torch.autograd.Function):
    """The five indexed loads of ``gather_materials`` with kernel K12 as
    their VJP (``ops/material_grad``): one reduction by material id in a
    fixed order, in place of an accumulating ``index_put_`` per field. The
    forward is the plain loads, bit for bit. Inputs: the ids [R], then the
    table's five fields; a cotangent that is None counts as zero."""

    @staticmethod
    def forward(ctx, mat_id, emission, diffuse, ior, reflectivity, cone_angle):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(mat_id)
        ctx.n_mat = ior.shape[0]
        return tuple(_loads(MaterialTable(emission, diffuse, ior, reflectivity, cone_angle),
                            mat_id))

    @staticmethod
    def backward(ctx, *cots):
        if all(c is None for c in cots):
            return (None,) * 6
        mat_id, = ctx.saved_tensors
        ref = next(c for c in cots if c is not None)
        n = mat_id.shape[0]
        zero = lambda rows: torch.zeros((rows, n), dtype=ref.dtype, device=ref.device)
        cot = torch.cat([zero(r) if c is None else c.reshape(r, n)
                         for c, r in zip(cots, (3, 3, 1, 1, 1))])
        d = material_grad(mat_id.to(torch.int32).contiguous(), cot, ctx.n_mat)
        return None, d[:, 0:3], d[:, 3:6], d[:, 6], d[:, 7], d[:, 8]


def gather_materials(table, mat_id: torch.Tensor) -> GatheredMat:
    """All material scalars for every ray: one indexed load per field.
    Where the table is differentiated (grad mode on, a field that requires
    grad) the loads go through ``_MaterialGather``, whose VJP is K12."""
    if torch.is_grad_enabled() and any(f.requires_grad for f in table):
        return GatheredMat(*_MaterialGather.apply(mat_id, *table))
    return _loads(table, mat_id)


def _loads(table, mat_id: torch.Tensor) -> GatheredMat:
    m = mat_id.long()
    return GatheredMat(
        emission=table.emission[m].T,
        diffuse=table.diffuse[m].T,
        ior=table.ior[m],
        reflectivity=table.reflectivity[m],
        cone_angle=table.cone_angle[m],
    )


def effective_reflectivity(mat: GatheredMat, hits: Hits, dirn) -> torch.Tensor:
    """Fresnel-or-fixed event probability (dod/Scene.cpp:140-146)."""
    one = torch.ones_like(mat.ior)
    ior_from = torch.where(hits.inside, mat.ior, one)
    ior_to = torch.where(hits.inside, one, mat.ior)
    fresnel = reflectance(hits.normal, dirn, ior_from, ior_to)
    return torch.where(mat.reflectivity < 0.0, fresnel, mat.reflectivity)


def branch_weight(refl: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """Likelihood-ratio weight of the sampled event branch:
    P_chosen / stop_grad(P_chosen). It is exactly 1.0 in the forward pass;
    in the backward it carries the derivative of the discrete event's
    probability (Fresnel -> camera and ior, fixed reflectivity), which the
    comparison ``p < refl`` alone would drop."""
    refl_hat = refl.detach()
    return torch.where(
        spec,
        refl / torch.clamp(refl_hat, min=1e-12),
        (1.0 - refl) / torch.clamp(1.0 - refl_hat, min=1e-12),
    )


def sample_direction(mat: GatheredMat, hits: Hits, dirn, u, v, spec):
    """Branch-free cone-vs-hemisphere next direction (Material.cpp:36-48)."""
    cone_dir = cone_sample(reflect(dirn, hits.normal), mat.cone_angle, u, v)
    hemi_dir = hemisphere_sample(onb_from_z(hits.normal), u, v)
    return torch.where(spec, cone_dir, hemi_dir)


class PathState(NamedTuple):
    org: torch.Tensor  # [3, N]
    dirn: torch.Tensor  # [3, N]
    beta: torch.Tensor  # [3, N] throughput
    acc: torch.Tensor  # [3, N] accumulated radiance
    alive: torch.Tensor  # [N] bool


def bounce(scene, state: PathState, u, v, p, eps: float, tri_chunk: int,
           backend: str = "xla", kill_dead: bool = True, packed=None) -> PathState:
    """One wavefront bounce: intersect all live paths, accumulate emission /
    environment, sample continuation directions (dead lanes are masked).
    ``packed``: the scene's ``PackedScene`` for the kernel backend."""
    hits = intersect_scene(
        scene, state.org, state.dirn, eps, tri_chunk, backend, live=state.alive,
        packed=packed,
    )
    return bounce_from_hits(scene, state, hits, u, v, p, kill_dead)


def bounce_from_hits(scene, state: PathState, hits: Hits, u, v, p,
                     kill_dead: bool = True) -> PathState:
    live_hit = state.alive & hits.hit
    live_miss = state.alive & ~hits.hit

    mat = gather_materials(scene.materials, hits.mat_id)
    env = scene.environment[:, None]
    zero = torch.zeros_like(state.acc)
    acc = state.acc
    acc = acc + torch.where(live_miss, state.beta * env, zero)
    acc = acc + torch.where(live_hit, state.beta * mat.emission, zero)

    refl = effective_reflectivity(mat, hits, state.dirn)
    spec = p < refl
    new_dir = sample_direction(mat, hits, state.dirn, u, v, spec)
    w = branch_weight(refl, spec)
    new_beta = torch.where(spec, state.beta, state.beta * mat.diffuse) * w

    # Zero-throughput kill: a path whose throughput is exactly 0 on every
    # channel contributes exactly 0 downstream (identical estimator).
    alive = live_hit
    if kill_dead:
        alive = alive & torch.any(new_beta != 0.0, dim=0)

    return PathState(
        org=torch.where(live_hit, hits.pos, state.org),
        dirn=torch.where(live_hit, new_dir, state.dirn),
        beta=torch.where(live_hit, new_beta, state.beta),
        acc=acc,
        alive=alive,
    )


def _first_bounce_uniforms(params, key, r0, device, dtype=torch.float32):
    nu = params.first_bounce_u_samples
    nv = params.first_bounce_v_samples
    k = nu * nv
    fb_u = rng.uniforms(rng.stream_key(key, rng.FIRST_BOUNCE_STREAM), (3, r0, k), device,
                        dtype)
    ar = torch.arange(k, dtype=dtype, device=device)
    iu = torch.div(ar, nv, rounding_mode="floor").reshape(1, k)
    iv = torch.remainder(ar, nv).reshape(1, k)
    u0 = (iu + fb_u[0]) / nu  # [R, K]
    v0 = (iv + fb_u[1]) / nv
    p0 = fb_u[2]
    return u0, v0, p0


def _expand(x, k: int):
    """[.., R] -> [.., R*K] (trailing-axis fan-out, (r, k) order)."""
    return torch.repeat_interleave(x, k, dim=-1)


def _bounce_uniforms(key, d: int, n: int, device, dtype=torch.float32):
    bkey = rng.stream_key(key, rng.BOUNCE_STREAM_BASE)
    return rng.uniforms(rng.fold_in(bkey, d), (3, n), device, dtype)


def bounce_rows(key, nb: int, n: int, device, lane_major: bool = False) -> torch.Tensor:
    """[4*nb, N] uniform table of the table-driven kernels: rows (u, acos u,
    v, p) for depths 1..nb, on the scan's streams (acos precomputed outside
    the kernels). ``lane_major``: the same values as [nb, N, 4], a lane's
    four draws of a depth side by side (K5's table: one 16-byte read a
    bounce)."""
    rows = []
    for d in range(1, nb + 1):
        bu = _bounce_uniforms(key, d, n, device)
        acos_u = facos(torch.clamp(bu[0], 0.0, 1.0))
        rows.append(torch.stack([bu[0], acos_u, bu[1], bu[2]], dim=-1 if lane_major else 0))
    if lane_major:
        return torch.stack(rows) if rows else torch.zeros((0, n, 4), device=device)
    return torch.cat(rows, dim=0) if rows else torch.zeros((0, n), device=device)


def remat_step(step, state: PathState, d: int) -> PathState:
    """``step(state, d)`` under ``torch.utils.checkpoint``: the backward
    recomputes the step from its inputs; it keeps nothing else."""
    from torch.utils.checkpoint import checkpoint

    return PathState(*checkpoint(lambda *st: tuple(step(PathState(*st), d)), *state,
                                 use_reentrant=False))


def camera_stage(scene, camera: Camera, params: RenderParams, key, px, py, tri_chunk: int,
                 backend: str, packed=None):
    """The camera rays of one pass and what they hit first -> (dir0 [3, R],
    hits0, mat0): the uniforms on ``CAMERA_STREAM`` in the camera's dtype,
    the search by ``backend`` (``packed``: the scene's pack for K2)."""
    cam_u = rng.uniforms(rng.stream_key(key, rng.CAMERA_STREAM), (4, px.shape[0]),
                         px.device, camera.centre.dtype)
    with tracing.span("pt3.camera.rays", px.device):
        org0, dir0 = generate_rays(camera, px, py, cam_u)
    hits0 = intersect_scene(scene, org0, dir0, params.epsilon, tri_chunk, backend,
                            packed=packed)
    return dir0, hits0, gather_materials(scene.materials, hits0.mat_id)


def trace_pass(scene, camera: Camera, params: RenderParams, key, px, py,
               tri_chunk: int = 1024):
    """One 1-spp pass over a tile of pixels -> radiance [R, 3]; the scan
    wavefront (one bounce per loop step). Every draw and temporary takes
    the camera's dtype. With ``params.remat`` each bounce runs under
    ``torch.utils.checkpoint``: the backward recomputes its intersection
    and samples from the carried path state instead of keeping them (the
    JAX package's ``jax.checkpoint`` of the scan step)."""
    k = params.first_bounce_samples
    eps = params.epsilon
    r0 = px.shape[0]
    dev = px.device
    dtype = camera.centre.dtype

    backend = resolve_intersector(params, dev)
    packed = None
    if backend == "kernel":  # K2's, once a pass; K13 reads a fused pack's attribute rows
        fused = not params.preview and uses_camera_kernel(scene, camera, backend, dev)
        packed = (PackedSceneFused if fused else PackedScene)(scene)
    if params.preview:
        _, hits0, mat0 = camera_stage(scene, camera, params, key, px, py, tri_chunk, backend,
                                      packed)
        return torch.where(hits0.hit, mat0.diffuse, scene.environment[:, None].expand(3, r0)).T

    rows, base, _ = _first_bounce_state(scene, camera, params, key, px, py, tri_chunk, backend,
                                        want_unif=False, packed=packed,
                                        kill_dead=params.kill_dead_paths)
    state = PathState(org=rows[0:3], dirn=rows[3:6], beta=rows[6:9],
                      acc=torch.zeros((3, r0 * k), dtype=dtype, device=dev),
                      alive=rows[9] != 0.0)

    def step(st, d):
        bu = _bounce_uniforms(key, d, r0 * k, dev, dtype)
        return bounce(scene, st, bu[0], bu[1], bu[2], eps, tri_chunk, backend,
                      kill_dead=params.kill_dead_paths, packed=packed)

    n_bounces = max(params.max_depth - 1, 0)
    for d in range(1, n_bounces + 1):
        state = remat_step(step, state, d) if params.remat else step(state, d)

    # a lane that missed never lived: its path mean is exactly 0
    return (base + state.acc.reshape(3, r0, k).mean(dim=2)).T


@tracing.spanned("pt3.camera", device=True)
def _first_bounce_state(scene, camera, params, key, px, py, tri_chunk, backend,
                        want_unif: bool = True, packed=None, no_glossy: bool = False,
                        kill_dead: bool = True, out=None, base_sum=None):
    """Camera stage + stratified K expansion for ONE sample pass.

    Returns (state_rows [10, R*K] = org3/dir3/beta3/alive1,
             base [3, R] = where(hit0, emission0, env),
             unif_rows [4*nb, R*K] (u, acos u, v, p) per depth) — on the same
    RNG streams as trace_pass, so the regenerating megakernel reproduces its
    estimator; the rows in the camera's dtype. ``want_unif=False``
    (in-kernel RNG) skips the tables. ``packed``: the scene's pack for K2
    (built by ``intersect_scene`` when None). ``no_glossy`` (a render's
    pack's flag) skips the cone sample: bit-equal rows, since cone angles
    below ``vecmath.EPSILON`` take the mirror direction. ``kill_dead``: the
    zero-throughput kill. ``out`` [10, R*K] takes the state rows (a stage's
    rows of a launch's state0) and ``base_sum`` [3, R] has base added in
    place (base is then returned as None); neither may be differentiated.
    With a ``PackedSceneFused`` where ``uses_camera_kernel`` holds, the
    stage is K13. Traced as ``pt3.camera``.
    """
    if isinstance(packed, PackedSceneFused) and uses_camera_kernel(scene, camera, backend,
                                                                   px.device):
        state_rows, base = _first_bounce_kernel(scene, camera, params, key, px, py, packed,
                                                no_glossy, kill_dead, out, base_sum)
    else:
        state_rows, base = _first_bounce_eager(scene, camera, params, key, px, py, tri_chunk,
                                               backend, packed, no_glossy, kill_dead)
        if out is not None:
            state_rows = out.copy_(state_rows)
        if base_sum is not None:
            base_sum += base
            base = None
    if not want_unif:
        return state_rows, base, None
    nb = max(params.max_depth - 1, 0)
    return state_rows, base, bounce_rows(key, nb, px.shape[0] * params.first_bounce_samples,
                                         px.device)


def _first_bounce_kernel(scene, camera, params, key, px, py, packed, no_glossy, kill_dead,
                         out, base_sum):
    """The stage as K13 on the card: K11, K13a, K2, K11, K13b, and no read
    by the host -> (state rows, base, or None where ``base_sum`` took it).
    Counted in ``k13.stages``."""
    k = params.first_bounce_samples
    r0 = px.shape[0]
    dev = px.device
    cam_u = rng.uniforms(rng.stream_key(key, rng.CAMERA_STREAM), (4, r0), dev)
    with tracing.span("pt3.camera.rays", dev):
        org0, dir0 = camera_kernel.camera_rays(camera, px, py, cam_u)
    live = torch.ones((r0,), dtype=torch.bool, device=dev)
    t, idx = intersect_kernel.intersect_packed(packed, org0, dir0, params.epsilon, live=live)
    fb_u = rng.uniforms(rng.stream_key(key, rng.FIRST_BOUNCE_STREAM), (3, r0, k), dev)
    state = out if out is not None else torch.empty((10, r0 * k), device=dev)
    base = base_sum if base_sum is not None else torch.empty((3, r0), device=dev)
    camera_kernel.first_bounce(packed, org0, dir0, t, idx, fb_u,
                               params.first_bounce_v_samples, state, base,
                               base_sum is not None, no_glossy, kill_dead)
    tracing.count("k13.stages", 1)
    return state, None if base_sum is not None else base


def _first_bounce_eager(scene, camera, params, key, px, py, tri_chunk, backend, packed,
                        no_glossy, kill_dead):
    """The stage in eager PyTorch, K13's plain version -> (state rows,
    base)."""
    k = params.first_bounce_samples
    r0 = px.shape[0]
    dev = px.device
    dtype = camera.centre.dtype

    dir0, hits0, mat0 = camera_stage(scene, camera, params, key, px, py, tri_chunk, backend,
                                     packed)

    miss_colour = scene.environment[:, None].expand(3, r0)
    base = torch.where(hits0.hit, mat0.emission, miss_colour)

    u0, v0, p0 = _first_bounce_uniforms(params, key, r0, dev, dtype)
    u0, v0 = u0.reshape(-1), v0.reshape(-1)
    refl0 = effective_reflectivity(mat0, hits0, dir0)
    spec0 = (p0 < refl0[:, None]).reshape(-1)

    # per-pixel hoisting: the hemisphere basis and the mirror direction
    # depend only on the pixel's first hit (bit-exact: elementwise maps
    # commute with the fan-out)
    onb0x = Onb(*(_expand(c, k) for c in onb_from_z(hits0.normal)))
    hemi_dir = hemisphere_sample(onb0x, u0, v0)
    mirror0x = _expand(reflect(dir0, hits0.normal), k)
    if no_glossy:
        cone_dir = mirror0x
    else:
        cone_dir = cone_sample(mirror0x, _expand(mat0.cone_angle, k), u0, v0)
    dir1 = torch.where(spec0, cone_dir, hemi_dir)
    beta1 = torch.where(spec0, torch.ones((3, r0 * k), dtype=dtype, device=dev),
                        _expand(mat0.diffuse, k)) * branch_weight(_expand(refl0, k), spec0)
    alive1 = _expand(hits0.hit, k)
    if kill_dead:
        alive1 = alive1 & torch.any(beta1 != 0.0, dim=0)

    state_rows = torch.cat(
        [_expand(hits0.pos, k), dir1, beta1, alive1.to(dtype)[None, :]], dim=0
    )  # [10, R*K]
    return state_rows, base


def lane_ids_for(px, py, width: int, k: int) -> torch.Tensor:
    """Canonical lane ids (pixel-global), so the in-kernel RNG draws are
    invariant to dispatch tiling and the feedback sort."""
    return ((py * width + px).to(torch.int32)[:, None] * k
            + torch.arange(k, dtype=torch.int32, device=px.device)[None, :]).reshape(-1)


def sort_order(sort_key):
    """The feedback work-sort's permutation: the lanes by descending
    ``sort_key`` (a stable sort), and its inverse."""
    order = torch.argsort(-sort_key.to(torch.int64), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv


def regen_front(scene, camera, params: RenderParams, base_key, sample0: int, tile_idx: int,
                px, py, n_passes: int, tri_chunk: int, packed, no_glossy: bool,
                tables: bool = False):
    """The camera stages of ``n_passes`` samples, keys fold(fold(base_key,
    sample0 + s), tile_idx) -> (base_sum [3, R], state0 [S*10, N], and with
    ``tables`` K5's lane-major table [S*nb, N, 4], else None). Where the
    stages are not ``differentiated``, each writes its rows into its slice
    of state0 and adds its base into base_sum in place (K13 on the card);
    autograd's stages are concatenated."""
    nb = max(params.max_depth - 1, 0)
    n = px.shape[0] * params.first_bounce_samples
    dtype = camera.centre.dtype
    base_sum = torch.zeros((3, px.shape[0]), dtype=dtype, device=px.device)
    slices = not differentiated(scene, camera)
    state0 = torch.empty((n_passes * 10, n), dtype=dtype, device=px.device) if slices else None
    states, unifs = [], []
    for s in range(n_passes):
        key = rng.fold_in(rng.fold_in(base_key, sample0 + s), tile_idx)
        st_rows, base, _ = _first_bounce_state(
            scene, camera, params, key, px, py, tri_chunk, "kernel", want_unif=False,
            packed=packed, no_glossy=no_glossy,
            out=state0[10 * s:10 * (s + 1)] if slices else None,
            base_sum=base_sum if slices else None,
        )
        if not slices:
            base_sum = base_sum + base
            states.append(st_rows)
        if tables:
            unifs.append(bounce_rows(key, nb, n, px.device, lane_major=True))
    if not slices:
        state0 = torch.cat(states, dim=0)
    return base_sum, state0, torch.cat(unifs, dim=0) if tables else None


def trace_passes_fused(scene, camera, params: RenderParams, base_key, sample0: int,
                       tile_idx: int, px, py, n_passes: int, tri_chunk: int = 1024,
                       sort_key=None, with_lane_counts: bool = False, packed=None):
    """``n_passes`` sample passes in ONE regenerating megakernel launch.

    Keys follow the render() chain fold(fold(base, sample0 + s), tile_idx);
    the radiance SUM over the passes equals summing trace_pass over the same
    keys (float32 order aside).

    ``sort_key`` [r0*k]: feedback work-sort. Lanes are permuted by
    descending key (a stable sort) before the launch and the outputs are
    permuted back, which is bit-exact because per-lane results do not
    depend on a lane's position; both permutations are traced as device
    spans ``pt3.sort``, outside K4's ``pt3.k4``. ``with_lane_counts`` also
    returns this launch's per-lane live-bounce counts (in unsorted lane
    order).
    ``packed``: a prebuilt ``PackedSceneStream`` for this scene (its window
    boxes cull K4's and K5's searches on the card, or feed K6 where the
    scene streams; the plain versions also take a ``PackedSceneFused``);
    the camera stages' K2 launches search it too, and skip the cone sample
    where its ``no_glossy`` says no material is glossy.
    """
    from ..ops import kernel_rng
    from ..ops.megakernel import PackedSceneStream, fused_passes, fused_passes_krng

    dev = px.device
    if resolve_intersector(params, dev) != "kernel" or params.preview:
        raise ValueError("trace_passes_fused needs the kernel intersector, no preview")
    nb = max(params.max_depth - 1, 0)
    k = params.first_bounce_samples
    r0 = px.shape[0]
    use_krng = resolve_rng_mode(params) == "kernel" and nb > 0
    stream = use_krng and uses_stream(params, scene, dev)

    if packed is None:  # K4 and K5 cull their searches by its window boxes
        packed = PackedSceneStream(scene)

    base_sum, state0, unif = regen_front(scene, camera, params, base_key, sample0, tile_idx,
                                         px, py, n_passes, tri_chunk, packed,
                                         packed.no_glossy, tables=not use_krng)
    lane_counts = torch.zeros((r0 * k,), dtype=torch.int32, device=dev)
    if nb == 0:
        radiance = base_sum.T
    else:
        if use_krng:
            lane_ids = lane_ids_for(px, py, params.width, k)
        if sort_key is not None:
            with tracing.span("pt3.sort", dev):
                order, inv = sort_order(sort_key)
                state0 = state0[:, order]
                if use_krng:
                    lane_ids = lane_ids[order]
                else:
                    unif = unif[:, order]
        if use_krng:
            kkey = rng.stream_key(base_key, rng.KERNEL_RNG_STREAM)
            acc, cnts = fused_passes_krng(
                packed, state0, lane_ids, kernel_rng.key_words(kkey), sample0,
                params.epsilon, nb, n_passes,
                tail_frac=params.regen_tail_frac,
                tail_levels=params.regen_tail_levels,
                stream=stream,
            )
        else:
            acc, cnts = fused_passes(packed, state0, unif, params.epsilon, nb, n_passes)
        # after the launch's span, so that neither K4's span nor a timer
        # around the wrapper holds the counter's reduction
        tracing.count("k4.live_bounces", cnts)
        if sort_key is not None:
            with tracing.span("pt3.sort", dev):
                acc = acc[:, inv]
                cnts = cnts[inv]
        path_mean = acc.reshape(3, r0, k).mean(dim=2)
        radiance = (base_sum + path_mean).T
        lane_counts = cnts
    if with_lane_counts:
        return radiance, lane_counts
    return radiance


def trace_passes_compact(scene, camera, params: RenderParams, base_key, sample0: int,
                         tile_idx: int, px, py, n_passes: int, tri_chunk: int = 1024,
                         with_ray_count: bool = False):
    """``n_passes`` sample passes through the compacting wavefront (the
    JAX package's ``trace_passes_compact``).

    Per pass: the camera stage with the threefry bounce rows; then, per
    bounce, a stable partition of the lanes by alive (live lanes first, in
    order), the gather of the state and of that bounce's uniform rows, and
    one K10 launch (ops/megakernel.bounce_step) over all lanes; after the
    last bounce the accumulator (state rows 10..12) is scattered back once.
    Compaction only permutes lane positions, so the estimator is the
    per-pass one, draw for draw (the table-mode K5 reproduces it). Returns
    the radiance SUM over the passes [R, 3] and, ``with_ray_count``, the
    camera rays plus live bounces. No CLI path uses it.
    """
    from ..ops.megakernel import PackedSceneFused, bounce_step

    dev = px.device
    if resolve_intersector(params, dev) != "kernel" or params.preview:
        raise ValueError("trace_passes_compact needs the kernel intersector, no preview")
    nb = max(params.max_depth - 1, 0)
    k = params.first_bounce_samples
    r0 = px.shape[0]
    n = r0 * k
    packed = PackedSceneFused(scene)
    total = torch.zeros((3, r0), device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev) + n_passes * r0
    for s in range(n_passes):
        key = rng.fold_in(rng.fold_in(base_key, sample0 + s), tile_idx)
        st_rows, base, unif_rows = _first_bounce_state(
            scene, camera, params, key, px, py, tri_chunk, "kernel", packed=packed,
            no_glossy=packed.no_glossy)
        if nb == 0:
            total = total + base
            continue
        state = torch.cat([st_rows, torch.zeros((3, n), device=dev)])  # [13, N]
        orig = torch.arange(n, device=dev)
        for d in range(1, nb + 1):
            perm = torch.argsort((state[9] == 0.0).to(torch.int32), stable=True)
            state = state[:, perm]
            orig = orig[perm]
            state, cnt = bounce_step(packed, state, unif_rows[4 * (d - 1):4 * d][:, orig],
                                     params.epsilon)
            nrays = nrays + cnt.sum()
        rad = torch.zeros((3, n), device=dev)
        rad[:, orig] = state[10:13]
        total = total + base + rad.reshape(3, r0, k).mean(dim=2)
    radiance = total.T
    if with_ray_count:
        return radiance, nrays
    return radiance
