"""The "three ways": three schedules of one estimator.

The reference implements its estimator three ways to compare styles (OO
virtual dispatch, FP optionals and ranges, DoD SoA batches). As in the JAX
package, the three ways here are three schedules over identical math:

  * ``dod`` (models/integrator.trace_pass): the wavefront; all R*K paths
    advance one bounce per loop step.
  * ``oo``: a loop over the K first-bounce substrata, each carrying a full
    depth chain over the R pixels' paths: K times less live path state,
    substrata one after another (src/oo/Renderer.cpp:60-91).
  * ``fp``: radiance as a recursion of depth ``max_depth`` (masks in place
    of tl::optional), as src/fp/Render.cpp:47-117.

All three draw the same threefry streams in the same (r, k) order
(``CAMERA_STREAM``, ``FIRST_BOUNCE_STREAM``, ``BOUNCE_STREAM_BASE`` folded
with the depth), so for a seed they give the same image up to the order of
float sums. Every intersection goes through ``ops/intersect
.intersect_scene``: with the kernel backend that is kernel K2, once for the
camera rays and once per substratum and bounce, all on one ``PackedScene``
built per pass. Dead lanes still go to the search with ``live=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.intersect import Hits, intersect_scene
from ..ops.intersect_kernel import PackedScene
from ..ops.vecmath import fma
from .integrator import (
    PathState,
    _bounce_uniforms,
    _first_bounce_uniforms,
    bounce,
    branch_weight,
    camera_stage,
    effective_reflectivity,
    gather_materials,
    resolve_intersector,
    sample_direction,
    trace_pass,
)


class _Pass(NamedTuple):
    """What a substratum's chain reads of its pass."""

    scene: object
    params: object
    tri_chunk: int
    backend: str
    packed: object  # K2's pack of the scene, or None
    tables: dict  # {depth: [3, R0, K]} bounce uniforms
    hits0: Hits
    miss_colour: torch.Tensor  # [3, R0]


def _depth_tables(key, params, r0, k, device, dtype):
    """{depth: [3, R0, K]} bounce uniforms for depths 1 .. max_depth-1.

    The JAX package draws the whole [3, R0*K] table of a depth again for
    every substratum and keeps one column; drawing each depth's table once
    a pass and slicing it per substratum gives the same values."""
    return {d: _bounce_uniforms(key, d, r0 * k, device, dtype).reshape(3, r0, k)
            for d in range(1, max(params.max_depth, 1))}


def _over_substrata(chain, scene, camera, params, key, px, py, tri_chunk):
    """The pass both ways share: the camera stage (one K2 pack a pass), then
    for each of the K substrata its first bounce and ``chain(pass, k_idx,
    dir1, tint0)``, the substratum's radiance [3, R0] past that bounce
    weighted by ``tint0``; the pixel's radiance is its emission plus the
    mean over the substrata. Returns radiance [R, 3]."""
    dtype = camera.centre.dtype
    dev = px.device
    r0 = px.shape[0]
    k = params.first_bounce_samples
    backend = resolve_intersector(params, dev)
    packed = PackedScene(scene) if backend == "kernel" else None
    dir0, hits0, mat0 = camera_stage(scene, camera, params, key, px, py, tri_chunk, backend,
                                     packed)
    miss_colour = scene.environment[:, None].expand(3, r0).to(dtype)
    if params.preview:
        return torch.where(hits0.hit, mat0.diffuse, miss_colour).T

    u0, v0, p0 = _first_bounce_uniforms(params, key, r0, dev, dtype)
    refl0 = effective_reflectivity(mat0, hits0, dir0)
    ps = _Pass(scene, params, tri_chunk, backend, packed,
               _depth_tables(key, params, r0, k, dev, dtype), hits0, miss_colour)
    ones = torch.ones((3, r0), dtype=dtype, device=dev)
    acc = torch.zeros((3, r0), dtype=dtype, device=dev)
    for k_idx in range(k):
        spec0 = p0[:, k_idx] < refl0
        dir1 = sample_direction(mat0, hits0, dir0, u0[:, k_idx], v0[:, k_idx], spec0)
        tint0 = torch.where(spec0, ones, mat0.diffuse) * branch_weight(refl0, spec0)
        acc = acc + chain(ps, k_idx, dir1, tint0)
    hit_colour = mat0.emission + acc / k
    return torch.where(hits0.hit, hit_colour, miss_colour).T


def _oo_chain(ps: _Pass, k_idx, dir1, tint0):
    """The depth chain of one substratum over the R pixels' paths."""
    state = PathState(org=ps.hits0.pos, dirn=dir1, beta=tint0, acc=torch.zeros_like(tint0),
                      alive=ps.hits0.hit)
    for d in range(1, max(ps.params.max_depth - 1, 0) + 1):
        bu = ps.tables[d][:, :, k_idx]
        state = bounce(ps.scene, state, bu[0], bu[1], bu[2], ps.params.epsilon, ps.tri_chunk,
                       ps.backend, kill_dead=ps.params.kill_dead_paths, packed=ps.packed)
    return state.acc


def _fp_chain(ps: _Pass, k_idx, dir1, tint0):
    """tint0 times the radiance recursion of depth ``max_depth`` (masks in
    place of tl::optional, src/fp/Render.cpp:22-117)."""
    params = ps.params
    ones = torch.ones_like(tint0)
    zeros = torch.zeros_like(tint0)

    def radiance(org, dirn, depth, alive):
        """[3, R0]; dead lanes contribute 0."""
        if depth >= params.max_depth:
            return zeros
        hits = intersect_scene(ps.scene, org, dirn, params.epsilon, ps.tri_chunk, ps.backend,
                               live=alive, packed=ps.packed)
        mat = gather_materials(ps.scene.materials, hits.mat_id)
        live_hit = alive & hits.hit
        live_miss = alive & ~hits.hit
        bu = ps.tables[depth][:, :, k_idx]
        refl = effective_reflectivity(mat, hits, dirn)
        spec = bu[2] < refl
        new_dir = sample_direction(mat, hits, dirn, bu[0], bu[1], spec)
        tint = torch.where(spec, ones, mat.diffuse) * branch_weight(refl, spec)
        child = radiance(hits.pos, new_dir, depth + 1, live_hit)
        hit_val = fma(tint, child, mat.emission)  # contracted, as XLA's CPU code
        return torch.where(live_hit, hit_val,
                           torch.where(live_miss, ps.miss_colour, zeros))

    return tint0 * radiance(ps.hits0.pos, dir1, 1, ps.hits0.hit)


def trace_pass_oo(scene, camera, params, key, px, py, tri_chunk: int = 1024):
    """The substratum-loop way: for each of the K substrata, the depth chain
    over the R pixels' paths. Returns radiance [R, 3]."""
    return _over_substrata(_oo_chain, scene, camera, params, key, px, py, tri_chunk)


def trace_pass_fp(scene, camera, params, key, px, py, tri_chunk: int = 1024):
    """The functional way: radiance as a recursion of depth ``max_depth``.
    Returns radiance [R, 3]."""
    return _over_substrata(_fp_chain, scene, camera, params, key, px, py, tri_chunk)


WAYS = {
    "dod": trace_pass,
    "wavefront": trace_pass,
    "oo": trace_pass_oo,
    "megakernel": trace_pass_oo,
    "fp": trace_pass_fp,
    "functional": trace_pass_fp,
}
