"""Sharded rendering over the (dp, sp) mesh, one process per device.

The counterpart of the JAX package's ``parallel/shard.py``. Each rank
renders up to its dp replica's sample passes of its sp shard of the
pixels; the dp replicas' radiance is summed (an all-reduce over the rank's
dp group, the JAX ``psum``) and every rank of the mesh gathers the sp
shards in order, so each returns the same whole framebuffer.

RNG: the key for sample ``s`` on spatial shard ``q`` of memory tile ``m`` is
``fold(fold(base, s), m*sp + q)``, a pure function of the global sample
index (the same chain whether the sample is rendered by a single-pass
launch or inside a regenerating megakernel block), so:

  * a fixed seed gives a bit-identical image for a fixed mesh and tiling;
  * changing ``dp`` at fixed sp changes only which replica computes a
    sample, not its value: the image is unchanged up to the float32 order
    of the dp sum when every sample renders through the same kind of
    launch (spp aligned to dp*S guarantees it). sp changes the spatial
    shard blocks, so images across different sp agree only statistically;
  * ``resume_from`` continues at the exact next sample, as render() does.

The render runs the single-device ``models/render.render``'s loop
(``render_rounds``) with the mesh: memory tiling, exact spp (a final
partial round masks the inactive dp replicas), the runtime autotune
(probe, decide, rebuild; re-traced on resume), the feedback work-sort
(its per-lane key summed over dp) and throttled ``update_fn`` checkpoints
at pass-group boundaries (on the mesh's first rank). The stream tier's
wall-clock cap (the JAX ``_stream_ppd_cap``) is left out, as on the
single device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.render import render_rounds
from ..models.ways import WAYS
from ..ops import rng
from ..utils.framebuffer import ArrayOutput
from ..utils.render_params import RenderParams
from .mesh import Mesh, all_reduce


def make_sharded_pass_fn(scene, camera, params: RenderParams, mesh: Mesh, way: str = "dod",
                         tri_chunk: int = 1024, n_passes: int = 1, regen: bool = False,
                         feedback_sort: bool = False, packed=None):
    """Returns fn(base_key, sample0, tile_idx, px, py[, sort_key]) ->
    radiance [R, 3] of this rank's shard summed over the ACTIVE dp replicas
    (plus the updated sort key shard when ``feedback_sort``).

    ``px``/``py`` [R] are this rank's shard of the tile's ray coordinates
    (block ``sp_idx`` of the tile; the dp replicas of a shard trace the
    same pixels). The key for sample ``s`` is fold(fold(base, s),
    tile_idx*sp + sp_idx) in every mode.

    ``n_passes == 1``: replica d renders global sample ``sample0 + d``,
    none when that reaches spp, so the sum covers ``min(dp, spp -
    sample0)`` passes. ``n_passes > 1``: replica d renders the block of
    samples ``sample0 + d*n_passes`` .. ``+ n_passes - 1``, in one
    regenerating megakernel launch when ``regen``
    (integrator.trace_passes_fused), else a loop of per-sample traces; the
    caller guarantees full blocks. ``feedback_sort`` (regen only): threads
    the per-lane bounce-count running sum, summed over dp so every replica
    sorts by the same key (a launch that is not a regenerating block
    returns the key as it is). ``packed``: the scene's ``PackedSceneStream``
    (built per call when None)."""
    from ..models.integrator import trace_passes_fused

    trace = WAYS[way]
    sp = mesh.shape["sp"]
    spp = params.samples_per_pixel
    dp_idx, sp_idx = mesh.dp_idx, mesh.sp_idx

    def psum(x):
        return all_reduce(x, mesh.dp_group)

    def fn(base_key, sample0, tile_idx, px, py, sort_key=None):
        combined = tile_idx * sp + sp_idx
        if n_passes > 1 and regen:
            sample_base = sample0 + dp_idx * n_passes
            if feedback_sort:
                radiance, cnts = trace_passes_fused(
                    scene, camera, params, base_key, sample_base, combined, px, py,
                    n_passes, tri_chunk, sort_key=sort_key, with_lane_counts=True,
                    packed=packed)
                return psum(radiance), sort_key + psum(cnts)
            return psum(trace_passes_fused(scene, camera, params, base_key, sample_base,
                                           combined, px, py, n_passes, tri_chunk,
                                           packed=packed))
        if n_passes > 1:
            radiance = torch.zeros((px.shape[0], 3), dtype=camera.centre.dtype,
                                   device=px.device)
            for i in range(n_passes):
                key = rng.tile_key(rng.pass_key(base_key, sample0 + dp_idx * n_passes + i),
                                   combined)
                radiance = radiance + trace(scene, camera, params, key, px, py, tri_chunk)
        elif sample0 + dp_idx < spp:
            key = rng.tile_key(rng.pass_key(base_key, sample0 + dp_idx), combined)
            radiance = trace(scene, camera, params, key, px, py, tri_chunk)
        else:  # an inactive replica of the last round adds nothing
            radiance = torch.zeros((px.shape[0], 3), dtype=camera.centre.dtype,
                                   device=px.device)
        # these launches leave the feedback sort's key as it is
        return (psum(radiance), sort_key) if feedback_sort else psum(radiance)

    return fn


def render_sharded(
    scene,
    camera,
    params: RenderParams,
    mesh: Mesh,
    way: str = "dod",
    tri_chunk: int = 1024,
    update_fn: Optional[Callable[[ArrayOutput], None]] = None,
    save_every_seconds: float = 0.0,
    progress: bool = False,
    resume_from: Optional[str] = None,
    device=None,
) -> Optional[ArrayOutput]:
    """The full sharded render (see the module docstring) on this rank's
    ``device`` (default: the mesh's): render()'s loop
    (models/render.render_rounds) on this rank's part of the mesh. spp is
    consumed dp samples at a time; the last round masks inactive replicas
    so the output holds exactly spp samples per pixel. Every rank of the
    mesh returns the same ``ArrayOutput``; a rank outside the mesh returns
    None at once."""
    if not mesh.member:
        return None
    return render_rounds(scene, camera, params, mesh, way, tri_chunk, update_fn,
                         save_every_seconds, progress, resume_from,
                         mesh.device if device is None else device)
