"""Differentiable rendering: the inverse-rendering training step.

The port of the JAX package's ``parallel/train.py`` for ONE device: pixel
gradients w.r.t. the material table (emission, diffuse albedo, ior,
reflectivity, cone angle) and, on request, the camera, by path-replay
backprop, then one SGD update. The JAX step is a jitted ``shard_map`` over a
(dp, sp) mesh; on a 1x1 mesh that is: the key folded twice with index 0
(``tile_key(tile_key(key, dp_idx), sp_idx)``), the estimate equal to the
pass's radiance, and the loss the global mean squared error. Meshes with
more devices are not ported yet.

The forwards, as in the JAX package:

  * ``fused="auto"`` with the kernel backend: ``models/replay
    .trace_pass_replay`` (kernel K7 forward; the backward replays each
    bounce through kernel K8, no re-intersection; zero-throughput kill on);
  * the same with ``passes_per_step`` = S > 1: ``models/replay
    .trace_passes_replay``, the REGENERATING replay chain, S sample passes
    under the step's key (samples 0 .. S-1, tile 0) in one launch of K4 in
    replay mode, the backward K9's reverse walk; the estimate is the
    radiance sum / S;
  * ``fused="off"`` (or another backend): the way's pass
    (``models/ways.WAYS[way]``: ``integrator.trace_pass``, the per-bounce
    wavefront, for ``dod``; ``trace_pass_oo`` or ``trace_pass_fp`` for
    ``oo`` and ``fp``), with ``kill_dead_paths=False`` (a path whose
    throughput is exactly 0 still carries d(beta)/d(param)), differentiated
    by autograd, the winner distances through K2's VJP; ``params.remat``
    recomputes each of ``trace_pass``'s bounces in the backward.

What is ported here: one device, ``way=``, ``fused=``, ``passes_per_step``,
``differentiate_camera`` and ``remat``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.integrator import resolve_intersector
from ..models.materials import MaterialTable
from ..models.ways import WAYS
from ..ops import rng
from ..utils.render_params import RenderParams


FLOAT64_ON_CPU = "float64 training runs on the CPU only (pass device='cpu')"


class TrainState(NamedTuple):
    materials: MaterialTable
    camera: object  # ops.camera.Camera
    step: int


def _mesh_devices(mesh) -> int:
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    return int(size() if callable(size) else size)


def _grads(loss, leaves):
    """d loss / d leaves (zeros for a leaf the loss does not reach)."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, leaves)]


def make_sharded_train_step(scene, params: RenderParams, mesh=None, way: str = "dod",
                            learning_rate: float = 0.05, tri_chunk: int = 1024,
                            differentiate_camera: bool = False, fused: str = "auto",
                            passes_per_step: int = 1, device="cuda"):
    """Builds fn(state, key, px, py, target) -> (loss, new_state) on
    ``device`` (the card unless the caller asks for the CPU).

    ``px``/``py`` [R] pixel coordinates and ``target`` [R, 3];
    ``state.materials`` replaces the scene's materials; each call consumes
    ``passes_per_step`` sample passes of the estimator under ``key``
    (more than one needs the replay path). ``way``: the pass that
    ``fused="off"`` differentiates (the replay path is ``dod``'s only).
    ``mesh``: None (one device); a mesh of more devices is not ported
    yet. float64 (``params.dtype``, the scene or the state) runs on the CPU
    only: on another device it raises ValueError."""
    from ..models.render import has_float64, resolve_device

    if _mesh_devices(mesh) != 1:
        raise NotImplementedError("not yet ported")
    on_card = torch.device(device).type != "cpu"
    if on_card and (params.dtype == "float64" or has_float64(scene)):
        raise ValueError(FLOAT64_ON_CPU)
    dev = resolve_device(device)
    scene = scene.to(dev)
    use_replay = (
        fused == "auto"
        and way in ("dod", "wavefront")
        and resolve_intersector(params, dev) == "kernel"
        and not params.preview
    )
    use_regen = use_replay and passes_per_step > 1
    replay_kw = {}
    if use_replay:
        from ..models.replay import trace_pass_replay, trace_passes_replay
        from ..ops.megakernel import PackedSceneStream

        trace = trace_pass_replay
        params = params.replace(kill_dead_paths=True, remat=False)
        # the geometry's tables, built once: each step refreshes the material rows
        replay_kw = dict(packed=PackedSceneStream(scene))
    else:
        trace = WAYS[way]
        params = params.replace(kill_dead_paths=False, fused="off")
        if passes_per_step > 1:
            raise ValueError("passes_per_step > 1 needs the replay path (fused='auto' "
                             "with the kernel backend)")

    def train_step(state: TrainState, key, px, py, target):
        if on_card and has_float64(state.materials, state.camera):
            raise ValueError(FLOAT64_ON_CPU)
        px, py, target = px.to(dev), py.to(dev), target.to(dev)
        mats = [m.detach().to(dev).requires_grad_() for m in state.materials]
        cam = [c.detach().to(dev) for c in state.camera]
        if differentiate_camera:
            cam = [c.requires_grad_() for c in cam]
        sc = scene._replace(materials=MaterialTable(*mats))
        camera = type(state.camera)(*cam)
        if use_regen:
            radiance = trace_passes_replay(sc, camera, params, key, 0, 0, px, py,
                                           passes_per_step, tri_chunk, **replay_kw)
            estimate = radiance / passes_per_step
        else:
            k = rng.tile_key(rng.tile_key(key, 0), 0)
            estimate = trace(sc, camera, params, k, px, py, tri_chunk, **replay_kw)
        loss = torch.mean((estimate - target) ** 2)
        leaves = mats + (cam if differentiate_camera else [])
        grads = _grads(loss, leaves)
        with torch.no_grad():
            new_mat = MaterialTable(*(m - learning_rate * g for m, g in zip(mats, grads)))
            new_cam = type(state.camera)(*cam)
            if differentiate_camera:
                new_cam = type(state.camera)(
                    *(c - learning_rate * g for c, g in zip(cam, grads[len(mats):])))
        return loss.detach(), TrainState(new_mat, new_cam, state.step + 1)

    return train_step
