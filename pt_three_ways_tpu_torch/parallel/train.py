"""Differentiable rendering: the inverse-rendering training step.

The port of the JAX package's ``parallel/train.py``: pixel gradients
w.r.t. the material table (emission, diffuse albedo, ior, reflectivity,
cone angle) and, on request, the camera, by path-replay backprop, then one
SGD update. The JAX step is a jitted ``shard_map`` over a (dp, sp) mesh.

On a mesh (``parallel/mesh.make_mesh``, one process per device; ``mesh=None``
is the one-device 1x1 mesh, ``parallel/mesh.one_device_mesh``, whose
collectives are the identity) each rank traces block ``sp_idx`` of the
pixels under its replica's key ``tile_key(tile_key(key, dp_idx), sp_idx)``
(or, on the regenerating path, its replica's block of samples); the
estimate is the dp all-reduce of the radiance over ``dp *
passes_per_step``, the loss the sp all-reduce of the squared error over
the element count. Each rank backpropagates its own radiance with the
cotangent d loss / d radiance (``2 (estimate - target) / (N dp
passes_per_step)``, detached, formed in the order autograd forms it from
the mean squared error on one device), and the parameter gradients are
summed over the mesh: the gradient of the JAX step's ``value_and_grad``
through its ``shard_map``. Every rank applies the same update.

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

Everything of the JAX step is ported: meshes, ``way=``, ``fused=``,
``passes_per_step``, ``differentiate_camera`` and ``remat``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.integrator import resolve_intersector
from ..models.materials import MaterialTable
from ..models.ways import WAYS
from ..ops import rng
from ..utils import tracing
from ..utils.render_params import RenderParams
from .mesh import all_reduce, one_device_mesh


FLOAT64_ON_CPU = "float64 training runs on the CPU only (pass device='cpu')"


class TrainState(NamedTuple):
    materials: MaterialTable
    camera: object  # ops.camera.Camera
    step: int


def _grads(radiance, cot, leaves):
    """This rank's d loss / d leaves: the radiance's vector-Jacobian
    product with the cotangent ``cot`` (zeros for a leaf it does not
    reach)."""
    gs = torch.autograd.grad(radiance, leaves, grad_outputs=cot, allow_unused=True)
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
    ``mesh``: None (one device, the 1x1 mesh), or this rank's ``parallel/mesh.Mesh``
    (``px``, ``py`` and ``target`` are then the global arrays, their
    length divisible by sp; one call consumes ``dp * passes_per_step``
    sample passes; ``device`` defaults to the mesh's). float64
    (``params.dtype``, the scene or the state) runs on the CPU only: on
    another device it raises ValueError."""
    from ..models.render import has_float64, resolve_device

    if mesh is not None:
        if not mesh.member:
            raise ValueError("this rank is outside the mesh")
        if device == "cuda":
            device = mesh.device
    on_card = torch.device(device).type != "cpu"
    if on_card and (params.dtype == "float64" or has_float64(scene)):
        raise ValueError(FLOAT64_ON_CPU)
    dev = resolve_device(device)
    if mesh is None:
        mesh = one_device_mesh(dev)
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

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    dp_idx, sp_idx = mesh.dp_idx, mesh.sp_idx

    @tracing.spanned("pt3.train.step")
    def train_step(state: TrainState, key, px, py, target):
        """The loss and the update from this rank's block, its gradients
        summed over the mesh. Traced as ``pt3.train.step``, a unit's root,
        with ``.forward``, ``.backward`` and ``.update``."""
        if on_card and has_float64(state.materials, state.camera):
            raise ValueError(FLOAT64_ON_CPU)
        r = px.shape[0]
        if r % sp:
            raise ValueError(f"{r} rays do not split into sp={sp} equal blocks")
        blk = slice(sp_idx * (r // sp), (sp_idx + 1) * (r // sp))
        with tracing.span("pt3.sync.inputs"):  # copies from host memory wait for the card
            px, py, target = px[blk].to(dev), py[blk].to(dev), target[blk].to(dev)
        mats = [m.detach().to(dev).requires_grad_() for m in state.materials]
        cam = [c.detach().to(dev) for c in state.camera]
        if differentiate_camera:
            cam = [c.requires_grad_() for c in cam]
        sc = scene._replace(materials=MaterialTable(*mats))
        camera = type(state.camera)(*cam)
        leaves = mats + (cam if differentiate_camera else [])
        with tracing.span("pt3.train.forward"):
            if use_regen:
                radiance = trace_passes_replay(sc, camera, params, key,
                                               dp_idx * passes_per_step, sp_idx, px, py,
                                               passes_per_step, tri_chunk, **replay_kw)
            else:
                k = rng.tile_key(rng.tile_key(key, dp_idx), sp_idx)
                radiance = trace(sc, camera, params, k, px, py, tri_chunk, **replay_kw)
        with torch.no_grad():
            d = all_reduce(radiance, mesh.dp_group) / (dp * passes_per_step) - target
            # the global mean as the sum of the equal blocks' means over sp
            # (exactly torch.mean's value on one block)
            loss = all_reduce(torch.mean(d ** 2) / sp, mesh.sp_group)
            # d loss / d radiance in the order autograd forms it from
            # mean((estimate - target) ** 2) on one device
            inv_n = torch.ones((), dtype=d.dtype, device=d.device) / (target.numel() * sp)
            cot = inv_n * (2.0 * d) / (dp * passes_per_step)
        with tracing.span("pt3.train.backward"):
            grads = [all_reduce(g, mesh.group) for g in _grads(radiance, cot, leaves)]
        with torch.no_grad(), tracing.span("pt3.train.update"):
            new_mat = MaterialTable(*(m - learning_rate * g for m, g in zip(mats, grads)))
            new_cam = type(state.camera)(*cam)
            if differentiate_camera:
                new_cam = type(state.camera)(
                    *(c - learning_rate * g for c, g in zip(cam, grads[len(mats):])))
        return loss.detach(), TrainState(new_mat, new_cam, state.step + 1)

    return train_step
