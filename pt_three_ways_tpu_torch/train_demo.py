"""Inverse rendering end to end: recover perturbed diffuse albedos of
cornell from a rendered target, through the regenerating replay chain
(``models/replay.trace_passes_replay``: K4 in replay mode forward, K9's
reverse walk backward) with Adam.

The port of the JAX package's ``tools/train_demo.py``. The target is the
production forward (``integrator.trace_passes_fused``) at 256 samples per
pixel; training starts from the true albedos scaled by uniform(0.4, 1.6)
draws and clipped to [0.02, 0.98] (black rows stay black); each step
renders S = 16 passes under a fresh key and takes one Adam step (learning
rate 3e-2) on the diffuse table, clipped to [0, 0.98]. The recursion being
differentiated is the reference's src/oo/Renderer.cpp:60-141.

A diffuse row hidden behind a near-pure specular surface (cornell's mirror
sphere) barely moves the image, so no method recovers it from the image:
the error is measured over the observable rows, those whose gradient at the
perturbed start exceeds 1e-3.

Usage: ``python -m pt_three_ways_tpu_torch.train_demo [steps] [res]
[--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .models.catalog import create_scene
from .models.integrator import trace_passes_fused
from .models.render import resolve_device
from .models.replay import trace_passes_replay
from .models.scene import SceneBuilder
from .ops import rng
from .ops.megakernel import PackedSceneStream
from .utils.render_params import RenderParams

S = 16  # passes per training step
SPP_TARGET = 256


def run(steps: int = 100, res: int = 256, device="cuda", log=print) -> dict:
    """Trains ``steps`` steps at ``res``^2 and returns the observable albedo
    error and the loss before and after, and the time per step."""
    dev = resolve_device(device)
    params = RenderParams(width=res, height=res, samples_per_pixel=S, seed=3,
                          intersector="kernel")
    sb = SceneBuilder()
    camera = create_scene(sb, "cornell", params).to(dev)
    scene = sb.build().to(dev)
    n = res * res
    px = torch.arange(n, dtype=torch.int32, device=dev) % res
    py = torch.arange(n, dtype=torch.int32, device=dev) // res
    base = rng.base_key(3)

    with torch.no_grad():
        target = torch.zeros((n, 3), device=dev)
        for i in range(SPP_TARGET // S):
            target += trace_passes_fused(scene, camera, params, base, i * S, 0, px, py, S)
        target /= SPP_TARGET

    true_diffuse = scene.materials.diffuse.cpu().numpy()
    gen = np.random.default_rng(0)
    pert = np.clip(true_diffuse * gen.uniform(0.4, 1.6, size=true_diffuse.shape), 0.02, 0.98)
    pert = np.where(true_diffuse == 0.0, true_diffuse, pert).astype(np.float32)

    packed = PackedSceneStream(scene)  # the geometry's tables, built once

    def loss_fn(diffuse, key):
        sc = scene._replace(materials=scene.materials._replace(diffuse=diffuse))
        img = trace_passes_replay(sc, camera, params, key, 0, 0, px, py, S, packed=packed)
        return torch.mean((img / S - target) ** 2)

    diffuse = torch.tensor(pert, device=dev, requires_grad=True)
    (g0,) = torch.autograd.grad(loss_fn(diffuse, rng.fold_in(base, 999)), [diffuse])
    obs = g0.abs().sum(dim=1).cpu().numpy() > 1e-3
    log(f"observable diffuse rows: {int(obs.sum())}/{obs.size} (hidden rows are behind "
        f"near-pure specular surfaces)")

    def err(d):
        return float(np.abs(d.detach().cpu().numpy() - true_diffuse)[obs].mean())

    opt = torch.optim.Adam([diffuse], lr=3e-2)
    err0, loss0 = err(diffuse), None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        opt.zero_grad()
        loss = loss_fn(diffuse, rng.fold_in(base, 1000 + i))
        loss.backward()
        opt.step()
        with torch.no_grad():
            diffuse.clamp_(0.0, 0.98)
        loss = float(loss.detach())
        if i == 0:
            loss0 = loss
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:4d}: loss {loss:.6f}  observable |albedo err| {err(diffuse):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return dict(err0=err0, err1=err(diffuse), loss0=loss0, loss1=loss,
                ms_per_step=wall / steps * 1e3, steps=steps, observable=int(obs.sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=100)
    ap.add_argument("res", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    r = run(args.steps, args.res, args.device)
    print(f"observable albedo error {r['err0']:.4f} -> {r['err1']:.4f} "
          f"({r['err0'] / max(r['err1'], 1e-9):.1f}x reduction), loss {r['loss0']:.6f} -> "
          f"{r['loss1']:.6f}, {r['ms_per_step']:.0f} ms/step = "
          f"{r['ms_per_step'] / S:.1f} ms per fwd+bwd sample pass ({r['steps']} steps)")
    if r["err1"] >= r["err0"] * 0.35:
        print("albedo did not recover", file=sys.stderr)
        return 1
    print("RECOVERED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
