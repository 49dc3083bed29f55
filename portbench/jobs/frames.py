"""Job ``frames``: a closed loop of whole renders, as the CLI makes them.

Set-up builds the configuration's scene through the catalog and the scene
builder (timed: ``ctx.layer["scene_build_ms"]``), sets up ``RenderParams``
as the CLI does, and renders one frame that the window does not count
(every kernel built, every shape the window uses warmed). The window then
calls ``models.render.render`` back to back, frame ``i`` seeded
``inputs.frame_seed(seed, i)``, each frame's time ending in a
synchronisation, until ``--seconds`` have passed; the frame in flight then
is finished and counted. After the window, the check traces a sample of
each frame's pixels (``check_pixels`` a frame, drawn from the seed) with the
plain reference and compares the means.

Traffic keys: ``width``, ``height``, ``spp``, ``check_pixels``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check as checks
from portbench import inputs


def setup(ctx):
    from pt_three_ways_tpu_torch.models.catalog import create_scene
    from pt_three_ways_tpu_torch.models.render import render
    from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
    from pt_three_ways_tpu_torch.utils.render_params import RenderParams

    cfg, tr = ctx.config, ctx.traffic
    params = RenderParams(
        width=tr["width"], height=tr["height"], samples_per_pixel=tr["spp"],
        max_depth=cfg["max_depth"], first_bounce_u_samples=cfg["first_bounce_u"],
        first_bounce_v_samples=cfg["first_bounce_v"], dtype=cfg["dtype"],
        passes_per_dispatch=cfg["passes_per_dispatch"],
        # the kernels' route ("auto" on a card); on the CPU their plain versions
        intersector="kernel",
    )
    t = time.perf_counter()
    builder = SceneBuilder()
    camera = create_scene(builder, cfg["scene"], params)
    scene = builder.build()
    ctx.layer["scene_build_ms"] = (time.perf_counter() - t) * 1e3
    eps = cfg["epsilon"]
    params = params.replace(epsilon=auto_epsilon(scene, camera) if eps == "auto" else float(eps))
    ctx.job.update(render=render, scene=scene, camera=camera, params=params)
    render(scene, camera, params.replace(seed=inputs.frame_seed(ctx.seed, -1)), device=ctx.device)


def window(ctx) -> dict:
    j, tr = ctx.job, ctx.traffic
    render, params = j["render"], j["params"]
    w, h = params.width, params.height
    frame_ms, samples, picked = [], 0, []
    start = time.perf_counter()
    while not frame_ms or time.perf_counter() - start < ctx.seconds:
        i = len(frame_ms)
        t = time.perf_counter()
        out = render(j["scene"], j["camera"], params.replace(seed=inputs.frame_seed(ctx.seed, i)),
                     device=ctx.device)
        ctx.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        samples += out.total_samples()
        xs, ys = inputs.check_pixels(ctx.seed, i, tr["check_pixels"], w, h)
        picked.append(out.sum[ys, xs] / np.maximum(out.count[ys, xs], 1)[:, None])
        ctx.unit_done(frame_ms[-1] / 1e3)
    wall_ms = (time.perf_counter() - start) * 1e3
    j.update(picked=picked, attempted=len(frame_ms), failed=0, frame_ms=frame_ms)
    return {"samples_per_ms": samples / wall_ms,
            "frame_ms_p95": float(np.percentile(frame_ms, 95)),
            "frame_ms_median": float(np.median(frame_ms))}


def release(ctx):
    for k in ("render", "scene", "camera"):
        ctx.job.pop(k, None)
    if ctx.cuda:
        torch.cuda.empty_cache()


def check(ctx) -> dict:
    """The sampled pixels of every frame against the reference (float64)."""
    from portbench.reference import render as ref_render
    from portbench.reference import scene as ref_scene
    from portbench.reference.tracer import Geometry

    cfg, tr, j = ctx.config, ctx.traffic, ctx.job
    w, h = tr["width"], tr["height"]
    frames = []
    for i in range(len(j["picked"])):
        xs, ys = inputs.check_pixels(ctx.seed, i, tr["check_pixels"], w, h)
        frames.append((inputs.frame_seed(ctx.seed, i), xs, ys))
    rs = ref_scene.build(cfg, w, h)
    geo = Geometry(rs, ctx.device, torch.float64)
    ref, info = ref_render.pixel_means(rs, geo, w, h, tr["spp"], cfg["max_depth"],
                                       cfg["first_bounce_u"], cfg["first_bounce_v"], frames,
                                       ctx.device)
    j.setdefault("info", {})["probe_share"] = [x["probe_share"] for x in info]
    return checks.pixels(np.concatenate(j["picked"]), ref)


def control(ctx, frames: int, dtype, fault=None) -> dict:
    """The reference in ``dtype`` in the program's place, for ``frames``
    frames' sampled pixels, judged as the program's are."""
    from portbench.reference import render as ref_render
    from portbench.reference import scene as ref_scene
    from portbench.reference.tracer import Geometry

    cfg, tr = ctx.config, ctx.traffic
    w, h = tr["width"], tr["height"]
    picks = [(inputs.frame_seed(ctx.seed, i),) + tuple(inputs.check_pixels(
        ctx.seed, i, tr["check_pixels"], w, h)) for i in range(frames)]
    rs = ref_scene.build(cfg, w, h)
    args = (w, h, tr["spp"], cfg["max_depth"], cfg["first_bounce_u"], cfg["first_bounce_v"],
            picks, ctx.device)
    ref, _ = ref_render.pixel_means(rs, Geometry(rs, ctx.device, torch.float64), *args)
    low, _ = ref_render.pixel_means(rs, Geometry(rs, ctx.device, dtype), *args)
    return checks.pixels(low, ref)
