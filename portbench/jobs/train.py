"""Job ``train``: a closed loop of inverse-rendering steps.

Set-up builds the scene through the catalog (timed), perturbs its material
table from the seed (``inputs.perturb``), draws the target image from the
seed on the device, builds ONE step with
``parallel.train.make_sharded_train_step(..., mesh=None)`` and drives it
through its first ``check_steps`` steps (their losses and tables are kept
for the check; the first compiles and warms). The window goes on calling
the same step on the same state, step ``i`` keyed
``inputs.step_key(seed, i)``, each step synchronised, until ``--seconds``
have passed. After the window the reference follows the first steps.

Traffic keys: ``width``, ``height`` (every pixel is traced each step),
``passes_per_step``, ``learning_rate``, ``fused``, ``perturb``,
``target_scale``, ``check_steps``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check as checks
from portbench import inputs


def _rows(m) -> np.ndarray:
    return torch.cat([m.emission, m.diffuse, m.ior[:, None], m.reflectivity[:, None],
                      m.cone_angle[:, None]], 1).detach().double().cpu().numpy()


def _key(seed, i):
    return torch.tensor(list(inputs.step_key(seed, i)), dtype=torch.int64)


def setup(ctx):
    from pt_three_ways_tpu_torch.models.catalog import create_scene
    from pt_three_ways_tpu_torch.models.materials import MaterialTable
    from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step
    from pt_three_ways_tpu_torch.utils.render_params import RenderParams

    cfg, tr = ctx.config, ctx.traffic
    params = RenderParams(
        width=tr["width"], height=tr["height"], max_depth=cfg["max_depth"],
        first_bounce_u_samples=cfg["first_bounce_u"], first_bounce_v_samples=cfg["first_bounce_v"],
        dtype=cfg["dtype"], intersector="kernel")
    t = time.perf_counter()
    builder = SceneBuilder()
    camera = create_scene(builder, cfg["scene"], params)
    scene = builder.build()
    ctx.layer["scene_build_ms"] = (time.perf_counter() - t) * 1e3
    eps = cfg["epsilon"]
    params = params.replace(epsilon=auto_epsilon(scene, camera) if eps == "auto" else float(eps))
    rows = inputs.perturb(_rows(scene.materials), ctx.seed, tr["perturb"])
    t_rows = torch.as_tensor(rows)
    mats = MaterialTable(t_rows[:, 0:3].contiguous(), t_rows[:, 3:6].contiguous(),
                         t_rows[:, 6].contiguous(), t_rows[:, 7].contiguous(),
                         t_rows[:, 8].contiguous())
    n = tr["width"] * tr["height"]
    flat = torch.arange(n, dtype=torch.int32)
    px, py = flat % tr["width"], flat // tr["width"]
    dev = torch.device(ctx.device)
    target = inputs.target(ctx.seed, n, dev, tr["target_scale"])
    step = make_sharded_train_step(scene, params, mesh=None, fused=tr["fused"],
                                   passes_per_step=tr["passes_per_step"],
                                   learning_rate=tr["learning_rate"], device=dev)
    state = TrainState(mats, camera, 0)
    losses, tables = [], [rows.astype(np.float64)]
    for i in range(tr["check_steps"]):
        loss, state = step(state, _key(ctx.seed, i), px, py, target)
        losses.append(float(loss))
        tables.append(_rows(state.materials))
    ctx.job.update(step=step, state=state, px=px, py=py, target=target, losses=losses,
                   tables=tables)


def window(ctx) -> dict:
    j, tr = ctx.job, ctx.traffic
    step, state = j["step"], j["state"]
    i = tr["check_steps"]
    n = 0
    start = time.perf_counter()
    while n == 0 or time.perf_counter() - start < ctx.seconds:
        t = time.perf_counter()
        loss, state = step(state, _key(ctx.seed, i + n), j["px"], j["py"], j["target"])
        ctx.synchronize()
        n += 1
        ctx.unit_done(time.perf_counter() - t, tr["passes_per_step"])
        if not bool(torch.isfinite(loss)):
            j["failed"] = j.get("failed", 0) + 1
    wall_ms = (time.perf_counter() - start) * 1e3
    j.update(attempted=n, state=state)
    j.setdefault("failed", 0)
    return {"train_ms_per_pass": wall_ms / (n * tr["passes_per_step"])}


def release(ctx):
    for k in ("step", "state"):
        ctx.job.pop(k, None)
    if ctx.cuda:
        torch.cuda.empty_cache()


def reference_steps(ctx, dtype=torch.float64, search_dtype=torch.float32, fault=None):
    """The reference's losses and tables over the compared steps; ``fault``
    plants one of the check's faults in it: ``"half"`` (half of the pixels
    left out, the mean over the rest) or ``"altered"`` (the diffuse
    gradient 10 % off where it is formed)."""
    from portbench.reference import scene as ref_scene
    from portbench.reference import train as ref_train
    from portbench.reference.tracer import Geometry

    cfg, tr, j = ctx.config, ctx.traffic, ctx.job
    rs = ref_scene.build(cfg, tr["width"], tr["height"])
    geo = Geometry(rs, ctx.device, dtype, search_dtype)
    rows = inputs.perturb(rs.materials.astype(np.float32), ctx.seed, tr["perturb"])
    dev = torch.device(ctx.device)
    keys = [inputs.step_key(ctx.seed, i) for i in range(tr["check_steps"])]
    px, py, target = j["px"].to(dev, torch.int64), j["py"].to(dev, torch.int64), j["target"]
    scale = None
    if fault == "half":
        h = px.shape[0] // 2
        px, py, target = px[:h], py[:h], target[:h]
    elif fault == "altered":
        scale = torch.tensor([1.0] * 3 + [1.1] * 3 + [1.0] * 3, dtype=torch.float64)
    losses, tables, _ = ref_train.steps(
        rs, geo, torch.as_tensor(rows, dtype=torch.float64, device=dev), keys, px, py, target,
        tr["learning_rate"], cfg["max_depth"] - 1, cfg["first_bounce_u"], cfg["first_bounce_v"],
        grad_scale=scale)
    return losses, [t.double().cpu().numpy() for t in tables]


def check(ctx) -> dict:
    if ctx.traffic["passes_per_step"] != 1:
        raise ValueError("the reference follows the per-pass step only")
    losses, tables = reference_steps(ctx)
    j = ctx.job
    return checks.training(j["losses"], losses, j["tables"], tables, ctx.traffic["learning_rate"])


def control(ctx, steps: int, dtype, fault=None) -> dict:
    """The reference in ``dtype`` (its searches too) in the program's place
    over the compared steps, judged as the program's are; with ``fault``,
    the float64 reference with that fault planted instead."""
    tr = ctx.traffic
    n = tr["width"] * tr["height"]
    flat = torch.arange(n, dtype=torch.int32)
    ctx.job.update(px=flat % tr["width"], py=flat // tr["width"],
                   target=inputs.target(ctx.seed, n, torch.device(ctx.device), tr["target_scale"]))
    losses, tables = reference_steps(ctx)
    if fault is None:
        low_l, low_t = reference_steps(ctx, dtype, dtype)
    else:
        low_l, low_t = reference_steps(ctx, fault=fault)
    return checks.training(low_l, losses, low_t, tables, tr["learning_rate"])
