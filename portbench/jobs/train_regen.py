"""Job ``train_regen``: a closed loop of regenerating inverse-rendering steps.

Set-up, the window and the release are the ``train`` job's
(``jobs/train.py``): the same scene, perturbed table, target and step,
built by ``parallel.train.make_sharded_train_step`` with the traffic's
``passes_per_step`` = S > 1, so each step is the regenerating chain (S
camera stages, K4 in replay mode, K9's reverse walk, one SGD update). The
check follows the first ``check_steps`` steps with the regenerating
reference (``reference/train_regen.py``); the second of them traces with
the table the first step moved, so a stale material row in K4's pack fails
it.

Traffic keys: those of ``train``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import check as checks
from portbench import inputs
from portbench.jobs.train import release, setup, window  # noqa: F401 (the job's contract)


def reference_steps(ctx, dtype=torch.float64, search_dtype=torch.float32, fault=None):
    """The reference's losses and tables over the compared steps; ``fault``
    plants one of the check's faults in it: ``"half"`` (half of the pixels
    left out, the mean over the rest) or ``"altered"`` (the diffuse
    gradient 10 % off where it is formed)."""
    from portbench.reference import scene as ref_scene
    from portbench.reference import train_regen as ref_train
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
    losses, tables = ref_train.steps(
        rs, geo, torch.as_tensor(rows, dtype=torch.float64, device=dev), keys, px, py, target,
        tr["learning_rate"], cfg["max_depth"] - 1, tr["passes_per_step"], tr["width"],
        cfg["first_bounce_u"], cfg["first_bounce_v"], grad_scale=scale)
    return losses, [t.double().cpu().numpy() for t in tables]


def check(ctx) -> dict:
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
