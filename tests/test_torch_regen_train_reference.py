"""The regenerating training configuration of the benchmark (cell
``suzanne-train-1024-regen8``: configuration ``suzanne-prb``, traffic
``portbench/traffic/train-1024-regen8.json``) on the CPU, at 8x8 with 3
sample passes a step and the cell's 2 compared steps.

  * The port's regenerating step (``parallel/train.make_sharded_train_step``
    with ``passes_per_step`` > 1, the kernels' plain versions), run by the
    cell's job, agrees with the plain reference
    (``portbench/reference/train_regen.py``) under the cell's limits.
  * The reference in bfloat16 in the program's place fails them, and so do
    the float64 reference with half of the pixels left out and with the
    diffuse gradient altered by 10 %.
  * A traced regenerating step counts ``k4.replay_slots``, the chain's
    ``cnt.sum()``, under the step's root; untraced, it counts nothing.
  * The cell's per-layer metrics read nothing where the program recorded
    no span, counter or device trace.
"""

import os
import sys

import numpy as np
import pytest
import torch

from portbench import control, core
from pt_three_ways_tpu_torch.models import replay
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.scene import SceneBuilder, auto_epsilon
from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step
from pt_three_ways_tpu_torch.utils import tracing
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_megakernel import one_torch_thread  # noqa: E402, F401 (autouse fixture)

CELL = "suzanne-train-1024-regen8"
TINY = {"width": 8, "height": 8, "passes_per_step": 3}
SEED = 2 ** 33 + 2121
METRICS = ["k4_replay_ms.train", "k4_replay_mbounces_per_s.train", "k9_ms.train",
           "k9_roofline.train", "camera_stage_ms.regen"]


@pytest.fixture
def fresh_tracing():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _cell():
    """(configuration, traffic at the tiny size, limits) of the cell."""
    bench = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[CELL]
    cfg_file = {c["name"]: c for c in bench["configs"]}[w["config"]]["file"]
    traffic = core.load_json(os.path.join(core.HERE, "traffic", w["traffic"] + ".json"))
    traffic.update(TINY)
    return (core.load_json(os.path.join(core.ROOT, cfg_file)), traffic,
            core.load_json(os.path.join(core.HERE, "limits", CELL + ".json")))


def test_port_regen_steps_agree_with_the_reference(fresh_tracing):
    """The cell's job as a run drives it: set-up's compared steps, then the
    check (the window's timing has no part in it)."""
    config, traffic, limits = _cell()
    assert traffic["kind"] == "train_regen" and traffic["check_steps"] == 2
    job = core.load_module(os.path.join(core.HERE, "jobs", "train_regen.py"), "t_regen_job")
    ctx = core.Ctx(CELL, config, traffic, SEED, 0.0, "cpu")
    job.setup(ctx)
    job.release(ctx)
    nums = job.check(ctx)
    assert set(nums) == set(limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(nums[k] <= limits[k] for k in nums), nums
    # the same draws and paths: float32 rounding alone
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-3, nums


@pytest.mark.parametrize("fault", [None, "half", "altered"])
def test_control_and_planted_faults_fail_the_limits(fault):
    r = control.control(CELL, SEED, None, device="cpu", traffic_override=TINY, fault=fault)
    if fault is None:
        assert r["dtype"] == str(torch.bfloat16)
    assert r["not_correct"], r


def _step_inputs():
    cfg = _cell()[0]
    w, h = TINY["width"], TINY["height"]
    params = RenderParams(width=w, height=h, max_depth=cfg["max_depth"],
                          first_bounce_u_samples=cfg["first_bounce_u"],
                          first_bounce_v_samples=cfg["first_bounce_v"], intersector="kernel")
    sb = SceneBuilder()
    camera = create_scene(sb, cfg["scene"], params)
    scene = sb.build()
    params = params.replace(epsilon=auto_epsilon(scene, camera))
    step = make_sharded_train_step(scene, params, mesh=None, fused="auto",
                                   passes_per_step=TINY["passes_per_step"], device="cpu")
    flat = torch.arange(w * h, dtype=torch.int32)
    target = torch.rand((w * h, 3), generator=torch.Generator().manual_seed(7)) * 0.3
    return step, TrainState(scene.materials, camera, 0), flat % w, flat // w, target


def _counted_step(monkeypatch, traced: bool):
    """One regenerating step, the per-lane counts of its K4 launches kept."""
    counts = []
    launch = replay.fused_passes_krng

    def kept(*a, **kw):
        out = launch(*a, **kw)
        counts.append(out[1].clone())
        return out

    monkeypatch.setattr(replay, "fused_passes_krng", kept)
    step, state, px, py, target = _step_inputs()
    if traced:
        tracing.enable()
    try:
        step(state, torch.tensor([12345, 678]), px, py, target)
    finally:
        tracing.disable()
    return counts, tracing.snapshot()


def test_traced_step_counts_the_chains_replay_slots(monkeypatch, fresh_tracing):
    counts, snap = _counted_step(monkeypatch, traced=True)
    assert len(counts) == 1
    want = float(counts[0].sum())
    assert want > 0
    (root,) = [s["id"] for s in snap["spans"]
               if s["parent"] is None and s["name"] == "pt3.train.step"]
    assert snap["unit_counters"][root]["k4.replay_slots"] == want
    assert snap["counters"]["k4.replay_slots"] == want


def test_untraced_step_counts_nothing(monkeypatch, fresh_tracing):
    counts, snap = _counted_step(monkeypatch, traced=False)
    assert len(counts) == 1 and float(counts[0].sum()) > 0
    assert snap["counters"] == {} and snap["spans"] == []


class _Ctx:
    """A run's context where the program recorded no unit and no device trace."""

    def __init__(self):
        self.job = {"attempted": 0}
        self.units = 0
        self.tracer = None
        self.config = _cell()[0]
        self.traffic = core.load_json(os.path.join(core.HERE, "traffic",
                                                   "train-1024-regen8.json"))


@pytest.mark.parametrize("name", METRICS)
def test_cell_metrics_read_nothing_without_records(name, fresh_tracing):
    mod = core.load_module(os.path.join(core.HERE, "metrics", name + ".py"),
                           "t_regen_" + name.replace(".", "_"))
    ctx = _Ctx()
    assert mod.value(ctx, None) is None
    assert mod.value(ctx, tracing) is None


def test_k9_bytes_a_pass():
    mod = core.load_module(os.path.join(core.HERE, "metrics", "k9_roofline.train.py"),
                           "t_regen_k9_bytes")
    lanes, s_count, slots = 16 * 1024 * 1024, 8, 3.0e7
    got = mod.bytes_per_pass(slots, lanes, s_count)
    want = 52 * slots + lanes * (12 + 8 + 40 * s_count) / s_count
    assert np.isclose(got, want, rtol=1e-12)
