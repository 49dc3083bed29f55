"""The port's spans and counters (``pt_three_ways_tpu_torch/utils/tracing``)
on the CPU.

  * Off (the default), ``span`` is one shared null context and a render
    records nothing; the same render with tracing on is bit-equal.
  * On, a render is one ``pt3.render`` root with the camera stage, K2 and
    K4 under its launches, and ``k4.live_bounces`` is the sum of the lane
    counts K4 returns; the CPU autotune (on a one-device mesh) is one
    ``pt3.render.autotune``; a per-pass training step is one
    ``pt3.train.step`` with its forward, backward and update, one
    material read and a K8 span a bounce; a feedback-sorted K4 launch has
    its two ``pt3.sort`` spans beside ``pt3.k4``, an unsorted one none.
  * The spans land in ``torch.profiler``'s trace, nested as recorded, and
    the CLI's ``--trace-out`` writes them.
"""

import collections
import json
import os
import sys

import numpy as np
import pytest
import torch

from pt_three_ways_tpu_torch.cli import main as cli_main
from pt_three_ways_tpu_torch.models.catalog import create_scene
from pt_three_ways_tpu_torch.models.render import render, render_rounds
from pt_three_ways_tpu_torch.models.scene import SceneBuilder
from pt_three_ways_tpu_torch.ops import megakernel, rng
from pt_three_ways_tpu_torch.utils import tracing
from pt_three_ways_tpu_torch.utils.render_params import RenderParams

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_megakernel import one_torch_thread  # noqa: E402, F401 (autouse fixture)


@pytest.fixture(autouse=True)
def fresh_tracing():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _scene(name="cornell", **kw):
    params = RenderParams(intersector="kernel", **kw)
    sb = SceneBuilder()
    camera = create_scene(sb, name, params)
    return sb.build(), camera, params


def _traced(fn, *args, **kw):
    tracing.enable()
    try:
        out = fn(*args, **kw)
    finally:
        tracing.disable()
    return out, tracing.snapshot()


def _children(snap, parent_name):
    """{child name: count} of the spans whose parent is named ``parent_name``."""
    sp = snap["spans"]
    return collections.Counter(s["name"] for s in sp
                               if s["parent"] is not None and sp[s["parent"]]["name"] == parent_name)


def _named(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_off_records_nothing_and_on_renders_the_same_image():
    assert tracing.span("pt3.a") is tracing.span("pt3.b", "cpu")
    scene, camera, params = _scene(width=16, height=16, samples_per_pixel=16, seed=7)
    off = render(scene, camera, params, device="cpu")
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    on, snap = _traced(render, scene, camera, params, device="cpu")
    assert snap["spans"]
    np.testing.assert_array_equal(on.sum, off.sum)
    np.testing.assert_array_equal(on.count, off.count)


def test_render_span_tree_and_live_bounce_counter(monkeypatch):
    scene, camera, params = _scene(width=8, height=8, samples_per_pixel=3, seed=5)
    _, snap = _traced(render, scene, camera, params, device="cpu")
    _traced(render, scene, camera, params, device="cpu")
    snap2 = tracing.snapshot()
    roots = [s for s in snap2["spans"] if s["parent"] is None]
    assert [s["name"] for s in roots] == ["pt3.render", "pt3.render"]
    assert all(s["root"] == s["id"] for s in roots)
    assert all(s["root"] in {r["id"] for r in roots} for s in snap2["spans"])

    launches = _named(snap, "pt3.render.launch")
    assert len(launches) == 3  # one pass a launch on the CPU
    assert len(_named(snap, "pt3.k4")) == len(launches)
    assert _children(snap, "pt3.render.launch")["pt3.camera"] == 3
    camera_parts = _children(snap, "pt3.camera")
    assert camera_parts["pt3.rng"] == 2 * 3 and camera_parts["pt3.k2"] == 3
    assert camera_parts["pt3.camera.rays"] == 3
    assert _children(snap, "pt3.render.drain") == {"pt3.sync.drain": 3}
    assert _children(snap, "pt3.render")["pt3.render.pack"] == 1
    for s in snap["spans"]:
        assert s["host_ms"] >= 0 and s["host_self_ms"] >= -1e-6
        assert s["device_ms"] is None  # no CUDA events on the CPU

    # the counter is the lanes' counts as trace_passes_fused returns them
    from pt_three_ways_tpu_torch.models.integrator import trace_passes_fused

    # counted under the frame's root, after K4's span has closed
    tracing.reset()
    innermost = []
    count = tracing.count

    def count_where(name, value):
        innermost.append(tracing._spans[tracing._open[-1]][0] if tracing._open else None)
        count(name, value)

    def frame(*args, **kw):
        with tracing.span("pt3.render"):
            return trace_passes_fused(*args, **kw)

    monkeypatch.setattr(tracing, "count", count_where)
    px = torch.arange(64, dtype=torch.int32) % 8
    py = torch.arange(64, dtype=torch.int32) // 8
    (_, cnts), snap = _traced(frame, scene, camera, params, rng.base_key(5), 0,
                              0, px, py, 2, with_lane_counts=True)
    assert int(cnts.sum()) > 0
    assert innermost == ["pt3.render"]
    assert snap["counters"] == {"k4.live_bounces": float(cnts.sum())}
    assert snap["unit_counters"] == {_named(snap, "pt3.render")[0]["id"]:
                                     {"k4.live_bounces": float(cnts.sum())}}


def _ancestors(snap, s):
    sp, out = snap["spans"], []
    while s["parent"] is not None:
        s = sp[s["parent"]]
        out.append(s["name"])
    return out


@pytest.mark.parametrize("sorted_lanes", [True, False], ids=["sort_key", "no_sort_key"])
def test_feedback_sort_span(sorted_lanes):
    """With a sort key, the permutations before and after K4 are two
    ``pt3.sort`` spans under the frame's root, outside ``pt3.k4``; without
    one there is none. The counters are K4's live bounces alone either way,
    and the sort moves no pixel."""
    from pt_three_ways_tpu_torch.models.integrator import trace_passes_fused

    scene, camera, params = _scene(width=8, height=8, samples_per_pixel=2, seed=5)
    px = torch.arange(64, dtype=torch.int32) % 8
    py = torch.arange(64, dtype=torch.int32) // 8
    n = 64 * params.first_bounce_samples
    key = torch.randint(0, 9, (n,), generator=torch.Generator().manual_seed(3),
                        dtype=torch.int32) if sorted_lanes else None

    def frame(sort_key):
        with tracing.span("pt3.render"):
            return trace_passes_fused(scene, camera, params, rng.base_key(5), 0, 0, px, py, 2,
                                      sort_key=sort_key, with_lane_counts=True)

    (rad, cnts), snap = _traced(frame, key)
    root = _named(snap, "pt3.render")[0]["id"]
    sort = _named(snap, "pt3.sort")
    assert len(sort) == (2 if sorted_lanes else 0)
    assert len(_named(snap, "pt3.k4")) == 1
    for s in sort:
        assert s["root"] == root and "pt3.k4" not in _ancestors(snap, s)
    for s in _named(snap, "pt3.k4"):
        assert "pt3.sort" not in _ancestors(snap, s)
    assert snap["counters"] == {"k4.live_bounces": float(cnts.sum())}
    plain_rad, plain_cnts = trace_passes_fused(scene, camera, params, rng.base_key(5), 0, 0,
                                               px, py, 2, with_lane_counts=True)
    assert torch.equal(rad, plain_rad) and torch.equal(cnts, plain_cnts)


def test_cpu_autotune_on_a_one_device_mesh_is_one_span():
    from pt_three_ways_tpu_torch.parallel.mesh import one_device_mesh

    scene, camera, params = _scene(width=8, height=4, samples_per_pixel=10, seed=2)
    _, snap = _traced(render_rounds, scene, camera, params, one_device_mesh("cpu"), "dod",
                      1024, None, 0.0, False, None, "cpu")
    tune = _named(snap, "pt3.render.autotune")
    assert len(tune) == 1
    assert snap["spans"][tune[0]["parent"]]["name"] == "pt3.render"
    assert _children(snap, "pt3.render.autotune") == {"pt3.sync.autotune": 1}
    # the probe round (8 passes) and the rest after the decision
    assert len(_named(snap, "pt3.render.launch")) >= 2


def test_train_step_spans():
    from pt_three_ways_tpu_torch.parallel.train import TrainState, make_sharded_train_step

    scene, camera, params = _scene(width=6, height=5, max_depth=4, first_bounce_u_samples=2,
                                   first_bounce_v_samples=2)
    step = make_sharded_train_step(scene, params, device="cpu")
    n = params.width * params.height
    px = torch.arange(n, dtype=torch.int32) % params.width
    py = torch.arange(n, dtype=torch.int32) // params.width
    target = torch.full((n, 3), 0.5)
    state = TrainState(scene.materials, camera, 0)
    (loss, new), snap = _traced(step, state, rng.base_key(3), px, py, target)
    assert torch.isfinite(loss) and new.step == 1
    roots = [s for s in snap["spans"] if s["parent"] is None]
    assert [s["name"] for s in roots] == ["pt3.train.step"]
    assert _children(snap, "pt3.train.step") == {
        "pt3.sync.inputs": 1, "pt3.train.forward": 1, "pt3.train.backward": 1,
        "pt3.train.update": 1}
    assert len(_named(snap, "pt3.sync.materials")) == 1
    k8 = _named(snap, "pt3.k8")
    assert len(k8) == params.max_depth - 1
    assert {snap["spans"][s["parent"]]["name"] for s in k8} == {"pt3.train.backward"}
    forward = _children(snap, "pt3.train.forward")
    assert forward["pt3.camera"] == 1
    # the camera's, the first bounce's and K7's rows, one a bounce
    assert _children(snap, "pt3.camera")["pt3.rng"] == 2 + params.max_depth - 1
    assert len(_named(snap, "pt3.k7")) == 1 and len(_named(snap, "pt3.k2")) == 1


def test_spans_land_in_the_profiler_trace_nested_as_recorded():
    from torch.profiler import ProfilerActivity, profile

    scene, camera, params = _scene(width=8, height=8, samples_per_pixel=2, seed=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, snap = _traced(render, scene, camera, params, device="cpu")
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pt3."):
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    seen = collections.Counter()
    interval = {}
    for s in snap["spans"]:  # the k-th span of a name is its k-th event
        got = sorted(events[s["name"]])
        assert len(got) == len(_named(snap, s["name"])), s["name"]
        interval[s["id"]] = got[seen[s["name"]]]
        seen[s["name"]] += 1
    for s in snap["spans"]:
        if s["parent"] is not None:
            (a, b), (pa, pb) = interval[s["id"]], interval[s["parent"]]
            assert pa <= a and b <= pb, (s["name"], snap["spans"][s["parent"]]["name"])


def test_snapshot_self_times_and_counters():
    tracing.enable()
    with tracing.span("pt3.outer"):
        tracing.count("c", 2)
        with tracing.span("pt3.inner"):
            tracing.count("c", torch.tensor([1, 2, 3], dtype=torch.int32))
        with tracing.span("pt3.inner"):
            pass
    tracing.count("loose", 1.5)
    with tracing.span("pt3.other"):
        tracing.count("c", 1)
    snap = tracing.snapshot()
    outer, in1, in2, other = snap["spans"]
    assert (in1["parent"], in2["parent"], in1["root"], other["root"]) == (0, 0, 0, 3)
    assert outer["host_self_ms"] == pytest.approx(
        outer["host_ms"] - in1["host_ms"] - in2["host_ms"], abs=1e-9)
    assert snap["counters"] == {"c": 9.0, "loose": 1.5}
    assert snap["unit_counters"] == {0: {"c": 8.0}, None: {"loose": 1.5}, 3: {"c": 1.0}}
    tracing.reset()
    assert tracing.snapshot() == {"spans": [], "counters": {}, "unit_counters": {}}


def test_kernel_wrappers_keep_their_counters_and_names():
    for fn in (megakernel.fused_passes_krng, megakernel.fused_passes, megakernel.fused_bounces,
               megakernel.bounce_bwd_step, megakernel.regen_replay_bwd, megakernel.bounce_step):
        assert isinstance(fn.launches, int) and fn.__wrapped__.__name__ == fn.__name__


def test_cli_trace_out_writes_the_spans(tmp_path):
    out, trace = str(tmp_path / "o.png"), str(tmp_path / "t.json")
    assert cli_main(["-w", "8", "-h", "8", "--spp", "2", "--seed", "3", "--save-every", "0",
                     "--device", "cpu", "--trace-out", trace, out]) == 0
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {"pt3.render", "pt3.scene.build", "pt3.render.launch"} <= names
    assert not tracing.enabled()
