"""The per-layer metrics that read the program's own spans and counters
(``spans.py`` and its six metric modules): a ``--trace 1`` run on the CPU
at a tiny size reports the host-clock ones from the window's units alone,
each metric reads only the window's roots of a recorded snapshot and None
where nothing was timed, and the uniforms' device time is the kernels'
launched inside the ``pt3.rng`` ranges of the device trace."""

import os
import types

import pytest

from portbench import core

SEED = 2 ** 31 + 4242
TINY = {
    "cornell-frames-1080p-40spp": {"width": 16, "height": 10, "spp": 2, "check_pixels": 8},
    "suzanne-frames-256-8spp": {"width": 12, "height": 12, "spp": 2, "check_pixels": 8},
    "suzanne-train-512-s1": {"width": 10, "height": 10},
}
METRICS = ["rng_ms.render", "rng_ms.train", "autotune_ms.render", "host_wait_ms.render",
           "host_wait_ms.train", "k4_mbounces_per_s.render"]


def _metric(name):
    return core.load_module(os.path.join(core.HERE, "metrics", name + ".py"),
                            "t_spans_" + name.replace(".", "_"))


@pytest.fixture
def tracing():
    from pt_three_ways_tpu_torch.utils import tracing

    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_cpu_run_reads_the_window_units(tracing, cell):
    res, _ = core.run_cell(cell, SEED, 0.01, 1, device="cpu", traffic_override=TINY[cell])
    assert res["correct"] and not tracing.enabled()
    train = "train" in cell
    root = "pt3.train.step" if train else "pt3.render"
    snap = tracing.snapshot()
    roots = [s["id"] for s in snap["spans"] if s["parent"] is None and s["name"] == root]
    n = res["attempted"]
    warm = 3 if train else 1  # the check's first steps, or the warm frame
    assert len(roots) == n + warm
    keep = set(roots[-n:])
    wait = sum(s["host_ms"] for s in snap["spans"]
               if s["root"] in keep and s["name"].startswith("pt3.sync."))
    name = "host_wait_ms." + ("train" if train else "render")
    assert res["metrics"][name]["value"] == pytest.approx(wait / n)
    # no CUDA events and no autotune on the CPU: nothing to read
    for m in ("rng_ms.render", "rng_ms.train", "k4_mbounces_per_s.render",
              "autotune_ms.render"):
        assert m not in res["metrics"]


def _span(i, name, parent, root, host, device):
    return dict(id=i, name=name, parent=parent, root=root, host_ms=host, host_self_ms=host,
                device_ms=device, device_self_ms=device)


def _unit(first, root, scale, device=True):
    """One unit's spans from id ``first``: its root, a camera stage with
    two uniforms, K4, the autotune and two reads; times grow with ``scale``."""
    d = (lambda x: x * scale) if device else (lambda x: None)
    r = first
    return [
        _span(r, root, None, r, 100.0 * scale, d(90.0)),
        _span(r + 1, "pt3.camera", r, r, 50.0 * scale, d(40.0)),
        _span(r + 2, "pt3.rng", r + 1, r, 1.0 * scale, d(10.0)),
        _span(r + 3, "pt3.rng", r + 1, r, 1.0 * scale, d(5.0)),
        _span(r + 4, "pt3.k4", r, r, 2.0 * scale, d(20.0)),
        _span(r + 5, "pt3.render.autotune", r, r, 7.0 * scale, None),
        _span(r + 6, "pt3.sync.autotune", r + 5, r, 3.0 * scale, None),
        _span(r + 7, "pt3.sync.materials", r, r, 4.0 * scale, None),
    ]


def _recorded(root, device=True):
    """A snapshot of set-up (a scene build and a warm unit) and the
    window's two units."""
    sp = [_span(0, "pt3.scene.build", None, 0, 9.0, None)]
    sp += _unit(1, root, 1000.0, device) + _unit(9, root, 1.0, device) \
        + _unit(17, root, 2.0, device)
    unit_counters = {1: {"k4.live_bounces": 5e9}, 9: {"k4.live_bounces": 4e6},
                     17: {"k4.live_bounces": 8e6}}
    return types.SimpleNamespace(snapshot=lambda: dict(spans=sp, counters={},
                                                        unit_counters=unit_counters))


def _ctx(attempted=2, units=2):
    return types.SimpleNamespace(job={"attempted": attempted}, units=units)


@pytest.mark.parametrize("name,root,want", [
    ("autotune_ms.render", "pt3.render", (7.0 + 14.0) / 2),
    ("host_wait_ms.render", "pt3.render", (7.0 + 14.0) / 2),
    ("host_wait_ms.train", "pt3.train.step", (7.0 + 14.0) / 2),
    # 12e6 bounces in 20 + 40 ms of K4: 200 M a second
    ("k4_mbounces_per_s.render", "pt3.render", 12e6 / 60.0 / 1e3),
])
def test_metric_reads_only_the_window_roots(name, root, want):
    mod = _metric(name)
    assert mod.value(_ctx(), _recorded(root)) == pytest.approx(want)
    other = "pt3.train.step" if root == "pt3.render" else "pt3.render"
    assert mod.value(_ctx(), _recorded(other)) is None  # no unit of its kind
    assert mod.value(_ctx(attempted=4, units=4), _recorded(root)) is None  # too few units
    assert mod.value(_ctx(), None) is None  # a program without spans
    if name.startswith("k4"):  # timed on the device only
        assert mod.value(_ctx(), _recorded(root, device=False)) is None


class _Event:
    """A ``torch.profiler`` event as Kineto reports it."""

    def __init__(self, name, start, duration, corr=0, link=0, device=False):
        self._v = (name, start, duration, corr, link, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._v[5] else torch.autograd.DeviceType.CPU


def _traced_ctx(root, units=2, attempted=2, window_s=1.0):
    """Two traced units: kernels launched by operations inside the
    ``pt3.rng`` ranges (one nested in another, one launched by the range
    itself) take 7 + 11 + 5 ns; the others (an operation outside the
    ranges, a runtime call whose id repeats an operation's, an operation
    the trace does not hold) must not count."""
    ev = [
        _Event(root, 0, 1000, corr=20), _Event(root, 1000, 1000, corr=21),
        _Event("pt3.rng", 100, 100, corr=10), _Event("pt3.rng", 120, 30, corr=11),
        _Event("pt3.rng", 1100, 200, corr=12),
        _Event("aten::bitwise_xor", 150, 5, corr=1), _Event("aten::add", 250, 5, corr=2),
        _Event("aten::mul", 1200, 5, corr=3), _Event("cudaLaunchKernel", 160, 2, corr=2, link=1),
        _Event("xor_kernel", 300, 7, link=1, device=True),
        _Event("add_kernel", 310, 100, link=2, device=True),
        _Event("mul_kernel", 1400, 11, link=3, device=True),
        _Event("bare_kernel", 210, 5, link=10, device=True),
        _Event("lost_kernel", 500, 1000, link=99, device=True),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    return types.SimpleNamespace(job={"attempted": attempted}, units=units,
                                 tracer=types.SimpleNamespace(window_s=window_s, prof=prof))


@pytest.mark.parametrize("name,root", [("rng_ms.render", "pt3.render"),
                                       ("rng_ms.train", "pt3.train.step")])
def test_rng_metric_reads_kernel_time_inside_its_spans(name, root):
    mod = _metric(name)
    state = object()  # the program's tracing module, as install returns it
    want = (7 + 11 + 5) / 1e6 / 2
    assert mod.value(_traced_ctx(root), state) == pytest.approx(want)
    # two sample passes a step: per pass, half
    assert mod.value(_traced_ctx(root, units=4), state) == pytest.approx(want / 2)
    other = "pt3.train.step" if root == "pt3.render" else "pt3.render"
    assert mod.value(_traced_ctx(other), state) is None  # no unit of its kind traced
    assert mod.value(_traced_ctx(root), None) is None  # a program without spans
    assert mod.value(_traced_ctx(root, window_s=None), state) is None  # trace never stopped
    ctx = _traced_ctx(root)
    ctx.tracer = None  # no device trace: the CPU
    assert mod.value(ctx, state) is None


def test_per_layer_sources_are_the_benchmarks_two():
    bench = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "host_clock"), m["name"]


@pytest.mark.parametrize("name", METRICS)
def test_install_turns_recording_on_until_the_run_closes(tracing, name):
    ctx = core.Ctx("cell", {}, {}, SEED, 1.0, "cpu")
    state = _metric(name).install(ctx)
    assert state is tracing and tracing.enabled()
    ctx.close()
    assert not tracing.enabled()
