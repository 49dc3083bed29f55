"""One run of one cell: set-up, the measured window, the check, the result.

``run.py`` calls ``main``. Everything that belongs to one configuration,
traffic mix, per-layer metric or cell is found by name:

* ``BENCHMARK.json`` (the checkout's root): the cell, its metrics;
* ``portbench/configs/<config>.json``: the configuration (``configs[].file``);
* ``portbench/traffic/<traffic>.json``: the traffic mix; its ``kind`` names
  the job, ``portbench/jobs/<kind>.py``, which drives the program;
* ``portbench/metrics/<name>.py``: a per-layer metric (``install(ctx)`` and
  ``value(ctx, state)``);
* ``portbench/limits/<cell>.json``: the limit of each number the check
  compares.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pt_three_ways_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` this cell reports: those that list it,
    and those without a list whose ``moves`` (per-layer) the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


class Ctx:
    """What a run knows: the cell's files, the device, the window's state
    and the program objects the job keeps."""

    def __init__(self, cell, config, traffic, seed, seconds, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.cuda = device.startswith("cuda")
        self.active = False
        self.units = 0  # frames or sample passes the window finished
        self.layer = {}  # per-layer numbers the job measures itself
        self.job = {}  # the job's program objects and readings
        self.trace_result = None
        self.unit_s = []  # seconds of each frame or step of the window
        self.tracer = None
        self._close = []

    def unit_done(self, seconds: float, units: int = 1):
        """A job's frame or step ended (synchronised) after ``seconds``; the
        device trace stops at the first such boundary past its length."""
        self.unit_s.append(seconds)
        self.units += units
        if self.tracer is not None and self.tracer.due():
            self.tracer.stop()

    def synchronize(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def on_close(self, fn):
        self._close.append(fn)

    def close(self):
        while self._close:
            self._close.pop()()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _finite(v) -> float:
    """A compared number for the result line; a non-finite one reads as the
    largest float, above any limit."""
    v = float(v)
    return v if v == v and abs(v) != float("inf") else 1.7976931348623157e308


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: int, device: str = "cuda",
             t0: float | None = None, traffic_override: dict | None = None):
    """One run; returns (result dict, check lines). Raises on a run that
    cannot report."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    traffic.update(traffic_override or {})
    limits = load_json(os.path.join(HERE, "limits", cell + ".json"))
    import torch

    if device.startswith("cuda"):
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise SystemExit(f"{cell} needs {w['chips']} CUDA card(s); this machine has {n}")
    ctx = Ctx(cell, config, traffic, seed, seconds, device)
    job = load_module(os.path.join(HERE, "jobs", traffic["kind"] + ".py"), "portbench_job")
    layer = []
    try:
        if trace:
            for m in cell_metrics(bench, cell, "per_layer"):
                mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                                  "portbench_metric_" + m["name"].replace(".", "_"))
                layer.append((m, mod, mod.install(ctx)))
        job.setup(ctx)
        ctx.synchronize()
        setup_s = time.perf_counter() - t0
        if ctx.cuda:
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        ctx.active = True
        if trace and ctx.cuda:
            from .trace import DeviceTrace

            ctx.tracer = DeviceTrace()
            ctx.tracer.start()
        e2e = job.window(ctx)
        ctx.synchronize()
        if ctx.tracer is not None:
            ctx.tracer.stop()
            t_red = time.perf_counter()
            ctx.trace_result = ctx.tracer.reduce()
            ctx.job.setdefault("info", {}).update(
                trace_stop_s=ctx.trace_result.pop("stop_s", None),
                trace_reduce_s=time.perf_counter() - t_red)
        ctx.active = False
        e2e["setup_s"] = setup_s
        peak = 0
        if ctx.cuda:
            win_peak = torch.cuda.max_memory_allocated()
            e2e["peak_mem_gib"] = win_peak / 2 ** 30
            peak = max(setup_peak, win_peak)
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"the run's process holds {bad} after the window")
        metrics = {}
        if trace:
            for m, mod, state in layer:
                v = mod.value(ctx, state)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            for m in cell_metrics(bench, cell, "end_to_end"):
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
        attempted, failed = ctx.job.get("attempted", 0), ctx.job.get("failed", 0)
    finally:
        ctx.close()
    job.release(ctx)
    t_check = time.perf_counter()
    numbers = job.check(ctx)
    ctx.job.setdefault("info", {})["check_s"] = time.perf_counter() - t_check
    check = {k: {"value": _finite(v), "limit": float(limits[k])} for k, v in numbers.items()}
    correct = failed == 0 and attempted > 0 and all(
        c["value"] <= c["limit"] for c in check.values())
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics}
    if ctx.cuda:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    tr = ctx.trace_result
    if tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["check"] = check
    lines = [f"info {k} {v!r}" for k, v in sorted(e2e.items()) if k not in metrics]
    lines += [f"info {k} {v!r}" for k, v in sorted(ctx.job.get("info", {}).items())]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in check.items()]
    return result, lines


def main(argv=None, t0: float | None = None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    print(f"card: {card_line()}", file=sys.stderr)
    result, lines = run_cell(a.workload, a.seed, a.seconds, a.trace, t0=t0)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
