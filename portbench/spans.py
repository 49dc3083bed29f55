"""The program's own spans and counters (``pt_three_ways_tpu_torch.utils
.tracing``), as the per-layer metrics that read them see them.

``install`` turns the program's recording on for the run and off again
when the run closes its context, so only ``--trace 1`` runs record. A
checkout whose program has no such module records nothing: ``install``
returns None and every reading is None. ``window`` keeps the units of the
measured window: the last ``ctx.job["attempted"]`` root spans of the unit's
name (``pt3.render`` a frame, ``pt3.train.step`` a step), and the spans and
counters under them; set-up's warm frame or steps come before them.

``kernel_ms`` reads the run's device trace instead (``trace.DeviceTrace``,
which only a ``--trace 1`` run on a card records): the device time of the
kernels, copies and sets launched inside the program's ranges of one name.
A span's CUDA events measure from its first to its last work on the
device, so where the host cannot keep the card fed they hold the host's
enqueueing too; the trace's kernel durations do not.
"""

from __future__ import annotations

import time

FRAME = "pt3.render"
STEP = "pt3.train.step"


def install(ctx):
    try:
        from pt_three_ways_tpu_torch.utils import tracing
    except ImportError:
        return None
    tracing.enable()
    ctx.on_close(tracing.disable)
    return tracing


def _snapshot(ctx, tracing) -> dict:
    """One snapshot a run, shared by its metrics (each synchronises)."""
    snap = getattr(ctx, "program_spans", None)
    if snap is None:
        snap = ctx.program_spans = tracing.snapshot()
    return snap


def window(ctx, tracing, root: str):
    """(spans, counters) of the window's units: every span under one of
    the last ``attempted`` roots named ``root``, and the summed counters
    of those roots. None where the program recorded no such unit."""
    n = ctx.job.get("attempted", 0)
    if tracing is None or not n or not ctx.units:
        return None
    snap = _snapshot(ctx, tracing)
    roots = [s["id"] for s in snap["spans"] if s["parent"] is None and s["name"] == root][-n:]
    if len(roots) != n:
        return None
    keep = set(roots)
    spans = [s for s in snap["spans"] if s["root"] in keep]
    counters = {}
    for r in roots:
        for k, v in snap["unit_counters"].get(r, {}).items():
            counters[k] = counters.get(k, 0.0) + v
    return spans, counters


def summed(spans, match, clock: str):
    """The summed ``clock`` ("host" or "device") milliseconds of the spans
    whose name ``match`` accepts; None where none has that clock."""
    ms = [s[clock + "_ms"] for s in spans if match(s["name"])]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None


def _trace_index(ctx) -> dict:
    """One pass over the device trace's events, shared by a run's metrics:
    the host ranges of the program's spans by name, each host operation's
    start by its correlation id, and each device event's duration with the
    id of the host operation that launched it."""
    got = getattr(ctx, "program_trace", None)
    if got is not None:
        return got
    import numpy as np
    import torch

    from portbench.trace import _ns

    t0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    ranges, op_id, op_t, dev_id, dev_ns = {}, [], [], [], []
    for e in ctx.tracer.prof.profiler.kineto_results.events():
        link = e.linked_correlation_id()
        if e.device_type() == cuda:
            dev_id.append(link)
            dev_ns.append(_ns(e, "duration"))
        elif link == 0:  # a host operation (a runtime call links to one)
            t = _ns(e, "start")
            op_id.append(e.correlation_id())
            op_t.append(t)
            name = e.name()
            if name.startswith("pt3."):
                ranges.setdefault(name, []).append((t, t + _ns(e, "duration")))
    order = np.argsort(np.asarray(op_id, np.int64), kind="stable")
    got = ctx.program_trace = dict(
        ranges=ranges, op_id=np.asarray(op_id, np.int64)[order],
        op_t=np.asarray(op_t, np.int64)[order], dev_id=np.asarray(dev_id, np.int64),
        dev_ns=np.asarray(dev_ns, np.int64))
    ctx.job.setdefault("info", {})["spans_trace_s"] = time.perf_counter() - t0
    return got


def launched_inside(index: dict, name: str):
    """The summed nanoseconds of the device events whose launching host
    operation began inside one of the ``name`` ranges; None where the
    trace holds no such range."""
    import numpy as np

    rs = sorted(index["ranges"].get(name, ()))
    if not rs:
        return None
    merged = [list(rs[0])]  # the ranges' union, in order
    for a, b in rs[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    lo, hi = np.asarray(merged, np.int64).T
    ids, ts = index["op_id"], index["op_t"]
    if not ids.size or not index["dev_id"].size:
        return 0
    at = np.clip(np.searchsorted(ids, index["dev_id"]), 0, ids.size - 1)
    found = ids[at] == index["dev_id"]
    t = ts[at]
    k = np.searchsorted(lo, t, side="right") - 1
    inside = found & (k >= 0) & (t <= hi[np.clip(k, 0, None)])
    return int(index["dev_ns"][inside].sum())


def kernel_ms(ctx, name: str, root: str):
    """Device milliseconds a unit (a frame or a sample pass) of the work
    launched inside the program's ``name`` spans, over the units whose
    ``root`` spans the device trace holds. None without a device trace,
    a traced unit or such a span."""
    tracer = getattr(ctx, "tracer", None)
    if tracer is None or tracer.window_s is None or not ctx.units:
        return None
    index = _trace_index(ctx)
    roots = len(index["ranges"].get(root, ()))
    ns = launched_inside(index, name)
    ctx.job.setdefault("info", {})["spans_traced_units"] = roots
    if not roots or ns is None:
        return None
    units_per_root = ctx.units / ctx.job["attempted"]
    return ns / 1e6 / (roots * units_per_root)


def per_unit(ctx, tracing, root: str, match, clock: str):
    """``summed`` over the window's units, a frame or a sample pass
    (``ctx.units``)."""
    got = window(ctx, tracing, root)
    if got is None:
        return None
    ms = summed(got[0], match, clock)
    return None if ms is None else ms / ctx.units
