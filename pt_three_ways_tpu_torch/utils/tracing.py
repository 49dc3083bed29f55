"""Spans and counters at the program's layer boundaries.

Recording is off by default. Then ``span`` returns one shared null context
and ``count`` returns at once, so an instrumented call costs a flag check.
After ``enable()``, a span does three things:

  * it opens a profiler range named after it, so the span lands in any
    running ``torch.profiler`` trace on the clock of the device's kernels;
  * it appends a record: its name, its parent (the innermost span open
    when it began), its root (the outermost one: the frame or the training
    step it belongs to) and its host start and end
    (``time.perf_counter_ns``);
  * if ``device`` is a CUDA device, it records a CUDA event on that
    device's current stream at entry and at exit. It never synchronises.

``count(name, value)`` adds ``value`` to a counter of the current root. A
tensor's elements are summed on its device, so the sum stays on the
device. ``snapshot()`` synchronises once and reads everything back. The
module writes no file: ``torch.profiler`` carries the spans into its trace
(``cli.py --trace-out``).

The span stack is one for the process, not one per thread. CUDA autograd
runs a backward in a worker thread while the calling thread waits inside
``torch.autograd.grad``, so spans opened there nest under the caller's.

Names, from the entry point down (``pt3.`` first):

  render, render.pack, render.launch, render.autotune, render.drain
      (``models/render.render_rounds``); train.step, train.forward,
      train.backward, train.update (``parallel/train``); scene.build;
  camera (the camera stage), camera.rays, rng (threefry uniforms);
  k2, k4 (K4 and K5), k7, k8, k9, k10, k12, k13: the kernels' public
      wrappers (k12 inside the backward of a gather that differentiates
      the table; k13 around K13a, inside camera.rays, and K13b, the camera
      stage of a render on the card);
  sort: the feedback sort's permutations of K4's lanes, before and after
      its launch (``models/integrator.trace_passes_fused``);
  sync.<site>: a copy between the card and the host that waits for the
      card, the host's wait: a read back (drain, autotune, glossy,
      aperture, pack, materials) or a copy from pageable host memory,
      which PyTorch ends with a stream synchronisation (onb, nrays,
      inputs, scene); aperture and onb open only in the eager camera
      stage, never in K13's.

Counters: ``k4.live_bounces``, the live bounces of the render's K4 and K5
launches (``models/integrator.trace_passes_fused``, after each launch's
span); ``k4.replay_slots``, the residual slots K4 wrote in replay mode, one
a live bounce (``models/replay._regen_launch``, after its launch's span);
``rng.kernel_draws``, the uniforms K11 drew (``ops/rng
.uniform_kernel``, inside ``pt3.rng``); ``k13.stages``, the camera stages
that ran as K13 (``models/integrator._first_bounce_state``; an eager stage
counts nothing).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

_ON = False
_NULL = contextlib.nullcontext()
# a span's record: [name, parent, root, host start ns, host end ns, event
# at entry, event at exit]
_spans: list = []
_open: list = []  # indices of the open spans, innermost last
_counters: dict = {}  # (root, name) -> number or 0-d tensor


def enabled() -> bool:
    return _ON


def enable():
    global _ON
    _ON = True


def disable():
    global _ON
    _ON = False


def reset():
    """Forgets every record and counter (call it with no span open)."""
    _spans.clear()
    _open.clear()
    _counters.clear()


class _Span:
    __slots__ = ("name", "device", "index", "range")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        # a host operation in the profiler's trace. ``record_function``
        # would open a user annotation, for which Kineto adds a device-side
        # event spanning the annotation's kernels: a trace reader would
        # count it as device work
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        parent = _open[-1] if _open else None
        self.index = len(_spans)
        root = self.index if parent is None else _spans[parent][2]
        ev = None
        if self.device is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
        _spans.append([self.name, parent, root, time.perf_counter_ns(), None, ev, None])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = _spans[self.index]
        if self.device is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            rec[6] = ev
        rec[4] = time.perf_counter_ns()
        _open.pop()
        self.range.__exit__(*exc)
        return False


def _cuda(device):
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def span(name: str, device=None):
    """A context manager that records ``name`` while tracing is on, timed
    on the device too where ``device`` (a ``torch.device`` or its name) is
    a CUDA device; the shared null context while it is off."""
    if not _ON:
        return _NULL
    return _Span(name, _cuda(device))


def _first_cuda(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


def spanned(name: str, device: bool = False):
    """Decorator: each call in ``span(name)``; ``device=True`` times it on
    the device of its first CUDA tensor argument, if it has one."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name, _first_cuda(args, kwargs) if device else None):
                return fn(*args, **kwargs)

        return run

    return wrap


def count(name: str, value):
    """Adds ``value`` (a number, or a tensor whose elements are summed on
    its device) to the counter ``name`` of the current root."""
    if not _ON:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum(dtype=torch.float64)
    key = (_spans[_open[-1]][2] if _open else None, name)
    prev = _counters.get(key)
    _counters[key] = value if prev is None else prev + value


def snapshot() -> dict:
    """Every span and counter so far, after one synchronisation:

    ``spans``: a dict a span, in the order they began: ``id``, ``name``,
    ``parent`` and ``root`` (ids; a root's parent is None), ``host_ms``
    and ``host_self_ms`` (its time less what its children cover; None while
    open), ``device_ms`` and ``device_self_ms`` (between its CUDA events;
    None without them). A span's device time runs from its first to its
    last work on the device, gaps in which the device waited for the host
    included.

    ``counters``: {name: total}; ``unit_counters``: {root id: {name:
    value}} (counts made outside any span under the root None)."""
    if any(rec[5] is not None for rec in _spans) or any(
            isinstance(v, torch.Tensor) and v.is_cuda for v in _counters.values()):
        torch.cuda.synchronize()
    spans = []
    for i, (name, parent, root, t0, t1, e0, e1) in enumerate(_spans):
        host = None if t1 is None else (t1 - t0) / 1e6
        dev = None if e1 is None else e0.elapsed_time(e1)
        spans.append(dict(id=i, name=name, parent=parent, root=root, host_ms=host,
                          host_self_ms=host, device_ms=dev, device_self_ms=dev))
    for s in spans:
        if s["parent"] is None:
            continue
        p = spans[s["parent"]]
        for k in ("host", "device"):
            if s[k + "_ms"] is not None and p[k + "_self_ms"] is not None:
                p[k + "_self_ms"] -= s[k + "_ms"]
    counters, unit_counters = {}, {}
    for (root, name), v in _counters.items():
        v = float(v)
        counters[name] = counters.get(name, 0.0) + v
        unit_counters.setdefault(root, {})[name] = v
    return dict(spans=spans, counters=counters, unit_counters=unit_counters)
