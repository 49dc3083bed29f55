"""Wrappers the per-layer metrics put around the program's calls.

A metric module wraps a function at the module attribute through which
the program calls it (``wrap``), and the wrapper records only while the
run's window is open (``ctx.active``). ``Timer`` records a CUDA event
pair around each launch, or with ``host=True`` synchronises before and
after the call and reads the host clock. Every wrapper is undone when the
run closes its context.
"""

from __future__ import annotations

import functools
import time

import torch


def wrap(ctx, module, attr: str, make):
    """Replace ``module.attr`` by ``make(original)`` (which keeps the
    original's attributes, such as launch counters) until ``ctx`` closes."""
    orig = getattr(module, attr)
    new = functools.wraps(orig)(make(orig))
    setattr(module, attr, new)
    ctx.on_close(lambda: setattr(module, attr, orig))
    return orig


class Timer:
    """Summed time of the calls to ``module.attr`` in the window. ``host``:
    the host clock between synchronisations (seconds of the whole call,
    host work included); otherwise CUDA events around the call (the device
    time of the work it enqueued). ``on_call(args, kwargs, result)`` sees
    each windowed call's inputs and outputs."""

    def __init__(self, ctx, module, attr: str, host: bool = False, on_call=None):
        self.ctx, self.host, self.on_call = ctx, host, on_call
        self.calls = 0
        self.host_s = 0.0
        self.events = []
        self.extra = []  # tensors or numbers on_call kept
        sync = ctx.synchronize

        def make(orig):
            def run(*args, **kwargs):
                if not ctx.active:
                    return orig(*args, **kwargs)
                self.calls += 1
                if host:
                    sync()
                    t0 = time.perf_counter()
                    out = orig(*args, **kwargs)
                    sync()
                    self.host_s += time.perf_counter() - t0
                elif ctx.cuda:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = orig(*args, **kwargs)
                    b.record()
                    self.events.append((a, b))
                else:
                    out = orig(*args, **kwargs)
                if on_call is not None:
                    self.extra.append(on_call(args, kwargs, out))
                return out
            return run

        wrap(ctx, module, attr, make)

    def ms(self):
        """Summed milliseconds, or None where nothing was timed."""
        if self.host:
            return self.host_s * 1e3 if self.calls else None
        if not self.events:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)
