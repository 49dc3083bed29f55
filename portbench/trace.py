"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CPU
and CUDA activities over the first whole units (frames or steps) of the
window that reach ``TRACE_SECONDS`` (the traced window; its length is the
result's ``window_s``), reduced to the seconds in which some operation
ran on the device (the union of the device events' intervals), the
operations that took most device time, and the longest idle gaps, each
named by the host operation running in its middle (or the one the host
finished last). Tracing a whole window of short frames costs minutes of
post-processing, so the trace stops at a unit boundary; the per-layer
wrappers go on recording to the window's end."""

from __future__ import annotations

import time

import numpy as np
import torch

TRACE_SECONDS = 10.0


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()) * 1000


class DeviceTrace:
    def __init__(self, seconds: float = TRACE_SECONDS):
        from torch.profiler import ProfilerActivity, profile

        self.seconds = seconds
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.window_s = None
        self.running = False
        self.stop_s = None

    def start(self):
        self.prof.__enter__()
        self.running = True
        self.t0 = time.perf_counter()

    def due(self) -> bool:
        return self.running and time.perf_counter() - self.t0 >= self.seconds

    def stop(self):
        if not self.running:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t
        self.running = False

    def reduce(self, top: int = 10) -> dict:
        """{busy_s, window_s, device_ops, idle_gaps}; busy_s None where the
        profiler saw no device operation."""
        cuda = torch.autograd.DeviceType.CUDA
        dev_s, dev_e, dev_n, host_s, host_e, host_n = [], [], [], [], [], []
        for e in self.prof.profiler.kineto_results.events():
            s = _ns(e, "start")
            if e.device_type() == cuda:
                dev_s.append(s)
                dev_e.append(s + _ns(e, "duration"))
                dev_n.append(e.name())
            else:
                host_s.append(s)
                host_e.append(s + _ns(e, "duration"))
                host_n.append(e.name())
        if not dev_s:
            return dict(busy_s=None, window_s=self.window_s, device_ops=[], idle_gaps=[])
        ds, de = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
        order = np.argsort(ds, kind="stable")
        ds, de = ds[order], de[order]
        reach = np.maximum.accumulate(de)  # the furthest end so far
        gap_len = ds[1:] - reach[:-1]
        busy = int(reach[-1] - ds[0] - np.clip(gap_len, 0, None).sum())
        by_name = {}
        for n, d in zip(dev_n, (np.asarray(dev_e) - np.asarray(dev_s)).tolist()):
            by_name[n] = by_name.get(n, 0) + d
        hs, he = np.asarray(host_s, np.int64), np.asarray(host_e, np.int64)
        named = []
        for i in np.argsort(-gap_len)[:top]:
            if gap_len[i] <= 0:
                break
            mid = (reach[i] + ds[i + 1]) // 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if inside.size:
                label = host_n[inside[np.argmin(he[inside] - hs[inside])]]
            else:  # host Python between operations: what the host did last
                done = np.nonzero(he <= mid)[0]
                label = f"host code after {host_n[done[np.argmax(he[done])]]}" if done.size \
                    else "host code"
            named.append([label, int(gap_len[i]) / 1e9])
        window_ns = max(self.window_s * 1e9, float(reach[-1] - ds[0]))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return dict(busy_s=busy / 1e9, window_s=window_ns / 1e9,
                    device_ops=[[n, t / 1e9] for n, t in ops], idle_gaps=named,
                    stop_s=self.stop_s)
