"""K4's and K5's share of their roofline in the frames: the least time the
card could take for the launches' work (``portbench/bounds``) over their
CUDA-event time, in percent. The work is counted from what each launch
was given and returned: its live bounces (the sum of the per-lane counts
it returns), the scene's primitives, the bytes of its inputs and outputs.
Only a scene of one window has an exact count from these (every bounce
tests the whole scene); on a culled search the metric reads nothing."""

import torch

from portbench import bounds
from portbench.hooks import Timer


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _launch(args, kwargs, out):
    pk, state0, third = args[0], args[1], args[2]
    acc, cnt = out[0], out[1]
    if pk.n_tri and pk.n_windows > 1:
        return None
    size = _nbytes(state0, third, pk.tri_tab, pk.sph_tab, pk.tri_attr, pk.sph_attr, acc, cnt)
    return (cnt.sum(), pk.n_sph, pk.n_tri, size)


def install(ctx):
    from pt_three_ways_tpu_torch.ops import megakernel

    return (Timer(ctx, megakernel, "fused_passes_krng", on_call=_launch),
            Timer(ctx, megakernel, "fused_passes", on_call=_launch))


def value(ctx, timers):
    bound_ms = ms = 0.0
    for t in timers:
        if not t.extra:
            continue
        if any(x is None for x in t.extra):
            return None
        for (live, n_sph, n_tri, size), (a, b) in zip(t.extra, t.events):
            bound_ms += bounds.megakernel_one_window(int(live), n_sph, n_tri, size)[0]
            ms += a.elapsed_time(b)
    return 100.0 * bound_ms / ms if ms > 0 else None
