"""The frames' share of the card's FP32 peak: the operations the frame's
intersection and shading work needs (K2's camera rays and K4's or K5's
live bounces, each testing the whole scene, and a shading event a live
bounce; ``portbench/bounds``) over the frames' summed wall time at 67
TFLOP/s, in percent. It bounds what any kernel's roofline can claim end to end.
Counted only on a scene of one window (a culled search has no exact
count from a launch's inputs); elsewhere the metric reads nothing."""

from portbench import bounds
from portbench.hooks import Timer


def _k2(args, kwargs, out):
    pk, org = args[0], args[1]
    if pk.n_tri and pk.n_windows > 1:
        return None
    live = kwargs.get("live")
    rays = org.shape[1] if live is None else live.sum()
    return rays * bounds.full_scan_ops(pk.n_sph, pk.n_tri)


def _k4(args, kwargs, out):
    pk = args[0]
    if pk.n_tri and pk.n_windows > 1:
        return None
    return out[1].sum() * (bounds.full_scan_ops(pk.n_sph, pk.n_tri) + bounds.OPS_SHADE)


def install(ctx):
    from pt_three_ways_tpu_torch.ops import intersect_kernel, megakernel

    return (Timer(ctx, intersect_kernel, "intersect_packed", on_call=_k2),
            Timer(ctx, megakernel, "fused_passes_krng", on_call=_k4),
            Timer(ctx, megakernel, "fused_passes", on_call=_k4))


def value(ctx, timers):
    ops = [x for t in timers for x in t.extra]
    if not ops or any(x is None for x in ops) or not ctx.unit_s:
        return None
    total = sum(float(x) for x in ops)
    return 100.0 * total / (sum(ctx.unit_s) * bounds.PEAK_FP32_PER_S)
