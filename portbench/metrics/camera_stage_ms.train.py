"""Host milliseconds a sample pass of the per-pass step's forward camera
stage: ``models/replay.trace_pass_replay`` synchronised before and after,
minus the device time of K7 (``fused_bounces``) inside it. The step binds
``trace_pass_replay`` when it is built, so the wrapper is installed first."""

from portbench.hooks import Timer


def install(ctx):
    from pt_three_ways_tpu_torch.models import replay

    return (Timer(ctx, replay, "trace_pass_replay", host=True),
            Timer(ctx, replay, "fused_bounces"))


def value(ctx, timers):
    fwd, k7 = (t.ms() for t in timers)
    if fwd is None or not ctx.units:
        return None
    return (fwd - (k7 or 0.0)) / ctx.units
