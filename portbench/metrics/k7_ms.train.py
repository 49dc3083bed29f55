"""Device milliseconds a sample pass of K7, the per-pass step's bounce
kernel (``ops/megakernel.fused_bounces``, bound into ``models/replay``):
CUDA events around each call, summed."""

from portbench.hooks import Timer


def install(ctx):
    from pt_three_ways_tpu_torch.models import replay

    return Timer(ctx, replay, "fused_bounces")


def value(ctx, t):
    ms = t.ms()
    return None if ms is None or not ctx.units else ms / ctx.units
