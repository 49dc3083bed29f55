"""Device milliseconds a frame of the render megakernels: K4
(``ops/megakernel.fused_passes_krng``, in-kernel uniforms) and K5
(``fused_passes``, table uniforms), whichever the frame launches; CUDA
events around each call (a tail-compacted K4 call's continuations
included), summed."""

from portbench.hooks import Timer


def install(ctx):
    from pt_three_ways_tpu_torch.ops import megakernel

    return (Timer(ctx, megakernel, "fused_passes_krng"), Timer(ctx, megakernel, "fused_passes"))


def value(ctx, timers):
    ms = [t.ms() for t in timers]
    if all(m is None for m in ms) or not ctx.units:
        return None
    return sum(m or 0.0 for m in ms) / ctx.units
