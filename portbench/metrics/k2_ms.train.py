"""Device milliseconds a sample pass of K2, the camera-stage intersect of the training step
(``ops/intersect_kernel.intersect_packed``): CUDA events around each call,
summed. ``ops/intersect.intersect_scene`` reaches it through the module."""

from portbench.hooks import Timer


def install(ctx):
    from pt_three_ways_tpu_torch.ops import intersect_kernel

    return Timer(ctx, intersect_kernel, "intersect_packed")


def value(ctx, t):
    ms = t.ms()
    return None if ms is None or not ctx.units else ms / ctx.units
