"""Device milliseconds a frame of the feedback sort (the program's
``pt3.sort`` spans in ``models/integrator.trace_passes_fused``: the
argsort of the lanes' keys, its inverse and the permutations of K4's
inputs before the launch, and of its sums and counts after it): the
durations of the kernels launched inside those spans, from the device
trace, over the traced frames, as ``rng_ms.render`` reads ``pt3.rng``. A
program without the span, or a frame that does not sort, reads nothing."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    if tracing is None:
        return None
    return spans.kernel_ms(ctx, "pt3.sort", spans.FRAME)
