"""Device milliseconds a sample pass of K9, the regenerating step's reverse
walk and its column reduce (``ops/megakernel.regen_replay_bwd``, the
program's ``pt3.k9`` spans, inside the step's backward): the durations of
the kernels launched inside those spans, from the device trace, over the
traced steps' passes."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    if tracing is None:
        return None
    return spans.kernel_ms(ctx, "pt3.k9", spans.STEP)
