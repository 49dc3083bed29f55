"""Device milliseconds a sample pass of K4 in replay mode, the regenerating
step's forward (``ops/megakernel.fused_passes_krng(replay=True)``, inside
the program's ``pt3.k4`` spans under ``pt3.train.step`` roots): the
durations of the kernels launched inside those spans, from the device
trace, over the traced steps' passes."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    if tracing is None:
        return None
    return spans.kernel_ms(ctx, "pt3.k4", spans.STEP)
