"""Device milliseconds a sample pass of the regenerating step's forward
camera stages (``models/integrator.regen_front``'s S eager stages a step,
the program's ``pt3.camera`` spans under ``pt3.train.step`` roots): the
durations of the kernels launched inside those spans, from the device
trace, over the traced steps' passes. Their backward runs outside the
spans."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    if tracing is None:
        return None
    return spans.kernel_ms(ctx, "pt3.camera", spans.STEP)
