"""Device milliseconds a sample pass of the threefry uniforms of the
training step's camera stage (``ops/rng.uniforms``, the program's
``pt3.rng`` spans: the camera rays', the first bounce's and K7's bounce
rows): the durations of the kernels launched inside those spans, from the
device trace, over the traced steps."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    if tracing is None:
        return None
    return spans.kernel_ms(ctx, "pt3.rng", spans.STEP)
