"""Device milliseconds a frame of the threefry uniforms (``ops/rng.uniforms``,
the program's ``pt3.rng`` spans: the camera rays', the first bounce's and,
in table mode, K5's): the durations of the kernels launched inside those
spans, from the device trace, over the traced frames. Kernel time, not the
span's CUDA events, which on a host-bound cell hold the host's enqueueing
of the uniforms' many small kernels."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    if tracing is None:
        return None
    return spans.kernel_ms(ctx, "pt3.rng", spans.FRAME)
