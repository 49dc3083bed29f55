"""Host milliseconds a frame in the program's copies that wait for the
card (its ``pt3.sync.*`` spans: the render loop's drain and autotune reads,
the camera stage's aperture and glossy checks and basis pivots, the pack's
scale and materials, the scene's copy): the host's waits on the card,
summed over the window's frames."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    return spans.per_unit(ctx, tracing, spans.FRAME,
                          lambda name: name.startswith("pt3.sync."), "host")
