"""Host milliseconds a frame of the render loop's autotune
(``models/render.render_rounds``' ``pt3.render.autotune`` span: the probe's
lane counts read back, ``autotune_decisions`` and the pass functions
rebuilt). A frame of 8 samples or fewer does not autotune: nothing to read."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    return spans.per_unit(ctx, tracing, spans.FRAME, "pt3.render.autotune".__eq__, "host")
