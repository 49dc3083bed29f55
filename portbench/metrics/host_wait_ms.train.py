"""Host milliseconds a sample pass in the training step's copies that wait
for the card (its ``pt3.sync.*`` spans: the pixel inputs, the camera's
aperture check and basis pivots, the ray count's scalar, the material rows'
refresh in ``PackedSceneFused._set_materials``): the host's waits on the
card, summed over the window's steps."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    return spans.per_unit(ctx, tracing, spans.STEP,
                          lambda name: name.startswith("pt3.sync."), "host")
