"""Live bounces a second of the render megakernels, in millions: the
program's ``k4.live_bounces`` counter (the per-lane counts K4 and K5
return, summed on the device after each launch's span) over the summed
time between the CUDA events of its ``pt3.k4`` spans
(``ops/megakernel.fused_passes_krng`` and ``fused_passes``), over the
window's frames. It reads on culled searches too, where
``k4_roofline.render`` has no exact count."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    got = spans.window(ctx, tracing, spans.FRAME)
    if got is None:
        return None
    ms = spans.summed(got[0], "pt3.k4".__eq__, "device")
    live = got[1].get("k4.live_bounces")
    if not ms or live is None:
        return None
    return live / ms / 1e3
