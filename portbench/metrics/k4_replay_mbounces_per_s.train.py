"""Live bounces a second of K4 in replay mode, in millions: the program's
``k4.replay_slots`` counter (the residual slots K4 wrote, one a live
bounce, summed on the device after each launch) a sample pass of the
window, over ``k4_replay_ms.train``'s device time a pass (the kernels
launched inside ``pt3.k4`` under the traced steps). None where the program
counts no replay slots."""

from portbench import spans


def install(ctx):
    return spans.install(ctx)


def value(ctx, tracing):
    got = spans.window(ctx, tracing, spans.STEP)
    if got is None:
        return None
    slots = got[1].get("k4.replay_slots")
    ms = spans.kernel_ms(ctx, "pt3.k4", spans.STEP)
    if slots is None or not ms:
        return None
    return slots / ctx.units / ms / 1e3
