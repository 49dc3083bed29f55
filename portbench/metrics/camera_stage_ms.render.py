"""Host milliseconds a frame of the camera stage
(``models/integrator._first_bounce_state``: threefry uniforms, camera rays,
K2, winner shading, the K-fold first bounce), synchronised before and after
each call. The render's ``trace_passes_fused`` calls it through the
integrator module's globals."""

from portbench.hooks import Timer


def install(ctx):
    from pt_three_ways_tpu_torch.models import integrator

    return Timer(ctx, integrator, "_first_bounce_state", host=True)


def value(ctx, t):
    ms = t.ms()
    return None if ms is None or not ctx.units else ms / ctx.units
