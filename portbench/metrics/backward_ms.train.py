"""Host milliseconds a sample pass of the step's backward
(``parallel/train._grads``: autograd of the camera stage, K2's VJP and K8
inside the replay chain), synchronised before and after each call."""

from portbench.hooks import Timer


def install(ctx):
    from pt_three_ways_tpu_torch.parallel import train

    return Timer(ctx, train, "_grads", host=True)


def value(ctx, t):
    ms = t.ms()
    return None if ms is None or not ctx.units else ms / ctx.units
