"""Share of the traced window in which no operation ran on the device
(``torch.profiler``, CPU and CUDA activities: kernels, copies and sets,
the camera stage's eager PyTorch kernels included), for the training cells."""


def install(ctx):
    return None


def value(ctx, state):
    tr = ctx.trace_result
    if not tr or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
