"""K8's share of its roofline in the training window: the least time for
each launch's work (``portbench/bounds.shading_adjoint``: bytes by lane
class, counted from the launch's own inputs, the alive row and winner t
of its saved state) over its CUDA-event time, in percent. K8
(``ops/megakernel.bounce_bwd_step``) runs once a bounce in the backward
of the per-pass step; ``models/replay`` binds it by name."""

import torch

from portbench import bounds
from portbench.hooks import Timer


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _launch(args, kwargs, out):
    pk, state, t = args[0], args[1], args[2]
    alive = state[9] != 0
    hit = alive & torch.isfinite(t) & (t > 0)
    counts = torch.stack([hit.sum(), alive.sum(), torch.tensor(state.shape[1], device=t.device)])
    return counts, _nbytes(pk.tri_attr, pk.sph_attr), _nbytes(*out[1:])


def install(ctx):
    from pt_three_ways_tpu_torch.models import replay

    return Timer(ctx, replay, "bounce_bwd_step", on_call=_launch)


def value(ctx, t):
    if not t.events:
        return None
    bound_ms = ms = 0.0
    for (counts, tables, outs), (a, b) in zip(t.extra, t.events):
        n_hit, n_alive, n = (int(x) for x in counts.tolist())
        bound_ms += bounds.shading_adjoint(n_hit, n_alive - n_hit, n - n_alive, tables, outs)[0]
        ms += a.elapsed_time(b)
    return 100.0 * bound_ms / ms if ms > 0 else None
