"""The inverse-rendering step, in plain PyTorch with autograd.

A step traces every pixel once (one sample pass, K first-bounce lanes a
pixel, every draw from threefry under the step's key, as the program's
per-pass step draws them), takes the mean squared error against the
target image, differentiates it w.r.t. the material table (emission,
diffuse, ior, reflectivity, cone angle) with the discrete choices of the
forward held fixed, and moves the table by ``-learning_rate`` times the
gradient: path-replay backpropagation (Vicini, Speierer and Jakob, SIGGRAPH
2021) computed by plain autograd over the whole path.

The pixels go in blocks: a first pass without gradients gives the image,
the loss and d loss / d radiance; a second pass per block replays the
same winners with gradients and backpropagates that block's cotangent.
"""

from __future__ import annotations

import torch

from . import rng
from .scene import RefScene
from .tracer import Geometry, trace

def _pass(geo, rs, mats, key, px, py, nb, nu, nv, block, grad_cot=None, wins=None):
    """Radiance [R, 3] of one pass under ``key`` (the step's key words);
    with ``grad_cot`` [R, 3] also the table's gradient."""
    k = nu * nv
    r = px.shape[0]
    dev = px.device
    kt = rng.fold_in(rng.fold_in(key, 0), 0)
    ck = rng.fold_in(kt, rng.CAMERA_STREAM)
    fk = rng.fold_in(kt, rng.FIRST_BOUNCE_STREAM)
    bk = rng.fold_in(kt, rng.BOUNCE_STREAM_BASE)
    out, grad = [], torch.zeros_like(mats)
    for b, lo in enumerate(range(0, r, block)):
        j = torch.arange(lo, min(lo + block, r), device=dev)
        u4 = torch.stack([rng.uniform_at(ck, c * r + j) for c in range(4)], -1)
        kk = torch.arange(k, device=dev)[None]
        fb = torch.stack([rng.uniform_at(fk, (c * r + j[:, None]) * k + kk) for c in range(3)], -1)
        lane = (j[:, None] * k + kk).reshape(-1)

        def draw(depth, alive):
            dk = rng.fold_in(bk, depth)
            return tuple(rng.uniform_at(dk, c * r * k + lane) for c in (0, 1, 2))

        w = wins[b] if wins is not None and len(wins) > b else []
        if wins is not None and len(wins) <= b:
            wins.append(w)
        if grad_cot is None:
            with torch.no_grad():
                rad, _ = trace(geo, mats, rs.camera, px[j], py[j], u4, fb, draw, nb, nu, nv,
                               winners=w)
            out.append(rad)
        else:
            leaf = mats.detach().requires_grad_()
            with torch.enable_grad():
                rad, _ = trace(geo, leaf, rs.camera, px[j], py[j], u4, fb, draw, nb, nu, nv,
                               winners=w)
                (g,) = torch.autograd.grad(rad, leaf, grad_outputs=grad_cot[j].to(rad.dtype))
            grad += g
    return (torch.cat(out) if out else None), grad


def steps(rs: RefScene, geo: Geometry, m0, keys, px, py, target, lr: float, nb: int,
          nu: int = 4, nv: int = 4, block: int = 1 << 16, grad_scale=None):
    """Steps from the table ``m0`` [M, 9] with the given step keys: (losses,
    tables after each step [m0, m1, ...], the first gradient).
    ``grad_scale`` [9] scales the gradient's columns before the update (a
    planted fault: an answer altered where it is produced)."""
    mats = m0.to(geo.dtype)
    tables, losses, first = [mats.detach().clone()], [], None
    for key in keys:
        wins = []
        rad, _ = _pass(geo, rs, mats, key, px, py, nb, nu, nv, block, wins=wins)
        d = rad.to(torch.float64) - target.to(torch.float64)
        losses.append(float((d * d).mean()))
        cot = 2.0 * d / d.numel()
        _, g = _pass(geo, rs, mats, key, px, py, nb, nu, nv, block, grad_cot=cot, wins=wins)
        if grad_scale is not None:
            g = g * grad_scale.to(g)
        if first is None:
            first = g.detach().clone()
        mats = (mats - lr * g).detach()
        tables.append(mats.clone())
    return losses, tables, first
