"""The regenerating inverse-rendering step, in plain PyTorch with autograd.

A step traces every pixel ``S`` times (S sample passes, K first-bounce
lanes a pixel), takes the estimate

    est_p = (sum_s base_s,p + mean over the K lanes of sum_s path_s,p) / S

(``base``: the camera hit's emission, or the environment on a miss;
``path``: what a first-bounce lane gathers over its later bounces), the
mean squared error against the target image, its gradient w.r.t. the
material table (emission, diffuse, ior, reflectivity, cone angle) with
the discrete choices of the forward held fixed and the branch weight
applied (``tracer.trace``), and moves the table by ``-learning_rate`` times
the gradient: path-replay backpropagation (Vicini, Speierer and Jakob,
SIGGRAPH 2021) on the regenerating chain, computed by plain autograd over
the whole path.

The draws are the program's streams, written out from their rules:

* sample ``s`` of a step keyed ``key`` draws its camera and first-bounce
  uniforms from threefry under ``fold_in(fold_in(key, s), 0)`` (tile 0):
  the camera's 4 at flat index ``c * R + j`` (``R`` the step's pixels,
  ``j`` the pixel's index among them), the first bounce's 3 x K at
  ``(c * R + j) * K + k``;
* every later bounce draws the in-kernel generator's ``event_uniforms(lane,
  s, depth, seeds)``, lane ``(y * width + x) * K + k``, with the channel
  seeds of the key (``channel_seeds``: its kernel stream
  ``fold_in(key, KERNEL_RNG_STREAM)``).

Departures from the program, none of which changes the result:

* the program's chain regenerates lanes (a dead lane reloads its next
  sample's first-bounce state), takes lanes from a queue, keeps residual
  slots and walks them in reverse; here each (pixel, sample) is traced on
  its own and autograd differentiates it. The order of work differs, the
  paths and their sums do not;
* the program sums the S passes in one launch and divides once; here the
  per-sample radiance is averaged over the samples;
* the search is the brute-force nearest hit of ``tracer.search`` (the
  program culls by window boxes and finds the same winners).

The pixels go in blocks, one pass a block: a pixel's cotangent
``2 (est_p - target_p) / (3 R)`` depends on that pixel alone, so a block
traces its pixels' S samples under autograd, adds its share of the loss
and backpropagates its own cotangent at once. The material rows a hit
reads (``tracer.hit_info``: ``table[rows]``) are gathered by
``index_select``, whose backward adds each lane's cotangent into its row
(``index_add_``); the indexing's own backward, an accumulating
``index_put_``, sorts the lanes and sums each row's run in one warp, and
took 90 % of a block's time with a few materials and a million lanes a
block on the H100 (the same values; only the order of the float64 sums
differs).
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from . import rng
from .scene import RefScene
from .tracer import Geometry, trace


class _SelectRows(TorchFunctionMode):
    """Inside it, ``table[rows]`` with a 1-D index tensor is
    ``torch.index_select(table, 0, rows)``; every other call, and every
    other tensor's indexing, runs as it is."""

    def __init__(self, table):
        super().__init__()
        self.table = table

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func is torch.Tensor.__getitem__ and args[0] is self.table
                and torch.is_tensor(args[1]) and args[1].dim() == 1
                and args[1].dtype == torch.int64):
            return torch.index_select(args[0], 0, args[1])
        return func(*args, **(kwargs or {}))


def _block_draws(key, s_count: int, j, px, py, r: int, width: int, k: int):
    """Camera uniforms [S*B, 4], first-bounce uniforms [S*B, K, 3] and the
    bounce callback of the S samples of the block's pixels (``j`` their
    indices among the step's ``r`` pixels), rows sample-major."""
    dev = j.device
    b = j.shape[0]
    s = torch.arange(s_count, device=dev).repeat_interleave(b)
    jj = j.repeat(s_count)
    kst = rng.fold_in(rng.fold_in(key, s), 0)
    ck = rng.fold_in(kst, rng.CAMERA_STREAM)
    u4 = torch.stack([rng.uniform_at(ck, c * r + jj) for c in range(4)], -1)
    fk = tuple(w[:, None] for w in rng.fold_in(kst, rng.FIRST_BOUNCE_STREAM))
    kk = torch.arange(k, device=dev)[None]
    fb = torch.stack([rng.uniform_at(fk, (c * r + jj[:, None]) * k + kk) for c in range(3)], -1)
    seeds = rng.channel_seeds(key)
    lane = (((py * width + px)[:, None] * k + kk).reshape(-1)).repeat(s_count)
    s_lane = s.repeat_interleave(k)

    def draw(depth, alive):
        return rng.event_uniforms(lane, s_lane, depth, seeds)

    return u4, fb, draw


def step(rs: RefScene, geo: Geometry, mats, key, px, py, target, s_count: int, nb: int,
         width: int, nu: int = 4, nv: int = 4, block: int = 1 << 14):
    """One step's (loss, gradient [M, 9]) from the table ``mats`` under the
    step's key words; ``block`` pixels a pass."""
    k = nu * nv
    r = px.shape[0]
    dev = px.device
    tgt = target.to(torch.float64)
    n_el = tgt.numel()
    sq, grad = 0.0, torch.zeros_like(mats)
    for lo in range(0, r, block):
        j = torch.arange(lo, min(lo + block, r), device=dev)
        bx, by = px[j], py[j]
        u4, fb, draw = _block_draws(key, s_count, j, bx, by, r, width, k)
        leaf = mats.detach().requires_grad_()
        with torch.enable_grad(), _SelectRows(leaf):
            rad, _ = trace(geo, leaf, rs.camera, bx.repeat(s_count), by.repeat(s_count), u4,
                           fb, draw, nb, nu, nv)
            est = rad.reshape(s_count, j.shape[0], 3).sum(0) / s_count
            d = est.detach().to(torch.float64) - tgt[j]
            sq += float((d * d).sum())
            (g,) = torch.autograd.grad(est, leaf, grad_outputs=(2.0 * d / n_el).to(est.dtype))
        grad += g
    return sq / n_el, grad


def steps(rs: RefScene, geo: Geometry, m0, keys, px, py, target, lr: float, nb: int,
          s_count: int, width: int, nu: int = 4, nv: int = 4, block: int = 1 << 14,
          grad_scale=None):
    """Steps from the table ``m0`` [M, 9] with the given step keys: (losses,
    tables after each step [m0, m1, ...]). ``grad_scale`` [9] scales the
    gradient's columns before the update (a planted fault: an answer
    altered where it is produced)."""
    mats = m0.to(geo.dtype)
    tables, losses = [mats.detach().clone()], []
    for key in keys:
        loss, g = step(rs, geo, mats, key, px, py, target, s_count, nb, width, nu, nv, block)
        losses.append(loss)
        if grad_scale is not None:
            g = g * grad_scale.to(g)
        mats = (mats - lr * g).detach()
        tables.append(mats.clone())
    return losses, tables
