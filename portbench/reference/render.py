"""The reference's value of sampled pixels of the program's frames.

A frame of ``width x height`` at ``spp`` samples, seeded ``seed``, is the
mean over its samples of the estimator in ``tracer.trace``. Which random
numbers a pixel's sample draws follows from how the program lays out its
work, which this module works out again from the upstream rules and the
device (nothing is read from the program):

* tiles of whole rows: a tile's rows are sized from the device's memory
  (``tile_rows``); sample ``s`` of tile ``t`` draws under the key
  ``fold_in(fold_in(seed_key(seed), s), t)``: the camera's 4 uniforms at
  flat index ``c * r0 + j`` (``r0`` rays a tile, ``j`` the pixel's index in
  it) and the first bounce's 3 x K at ``(c * r0 + j) * K + k``;
* bounces: the in-kernel generator of (lane id ``(y * width + x) * K + k``,
  sample, depth) or, where the run switched to table uniforms after its
  probe, threefry uniforms at ``c * r0 * K + j * K + k`` under
  ``fold_in(fold_in(key, BOUNCE_STREAM_BASE), depth)``;
* the switch: on the card, a render of more than 8 samples traces its
  first 8 as a probe and switches to table uniforms when the scene is
  small (at most 64 triangles and 64 spheres) and closed: its lanes' live
  bounces over the probe exceed 0.7 of 8 x (depth - 1). The reference
  estimates that share from the lanes it traces.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .scene import RefScene
from .tracer import Geometry, trace

PROBE = 8
CLOSED_SHARE = 0.7
SMALL = 64


def budgets(device) -> tuple[int, int]:
    """(paths a launch, bytes of per-sample tables) of the device: on a card
    2^clamp(log2(memory / 8192), 21, 24) paths and a fifth of memory."""
    if torch.device(device).type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return 1 << max(21, min(24, int(math.log2(max(total // 8192, 1))))), total // 5
    return 1 << 21, 4 << 30


def plan(width: int, height: int, spp: int, k: int, device) -> dict:
    """The run's tiling and whether it probes: on the card passes go in
    groups of 8 (a probe when spp > 8, sized for groups of up to 64); on
    the CPU one pass a group."""
    on_card = torch.device(device).type == "cuda"
    probe = on_card and spp > PROBE
    group = 64 if probe else min(8 if on_card else 1, spp)
    paths, table_bytes = budgets(device)
    if group > 1:
        paths = min(paths, max(table_bytes // (40 * (-(-group // 8) * 8)), 1 << 16))
    rows = max(1, min(height, max(paths // k, width) // width))
    return dict(rows=rows, probe=probe)


def _draws(seed, s, tile, j, r0, k, x, y, width, mode_table, dev):
    """The callback of ``trace`` for camera samples with these (frame seed
    words, sample, tile, index in tile) columns."""
    base = seed
    kst = rng.fold_in(rng.fold_in(base, s), tile)
    seeds = rng.channel_seeds(base)
    kk = torch.arange(k, device=dev)
    rep = lambda t: torch.repeat_interleave(t, k)
    lane_id = rep((y * width + x) * k) + kk.repeat(x.shape[0])
    lane_tab = rep(j * k) + kk.repeat(x.shape[0])
    n = rep(r0 * k)
    s_l = rep(s)
    kst_l = tuple(rep(w) for w in kst)
    cseeds = tuple(rep(c) for c in seeds)
    table = rep(mode_table)

    def draw(depth, alive):
        u, v, p = rng.event_uniforms(lane_id, s_l, depth, cseeds)
        bk = rng.fold_in(rng.fold_in(kst_l, rng.BOUNCE_STREAM_BASE), depth)
        tu = rng.uniform_at(bk, lane_tab)
        tv = rng.uniform_at(bk, n + lane_tab)
        tp = rng.uniform_at(bk, 2 * n + lane_tab)
        return (torch.where(table, tu, u), torch.where(table, tv, v), torch.where(table, tp, p))

    return kst, draw


def _camera_uniforms(kst, j, r0, k, dev):
    ck = rng.fold_in(kst, rng.CAMERA_STREAM)
    u4 = torch.stack([rng.uniform_at(ck, c * r0 + j) for c in range(4)], -1)
    fk = rng.fold_in(kst, rng.FIRST_BOUNCE_STREAM)
    kk = torch.arange(k, device=dev)[None]
    fb = torch.stack([rng.uniform_at(tuple(w[:, None] for w in fk),
                                      (c * r0[:, None] + j[:, None]) * k + kk)
                      for c in range(3)], -1)
    return u4, fb


def pixel_means(rs: RefScene, geo: Geometry, width: int, height: int, spp: int,
                max_depth: int, nu: int, nv: int, frames, device, chunk: int = 1 << 16,
                probe_pixels: int = 1024, table_from: int | None = None):
    """Mean radiance [n, 3] (float64 numpy) of the pixels ``frames`` lists:
    (frame seed, xs, ys) triples, in order; and per frame the estimated
    probe share and whether the run switched to table uniforms. The share
    is estimated from the probe samples of ``probe_pixels`` more pixels of
    the frame, drawn from its seed, besides the listed ones. ``table_from``:
    the first sample with table uniforms, where the caller knows it (a run
    asked for table uniforms); by default the probe decides. All frames
    are traced together, in chunks of ``chunk`` lanes."""
    dev = torch.device(device)
    k = nu * nv
    nb = max(max_depth - 1, 0)
    pl = plan(width, height, spp, k, dev)
    rows = pl["rows"]
    small = geo.n_tri <= SMALL and geo.n_sph <= SMALL
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    fr = t(np.concatenate([np.full(len(xs), f) for f, (_, xs, _) in enumerate(frames)]))
    xs = t(np.concatenate([np.asarray(f[1]) for f in frames]))
    ys = t(np.concatenate([np.asarray(f[2]) for f in frames]))
    words = [rng.seed_key(f[0]) for f in frames]
    w0, w1 = t([w[0] for w in words]), t([w[1] for w in words])
    n_check = xs.shape[0]
    acc = torch.zeros((n_check, 3), dtype=torch.float64, device=dev)
    table_after = torch.zeros((len(frames),), dtype=torch.bool, device=dev)
    share = [None] * len(frames)
    phases = [(0, PROBE), (PROBE, spp)] if pl["probe"] else [(0, spp)]
    for lo, hi in phases:
        n_s = min(hi, spp) - lo
        if n_s <= 0:
            continue
        probe = pl["probe"] and lo == 0
        pf, px_, py_ = fr, xs, ys
        if probe:  # more pixels of each frame for the share's estimate
            extra = []
            for f, (seed, _, _) in enumerate(frames):
                g = np.random.default_rng([seed & ((1 << 63) - 1), 0x9B0BE])
                flat = g.choice(width * height, size=min(probe_pixels, width * height),
                                replace=False)
                extra.append((np.full(len(flat), f), flat % width, flat // width))
            pf = torch.cat([fr, t(np.concatenate([e[0] for e in extra]))])
            px_ = torch.cat([xs, t(np.concatenate([e[1] for e in extra]))])
            py_ = torch.cat([ys, t(np.concatenate([e[2] for e in extra]))])
        f_e = pf.repeat_interleave(n_s)
        px = px_.repeat_interleave(n_s)
        py = py_.repeat_interleave(n_s)
        s = torch.arange(lo, lo + n_s, device=dev).repeat(px_.shape[0])
        tile = py // rows
        j = (py - tile * rows) * width + px
        r0_t = torch.full_like(px, rows * width)
        use_table = (table_after[f_e] & (s >= PROBE)) | (
            torch.zeros_like(px, dtype=torch.bool) if table_from is None else s >= table_from)
        rad_all, cnt_all = [], []
        step = max(chunk // k, 1)
        for c in range(0, px.shape[0], step):
            sl = slice(c, c + step)
            base = (w0[f_e[sl]], w1[f_e[sl]])
            kst, draw = _draws(base, s[sl], tile[sl], j[sl], r0_t[sl], k, px[sl], py[sl],
                               width, use_table[sl], dev)
            u4, fb = _camera_uniforms(kst, j[sl], r0_t[sl], k, dev)
            count = torch.ones_like(px[sl], dtype=torch.bool) if probe else None
            with torch.no_grad():
                rad, cnt = trace(geo, geo.mats, rs.camera, px[sl], py[sl], u4,
                                 fb, draw, nb, nu, nv, count_until=count)
            rad_all.append(rad.double())
            if cnt is not None:
                cnt_all.append(cnt.reshape(-1, k).sum(1))
        rad = torch.cat(rad_all).reshape(px_.shape[0], n_s, 3)
        acc += rad[:n_check].sum(1)
        if probe:
            cnt = torch.cat(cnt_all).double().reshape(px_.shape[0], n_s).sum(1)  # a pixel's
            per_frame = torch.zeros(len(frames), dtype=torch.float64, device=dev)
            lanes = torch.zeros_like(per_frame)
            per_frame.index_add_(0, pf, cnt)
            lanes.index_add_(0, pf, torch.full_like(cnt, float(n_s * k)))
            shares = per_frame / lanes / max(nb, 1)
            share = [float(x) for x in shares]
            table_after = (shares > CLOSED_SHARE) & small
    info = [dict(probe_share=share[f], table=bool(table_after[f])) for f in range(len(frames))]
    return (acc / spp).cpu().numpy(), info
