"""The least time the card could take for a kernel's work: a frozen copy of
the bound arithmetic of ``chip_smoke.py`` (the repository's proof script),
so that a later change to that script cannot move the benchmark's rooflines.

A bound is the larger of the bytes the work must move (each input read
once, each output written once) over the HBM bandwidth and the FP32
operations it needs over the FP32 rate, at the published peaks of one
H100 SXM (NVIDIA's data sheet; the card's power limit is printed beside
every run). Operation counts per primitive test and shading event were
counted from the kernels' device code (a divide or a square root is one
operation).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

OPS_SPHERE = 23
OPS_TRIANGLE = 49
OPS_SLAB = 24
OPS_SHADE = 200

# the shading adjoint per lane: a hit recomputes its bounce and walks it
# back; a live miss adds beta * environment
OPS_BWD_HIT = 500
OPS_BWD_MISS = 6
# bytes it must move per lane: a dead lane its alive row and cotangents
# (4 + 52 in, 52 out); a live miss adds t and beta; a hit its whole input
# (state 13, t, idx, uniforms 4, cot_out 13 floats) and cot_in
BWD_BYTES_DEAD = 4 + 52 + 52
BWD_BYTES_MISS = BWD_BYTES_DEAD + 4 + 12
BWD_BYTES_HIT = 4 * (13 + 1 + 1 + 4 + 13) + 52


def bound(bytes_: float, ops: float) -> tuple[float, str]:
    """(milliseconds, "bytes" or "operations")."""
    tb = bytes_ / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def full_scan_ops(n_sph: int, n_tri: int) -> int:
    """A search that tests every primitive (a scene of one window)."""
    return n_sph * OPS_SPHERE + n_tri * OPS_TRIANGLE


def megakernel_one_window(live_bounces: int, n_sph: int, n_tri: int, bytes_: int):
    """K4 or K5 on a scene of one window: each live bounce searches the
    whole scene and shades once."""
    return bound(bytes_, live_bounces * (full_scan_ops(n_sph, n_tri) + OPS_SHADE))


def shading_adjoint(n_hit: int, n_miss: int, n_dead: int, table_bytes: int, out_bytes: int):
    """K8 on one bounce: bytes by lane class, the attribute tables and the
    summed gradients once; operations by hit and live miss."""
    return bound(n_dead * BWD_BYTES_DEAD + n_miss * BWD_BYTES_MISS + n_hit * BWD_BYTES_HIT
                 + table_bytes + out_bytes, n_hit * OPS_BWD_HIT + n_miss * OPS_BWD_MISS)


def culled_walk_counts(ik, mk, box, box1, fan, packed, org, dirn, live, eps):
    """The culled walk of each live ray over two-level boxes (``box`` [W, 8]:
    one a window of 64 rows; ``box1``: one per ``fan`` windows), in window
    order with the ray's running best_t (a window whose entry is at or
    beyond best_t is skipped), from the plain search of the modules ``ik``
    (intersect kernel) and ``mk`` (megakernel). Returns (windows entered
    summed over the rays, windows any lane of a warp entered summed over the
    warps of 32 consecutive rays, live rays). For a culled search's bound."""
    import torch

    r = org.shape[1]
    pad = (-r) % 32
    best_t, _ = ik.sphere_search_plain(packed, org, dirn, live, eps)
    inv = mk._safe_recip(dirn)
    lane_n = torch.zeros((r + pad,), dtype=torch.int64, device=org.device)
    warp_n = torch.zeros((), dtype=torch.int64, device=org.device)
    n_win = box.shape[0]
    for g in range((n_win + fan - 1) // fan):
        en = live & mk.window_enter_plain(box1[g], org, inv, best_t, eps, False)
        if not bool(en.any()):
            continue
        for c in range(g * fan, min(g * fan + fan, n_win)):
            e = en & mk.window_enter_plain(box[c], org, inv, best_t, eps, False)
            sel = e.nonzero()[:, 0]
            if sel.numel() == 0:
                continue
            ep = torch.cat([e, e.new_zeros(pad)])
            lane_n += ep
            warp_n += ep.reshape(-1, 32).any(dim=1).sum()
            first = c * 64
            ct, _ = ik.chunk_min_plain(packed.tri_tab[first:min(first + 64, packed.n_tri)],
                                       first, org[:, sel], dirn[:, sel], eps, False)
            best_t[sel] = torch.minimum(ct, best_t[sel])
    return lane_n.sum().item(), warp_n.item(), int(live.sum().item())


def near_walk_count(ik, mk, packed, org, dirn, live, eps):
    """Windows scanned by the nearest-first culled search, summed over the
    live rays: the level-1 boxes in order; inside an entered one, each ray's
    entered windows nearest entry first, each scanned while its entry is
    still before the ray's best_t."""
    import torch

    best, _ = ik.sphere_search_plain(packed, org, dirn, live, eps)
    best = torch.where(live, best, torch.full_like(best, -float("inf")))
    inv = mk._safe_recip(dirn)
    scanned = torch.zeros((), dtype=torch.int64, device=org.device)
    fan, n_win = packed.fan, packed.n_windows
    for g in range(packed.n_groups):
        eg = live & mk.window_enter_plain(packed.wbox1[g], org, inv, best, eps, False)
        if not bool(eg.any()):
            continue
        sel = eg.nonzero()[:, 0]
        o, d, iv, b = org[:, sel], dirn[:, sel], inv[:, sel], best[sel]
        ws = range(g * fan, min(g * fan + fan, n_win))
        tmin, ct, todo = [], [], []
        for wi in ws:
            box = packed.wbox[wi]
            t0 = (box[0:3, None] - o) * iv
            t1 = (box[3:6, None] - o) * iv
            lo = torch.minimum(t0, t1).amax(dim=0)
            hi = torch.maximum(t0, t1).amin(dim=0)
            tmin.append(lo)
            todo.append((hi >= torch.clamp(lo, min=eps)) & (lo < b))
            first = wi * packed.window
            rows = packed.tri_tab[first:min(first + packed.window, packed.n_tri)]
            ct.append(ik.chunk_min_plain(rows, first, o, d, eps, False)[0])
        tmin, ct, todo = torch.stack(tmin), torch.stack(ct), torch.stack(todo)
        for _ in ws:
            todo &= tmin < b[None, :]
            if not bool(todo.any()):
                break
            near = torch.where(todo, tmin, torch.full_like(tmin, float("inf")))
            pick = near.argmin(dim=0)
            has = todo.any(dim=0)
            scanned += has.sum()
            cols = torch.arange(b.shape[0], device=b.device)
            b = torch.where(has, torch.minimum(b, ct[pick, cols]), b)
            todo[pick, cols] = False
        best[sel] = b
    return scanned.item()
