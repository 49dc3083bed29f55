"""Kernel K2: nearest sphere+triangle hit per ray (the camera-stage kernel).

Replaces the JAX package's Pallas kernel ``ops/pallas_intersect.py``
(``_intersect_kernel`` / ``_run``, body ``intersect_tile``, entry
``intersect_packed``). CUDA source: ``csrc/intersect.cu``, sharing the
winner search with the megakernels in ``csrc/pt3_device.cuh``.

What it computes, per ray: spheres first (they seed ``best_t``), then the
Woop triangles in Morton-ordered chunks of ``tc = min(t_pad, 64)`` rows; the
lowest row wins a tie inside a chunk and a later chunk must be strictly
nearer, so spheres win exact ties (the reference's nearerThan rule,
src/dod/Scene.cpp:115-122). Dead lanes report a miss. Output: ``t`` (+inf
on miss) and the packed index (triangles in [0, T), spheres in [T, T+S)).

Design on the H100: one thread per ray, with one of two searches that the
launch picks from the scene, as K4 picks its resident design. A scene of at
most one 64-row chunk whose tables fit 48 KB (cornell) is staged in shared
memory once per block and scanned per thread as warp-uniform broadcasts.
Every other scene takes a culled warp search with the unpacked winner:
each lane walks its ray's window boxes (``PackedScene.wbox`` / ``wbox1``:
64-row windows widened by ``WBOX_MARGIN`` of the scene's scale, fan-16
level-1 boxes, built once with the pack), inside a level-1 box nearest
entry first; a window most of a warp's rays pick at once is scanned by each
of them for its own ray, and the warp spreads every other (ray, window)
pair's 64 tests over its 32 lanes (camera rays are coherent). Both designs
are exact: the winners are the unculled scan's bit for bit (the lowest
index at the least t). Bound: FP32 operations of the
tests; a ray reads 25 B and writes 8 B. The reciprocal keeps the ``rcp * (2
- den * rcp)`` refinement of the TPU kernel after an IEEE divide.

The plain PyTorch version (``intersect_plain``) repeats the arithmetic on
whole [*, R] tensors; the wrapper takes it only for CPU tensors.

Gradient: when a ray requires one, ``intersect_packed`` goes through a
``torch.autograd.Function`` whose backward is the implicit-function-theorem
ray derivative of ``t`` (``intersect_vjp``), as the JAX kernel's custom VJP
(``_kernel_tx_bwd``). That backward is elementwise gather work, plain
PyTorch on both sides (XLA in the JAX package, not Pallas).
"""

from __future__ import annotations

import torch

from ..utils import tracing
from . import _cuda
from .vecmath import fsqrt
from .xla_cpu import fma

TC = 64  # triangles per chunk (the winner search's tie unit)
SC = 64  # spheres per chunk
# the culling windows of K2, K4 and K7: triangles per window (one chunk)
# and windows per level-1 box (the window x fan sweep of chip_smoke.py
# phase 8 on the H100, PERF.md)
WINDOW = TC
WINDOW_FAN = 16
# The window boxes are widened by this fraction of the scene's scale (1 +
# the largest coordinate of a vertex or a sphere's extent): 2^9 float32
# ulps of that scale, far above the rounding of the slab and triangle tests
WBOX_MARGIN = 2.0 ** -15

_PARALLEL_EPS = 1e-12
_INF = float("inf")


def _pad_rows(a: torch.Tensor, mult: int) -> torch.Tensor:
    n = a.shape[0]
    pad = (-n) % mult if n else mult
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))], dim=0)
    return a


class PackedScene:
    """Primitive tables of the winner search, on the scene's device.

    ``tri_tab`` [Tpad, 12] Woop rows and ``sph_tab`` [Spad, 8] (centre3,
    r^2, |c|^2, pad3): the same tables, row for row, as the JAX package's
    ``PackedScene``. The culling hierarchy of the card's searches (K2, and
    K4 and K7 on a ``PackedSceneStream``): the Morton-ordered rows cut into
    ``n_windows`` windows of ``window`` triangles (a multiple of 64, so
    window chunks start where the scan's do), one box per window, ``wbox``
    [n_windows, 8] = lo3 hi3 pad2: the min/max of its vertices (the last
    window padded with the last vertex) widened by ``wbox_margin`` on every
    side, and one level-1 box per ``fan`` consecutive windows, ``wbox1``
    [n_groups, 8]: the min/max of its windows' widened boxes. Built once
    with the pack: a caller that holds a pack passes it down (the render,
    the training chains), so no launch rebuilds them.

    The margin keeps the window skip exact under rounding: the point at a
    hit's computed t lies within a few float32 ulps of the scene's scale
    of its triangle, and the slab test's entry and exit times are off by as
    little along each axis, so a box widened by ``WBOX_MARGIN`` of that
    scale (hundreds of ulps) is entered before, and left after, every hit a
    ray can take in it, one on a face or an edge shared with another window
    included. A level-1 box contains its windows' boxes, and the slab test
    rounds monotonically in the box's faces, so a ray that enters a window
    box enters its level-1 box too: skipping a group is as exact as
    skipping each of its windows."""

    def __init__(self, scene, window: int = WINDOW, fan: int = WINDOW_FAN):
        if window <= 0 or window % TC or window > 1024:
            raise ValueError(f"window must be a multiple of {TC} in [64, 1024], got {window}")
        if not 1 <= fan <= 32:
            raise ValueError(f"fan must be in [1, 32], got {fan}")
        tri = scene.triangles
        sph = scene.spheres
        dev = scene.device
        f32 = torch.float32
        self.n_tri = int(tri.woop.shape[0])
        self.n_sph = int(sph.centre.shape[0])
        tri_tab = tri.woop.reshape(self.n_tri, 12).to(f32)
        t_mult = TC if self.n_tri > TC else 8
        self.tri_tab = _pad_rows(tri_tab, t_mult).contiguous()
        self._set_windows(scene, window, fan)

        if self.n_sph:
            sph_tab = torch.cat(
                [
                    sph.centre.to(f32),
                    sph.radius_sq.to(f32)[:, None],
                    sph.centre_sq.to(f32)[:, None],
                    torch.zeros((self.n_sph, 3), dtype=f32, device=dev),
                ],
                dim=1,
            )
        else:
            sph_tab = torch.zeros((0, 8), dtype=f32, device=dev)
        # padding rows: centre 0, r^2 = 0, |c|^2 = +inf -> det < 0 always
        s_mult = SC if self.n_sph > SC else 8
        pad = (-self.n_sph) % s_mult
        if self.n_sph == 0:
            pad = s_mult
        if pad:
            bad = torch.zeros((pad, 8), dtype=f32, device=dev)
            bad[:, 4] = _INF
            sph_tab = torch.cat([sph_tab, bad], dim=0)
        self.sph_tab = sph_tab.contiguous()

    def _set_windows(self, scene, window: int, fan: int):
        dev = scene.device
        f32 = torch.float32
        self.window = int(window)
        self.fan = int(fan)
        n_win = max(-(-self.n_tri // window), 1)
        self.n_windows = n_win
        self.n_groups = -(-n_win // fan)
        if self.n_tri:
            verts = scene.triangles.verts.detach().to(f32)
            pad = n_win * window - self.n_tri
            if pad:
                verts = torch.cat([verts, verts[-1:, -1:, :].expand(pad, 3, 3)], dim=0)
            v = verts.reshape(n_win, window * 3, 3)
            sph = scene.spheres
            reach = sph.centre.detach().abs() + sph.radius_sq.detach().sqrt()[:, None]
            with tracing.span("pt3.sync.pack"):
                scale = max(float(verts.abs().max()),
                            float(reach.max()) if reach.numel() else 0.0)
            self.wbox_margin = WBOX_MARGIN * (1.0 + scale)
            lo = v.min(dim=1).values - self.wbox_margin
            hi = v.max(dim=1).values + self.wbox_margin
        else:
            self.wbox_margin = 0.0
            lo = torch.full((1, 3), _INF, dtype=f32, device=dev)
            hi = torch.full((1, 3), -_INF, dtype=f32, device=dev)
        zeros2 = lambda k: torch.zeros((k, 2), dtype=f32, device=dev)
        self.wbox = torch.cat([lo, hi, zeros2(n_win)], dim=1).contiguous()
        pad1 = self.n_groups * fan - n_win
        lo_p = torch.cat([lo, lo[-1:].expand(pad1, 3)])
        hi_p = torch.cat([hi, hi[-1:].expand(pad1, 3)])
        self.wbox1 = torch.cat([lo_p.reshape(self.n_groups, fan, 3).min(dim=1).values,
                                hi_p.reshape(self.n_groups, fan, 3).max(dim=1).values,
                                zeros2(self.n_groups)], dim=1).contiguous()

    @property
    def t_pad(self) -> int:
        return int(self.tri_tab.shape[0])

    @property
    def chunk_rows(self) -> int:
        """Rows per triangle chunk: ``min(t_pad, TC)``."""
        return min(self.t_pad, TC)


def _first_min_rows(t: torch.Tensor):
    """(min over axis 0, lowest row attaining it) for a [rows, R] block."""
    best = torch.min(t, dim=0).values
    rows = torch.arange(t.shape[0], device=t.device, dtype=torch.int32)[:, None]
    idx = torch.min(torch.where(t <= best[None, :], rows,
                                torch.full_like(rows, 2**30)), dim=0).values
    return best, idx


def sphere_search_plain(packed: PackedScene, org, dirn, live, eps: float):
    """The sphere part of the winner search (``pt3_device.cuh:
    sphere_search``): (best_t [R], +inf on a live miss and -inf on a dead
    lane; best_i [R], spheres' packed indices T + s)."""
    ox, oy, oz = org[0], org[1], org[2]
    dx, dy, dz = dirn[0], dirn[1], dirn[2]
    best_t = torch.where(live, torch.full_like(ox, _INF), torch.full_like(ox, -_INF))
    best_i = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    n_sph = packed.n_sph
    if n_sph > 0:
        sp = packed.sph_tab[:n_sph]
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        cx, cy, cz = sp[:, 0:1], sp[:, 1:2], sp[:, 2:3]
        b = cx * dx + cy * dy + cz * dz - od
        det = b * b - sp[:, 4:5] + 2.0 * (cx * ox + cy * oy + cz * oz) - oo + sp[:, 3:4]
        ok = det >= 0.0
        sq = fsqrt(torch.where(ok, det, torch.zeros_like(det)))
        minus_t = b - sq
        plus_t = b + sq
        t = torch.where(minus_t > eps, minus_t, plus_t)
        valid = ok & (t > eps)
        t = torch.where(valid, t, torch.full_like(t, _INF))
        ct, ci = _first_min_rows(t)
        take = ct < best_t
        best_i = torch.where(take, ci + packed.n_tri, best_i)
        best_t = torch.where(take, ct, best_t)
    return best_t, best_i


def chunk_min_plain(w, first: int, org, dirn, eps: float, packed_winner: bool):
    """One chunk of Woop rows ``w`` [rows <= 64, 12] against every ray
    (``pt3_device.cuh: triangle_chunk``): (the chunk's nearest t [R], +inf on no
    hit; its packed index ``first + row`` [R]); the lowest row wins a tie.
    ``packed_winner`` folds the row into the low 6 bits of t's bit pattern
    (one minimum; t rounds down by up to 63 ulp)."""
    ox, oy, oz = org[0], org[1], org[2]
    dx, dy, dz = dirn[0], dirn[1], dirn[2]
    col = lambda k: w[:, k:k + 1]
    o_u = col(0) * ox + col(1) * oy + col(2) * oz + col(3)
    o_v = col(4) * ox + col(5) * oy + col(6) * oz + col(7)
    o_w = col(8) * ox + col(9) * oy + col(10) * oz + col(11)
    d_u = col(0) * dx + col(1) * dy + col(2) * dz
    d_v = col(4) * dx + col(5) * dy + col(6) * dz
    d_w = col(8) * dx + col(9) * dy + col(10) * dz
    not_par = torch.abs(d_w) > _PARALLEL_EPS
    den = torch.where(not_par, d_w, torch.ones_like(d_w))
    rcp = 1.0 / den
    rcp = rcp * (2.0 - den * rcp)
    t = -o_w * rcp
    u = o_u + t * d_u
    v = o_v + t * d_v
    valid = not_par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    t = torch.where(valid, t, torch.full_like(t, _INF))
    if packed_winner:
        rows = torch.arange(t.shape[0], device=t.device, dtype=torch.int32)[:, None]
        cp = torch.min((t.view(torch.int32) & ~63) | rows, dim=0).values
        return (cp & ~63).view(torch.float32), ((cp & 63) + first).to(torch.int32)
    ct, ci = _first_min_rows(t)
    return ct, (ci + first).to(torch.int32)


def winner_search_plain(packed: PackedScene, org, dirn, live, eps: float,
                        packed_winner: bool = False):
    """The shared winner search (``pt3_device.cuh: winner_search``) on whole
    [3, R] tensors: spheres, then the triangles in chunks of ``tc =
    min(t_pad, 64)`` rows, a later chunk taking over only when strictly
    nearer. Returns (best_t [R] with -inf on dead lanes, best_i [R]).

    ``packed_winner`` (the in-kernel-RNG megakernel only): each chunk folds
    the row into the low 6 bits of ``t``'s bit pattern so one minimum finds
    (t, row); it lowers the winner ``t`` by up to 63 ulp."""
    best_t, best_i = sphere_search_plain(packed, org, dirn, live, eps)
    n_tri, tc = packed.n_tri, packed.chunk_rows
    for c0 in range(0, n_tri, tc):
        ct, ci = chunk_min_plain(packed.tri_tab[c0:min(c0 + tc, n_tri)], c0, org, dirn, eps,
                                 packed_winner)
        take = ct < best_t
        best_i = torch.where(take, ci, best_i)
        best_t = torch.where(take, ct, best_t)
    return best_t, best_i


def intersect_plain(packed: PackedScene, org, dirn, live, eps: float):
    """Plain version of K2: (t [R] with +inf on miss or dead, idx [R])."""
    best_t, best_i = winner_search_plain(packed, org, dirn, live, eps)
    return torch.where(live, best_t, torch.full_like(best_t, _INF)), best_i


def _intersect_cuda(packed: PackedScene, org, dirn, live, eps: float):
    n = org.shape[1]
    dev = org.device
    if org.dtype != torch.float32 or dirn.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 rays, got {org.dtype} / {dirn.dtype} "
                        "(float64 runs on the CPU only)")
    org = org.contiguous()
    dirn = dirn.contiguous()
    live = live.contiguous()  # bool: one byte a ray
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    idx_out = torch.empty((n,), dtype=torch.int32, device=dev)
    err = _cuda.lib().pt3_intersect(
        packed.tri_tab.data_ptr(), packed.sph_tab.data_ptr(), packed.n_tri, packed.n_sph,
        packed.t_pad, packed.wbox.data_ptr(), packed.wbox1.data_ptr(), packed.n_windows,
        packed.n_groups, packed.window, packed.fan, org.data_ptr(), dirn.data_ptr(),
        live.data_ptr(), t_out.data_ptr(), idx_out.data_ptr(), n, float(eps),
        _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pt3_intersect")
    intersect_packed.launches += 1
    return t_out, idx_out


def _check_inputs(packed: PackedScene, org, dirn, live):
    if org.dim() != 2 or org.shape[0] != 3 or dirn.shape != org.shape:
        raise ValueError(f"intersect_packed: org/dirn must be [3, R], got "
                         f"{tuple(org.shape)} / {tuple(dirn.shape)}")
    if live.shape != (org.shape[1],):
        raise ValueError("intersect_packed: live must be [R]")
    devs = {org.device, dirn.device, live.device, packed.tri_tab.device}
    if len(devs) != 1:
        raise ValueError(f"intersect_packed: tensors on several devices {devs}")


def intersect_vjp(packed: PackedScene, org, dirn, t, idx, t_bar):
    """The ray derivative of the winner distance (the JAX package's
    ``pallas_intersect._kernel_tx_bwd``), by the implicit function theorem:
    dt/d_org = -g / (g.d) and dt/d_dir = -t g / (g.d), g the winner's
    unnormalised geometric normal (the Woop w-row of a triangle, x - c of a
    sphere); |g.d| <= 1e-20 and misses give 0. Returns (d_org, d_dir)."""
    n_tri, n_sph = packed.n_tri, packed.n_sph
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    tri_win = (idx < n_tri) & hit
    izero = torch.zeros_like(idx)
    i_t = torch.where(tri_win, idx, izero).long()
    i_s = torch.where(tri_win | ~hit, izero, idx - n_tri).long()
    g_tri = packed.tri_tab[i_t, 8:11].T if n_tri else torch.zeros_like(org)
    g_sph = (fma(t_safe, dirn, org) - packed.sph_tab[i_s, 0:3].T) if n_sph \
        else torch.zeros_like(org)
    return winner_t_vjp(torch.where(tri_win, g_tri, g_sph), dirn, t, t_bar)


def winner_t_vjp(g, dirn, t, t_bar):
    """(d_org, d_dir) of a winner distance ``t`` [R] (+inf on a miss) with
    cotangent ``t_bar``, given the winner's unnormalised geometric normal
    ``g`` [3, R]: -g / (g.d) and -t g / (g.d), 0 where |g.d| <= 1e-20 or
    the ray missed."""
    hit = torch.isfinite(t)
    zero = torch.zeros_like(t)
    t_safe = torch.where(hit, t, zero)
    gd = g[0] * dirn[0] + g[1] * dirn[1] + g[2] * dirn[2]
    inv = torch.where(gd.abs() > 1e-20, 1.0 / torch.where(gd == 0, torch.ones_like(gd), gd),
                      zero)
    scale = torch.where(hit, -torch.where(hit, t_bar, zero) * inv, zero)
    return g * scale, g * (scale * t_safe)


def _intersect(packed, org, dirn, live, eps):
    if org.device.type == "cuda":
        return _intersect_cuda(packed, org, dirn, live, eps)
    if org.device.type != "cpu":
        raise ValueError(f"intersect_packed: unsupported device {org.device}")
    return intersect_plain(packed, org.float(), dirn.float(), live, eps)


class _Intersect(torch.autograd.Function):
    """K2 (or its plain version) as the forward; the analytic ray
    derivative of ``t`` as the backward. The tables, ``live`` and the
    winner index get no cotangent: geometry and liveness are constants."""

    @staticmethod
    def forward(ctx, org, dirn, live, packed, eps):
        t, idx = _intersect(packed, org, dirn, live, eps)
        ctx.packed = packed
        ctx.save_for_backward(org, dirn, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, t_bar, _idx_bar):
        org, dirn, t, idx = ctx.saved_tensors
        d_org, d_dir = intersect_vjp(ctx.packed, org.float(), dirn.float(), t, idx, t_bar)
        return d_org.to(org.dtype), d_dir.to(dirn.dtype), None, None, None


@tracing.spanned("pt3.k2", device=True)
def intersect_packed(packed: PackedScene, org: torch.Tensor, dirn: torch.Tensor,
                     eps: float, live: torch.Tensor | None = None):
    """Nearest hit per ray. org/dirn: [3, R]; live: [R] bool (None = all).
    Returns (t [R] float32, +inf on miss; packed idx [R] int32). ``t`` is
    differentiable w.r.t. org and dirn (``intersect_vjp``).

    CUDA tensors launch the kernel (and raise if it fails); CPU tensors
    take the plain version. Traced as ``pt3.k2``."""
    if live is None:
        live = torch.ones((org.shape[1],), dtype=torch.bool, device=org.device)
    live = live.to(torch.bool)
    _check_inputs(packed, org, dirn, live)
    return _Intersect.apply(org, dirn, live, packed, eps)


intersect_packed.launches = 0
