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

Design on the H100: one thread per ray. The scene tables stay in global
memory and are read through the read-only path; at the scene sizes of the
catalog they live in L1/L2, so the kernel is bound by FP32 operations (the
per-pair tests), not by bytes: every ray reads 24 B and writes 8 B. Scenes
with more than ``2 * 64`` triangles cull with the two-level box hierarchy
(FAN=8 leaves per node) per ray, which is exact per ray and so gives the
same winners as the TPU kernel's whole-tile test. The reciprocal keeps the
``rcp * (2 - den * rcp)`` refinement of the TPU kernel after an IEEE divide.

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

from . import _cuda
from .vecmath import fsqrt
from .xla_cpu import fma

TC = 64  # triangles per chunk == box-hierarchy leaf size
SC = 64  # spheres per chunk
FAN = 8  # leaves per level-1 node

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

    ``tri_tab`` [Tpad, 12] Woop rows, ``box_tab`` [C, 8] per-chunk boxes
    (lo3 hi3 pad2), ``box1_tab`` [ceil(C/FAN), 8] level-1 boxes, ``sph_tab``
    [Spad, 8] (centre3, r^2, |c|^2, pad3) — the same tables, row for row,
    as the JAX package's ``PackedScene``."""

    def __init__(self, scene):
        tri = scene.triangles
        sph = scene.spheres
        dev = scene.device
        f32 = torch.float32
        self.n_tri = int(tri.woop.shape[0])
        self.n_sph = int(sph.centre.shape[0])
        tri_tab = tri.woop.reshape(self.n_tri, 12).to(f32)
        t_mult = TC if self.n_tri > TC else 8
        self.tri_tab = _pad_rows(tri_tab, t_mult).contiguous()

        if self.n_tri:
            verts = tri.verts.to(f32)
            pad = self.tri_tab.shape[0] - self.n_tri
            if pad:
                verts = torch.cat([verts, verts[-1:, -1:, :].expand(pad, 3, 3)], dim=0)
            chunk = min(TC, self.tri_tab.shape[0])
            n_chunks = verts.shape[0] // chunk
            v = verts.reshape(n_chunks, chunk * 3, 3)
            lo = v.min(dim=1).values
            hi = v.max(dim=1).values
            zeros2 = torch.zeros((n_chunks, 2), dtype=f32, device=dev)
            self.box_tab = torch.cat([lo, hi, zeros2], dim=1).contiguous()
            n_l1 = -(-n_chunks // FAN)
            pad1 = n_l1 * FAN - n_chunks
            lo_p = torch.cat([lo, torch.full((pad1, 3), _INF, dtype=f32, device=dev)])
            hi_p = torch.cat([hi, torch.full((pad1, 3), -_INF, dtype=f32, device=dev)])
            lo1 = lo_p.reshape(n_l1, FAN, 3).min(dim=1).values
            hi1 = hi_p.reshape(n_l1, FAN, 3).max(dim=1).values
            self.box1_tab = torch.cat(
                [lo1, hi1, torch.zeros((n_l1, 2), dtype=f32, device=dev)], dim=1
            ).contiguous()
        else:
            self.box_tab = torch.zeros((1, 8), dtype=f32, device=dev)
            self.box1_tab = torch.zeros((1, 8), dtype=f32, device=dev)

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
    org = org.to(torch.float32).contiguous()
    dirn = dirn.to(torch.float32).contiguous()
    live_f = live.to(torch.float32).contiguous()
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    idx_out = torch.empty((n,), dtype=torch.int32, device=dev)
    cull = int(packed.n_tri > 2 * TC)
    lib = _cuda.lib()
    err = lib.pt3_intersect(
        packed.tri_tab.data_ptr(), packed.box_tab.data_ptr(),
        packed.box1_tab.data_ptr(), packed.sph_tab.data_ptr(),
        packed.n_tri, packed.n_sph, packed.t_pad, int(packed.box_tab.shape[0]),
        org.data_ptr(), dirn.data_ptr(), live_f.data_ptr(),
        t_out.data_ptr(), idx_out.data_ptr(), n, float(eps), cull,
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


def intersect_packed(packed: PackedScene, org: torch.Tensor, dirn: torch.Tensor,
                     eps: float, live: torch.Tensor | None = None):
    """Nearest hit per ray. org/dirn: [3, R]; live: [R] bool (None = all).
    Returns (t [R] float32, +inf on miss; packed idx [R] int32). ``t`` is
    differentiable w.r.t. org and dirn (``intersect_vjp``).

    CUDA tensors launch the kernel (and raise if it fails); CPU tensors
    take the plain version."""
    if live is None:
        live = torch.ones((org.shape[1],), dtype=torch.bool, device=org.device)
    live = live.to(torch.bool)
    _check_inputs(packed, org, dirn, live)
    return _Intersect.apply(org, dirn, live, packed, eps)


intersect_packed.launches = 0
