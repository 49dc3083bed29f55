"""Ray-scene intersection on whole [*, R] tensors (the scan wavefront's path).

The plain PyTorch form of the JAX package's ``ops/intersect.py``; semantics
match the reference (src/dod/Scene.cpp:13-122):

  * spheres: smallpt quadratic, ``t = minusT if minusT > eps else plusT``,
    both-behind reject, inside detection + normal flip;
  * triangles: Moller-Trumbore acceptance region (u >= 0, u <= 1, v >= 0,
    u+v <= 1), parallel reject, backface flip, vertex-normal interpolation
    for the winning triangle only;
  * combination: nearest wins; on an exact tie the sphere wins, because
    triangles must be strictly nearer (src/dod/Scene.cpp:115-122).

Layout: rays are component-major ([3, R]); per-pair intermediates are
[S, R] / [T, R]. Winner attributes are indexed loads (the JAX package's
one-hot matmuls are exact gathers). ``hits_from_winner`` is shared with the
kernel path (``intersect_scene(..., backend="kernel")``), which takes the
winner from the K2 kernel (ops/intersect_kernel.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import dotc, fma, normalise, safe_sqrt, vec3

INF = float("inf")

# |w_d| below this counts as "ray parallel to triangle plane".
_PARALLEL_EPS = 1e-12


class Hits(NamedTuple):
    """SoA hit record (reference Hit + material id, src/math/Hit.h:6-11)."""

    t: torch.Tensor  # [R] distance, +inf when miss
    hit: torch.Tensor  # [R] bool
    pos: torch.Tensor  # [3, R]
    normal: torch.Tensor  # [3, R] always opposing the ray
    inside: torch.Tensor  # [R] bool (sphere interior / triangle backface)
    mat_id: torch.Tensor  # [R] int32


def _argmin_rows(t: torch.Tensor):
    """(min over axis 0, lowest row attaining it)."""
    best = torch.min(t, dim=0).values
    rows = torch.arange(t.shape[0], device=t.device, dtype=torch.int32)[:, None]
    big = torch.full_like(rows, 2**30)
    idx = torch.min(torch.where(t <= best[None, :], rows, big), dim=0).values
    return best, idx.to(torch.int32)


def intersect_spheres(orig, dirn, centre, radius_sq, centre_sq, eps: float):
    """Nearest sphere per ray. Returns (t [R] (+inf miss), index [R])."""
    s = centre.shape[0]
    r = orig.shape[1]
    if s == 0:
        return (torch.full((r,), INF, dtype=orig.dtype, device=orig.device),
                torch.zeros((r,), dtype=torch.int32, device=orig.device))
    cx = centre[:, 0:1]
    cy = centre[:, 1:2]
    cz = centre[:, 2:3]
    # sums in the fused multiply-add form of the JAX package's compiled CPU
    # code (ops/vecmath.fma)
    cd = fma(cz, dirn[2], fma(cx, dirn[0], cy * dirn[1]))  # [S, R]
    co = fma(cz, orig[2], fma(cx, orig[0], cy * orig[1]))  # [S, R]
    od = dotc(orig, dirn)  # [R]
    oo = dotc(orig, orig)  # [R]
    b = cd - od[None, :]
    det = fma(b, b, -centre_sq[:, None]) + 2.0 * co - oo[None, :] + radius_sq[:, None]
    sq = safe_sqrt(det)
    minus_t = b - sq
    plus_t = b + sq
    t = torch.where(minus_t > eps, minus_t, plus_t)
    valid = (det >= 0.0) & (t > eps)
    t = torch.where(valid, t, torch.full_like(t, INF))
    return _argmin_rows(t)


def _tri_block(orig, dirn, woop, eps):
    """Best triangle within one chunk. Returns (t [R], local idx [R])."""
    ox, oy, oz = orig[0], orig[1], orig[2]
    dx, dy, dz = dirn[0], dirn[1], dirn[2]

    def row(k):
        return (woop[:, k, 0:1], woop[:, k, 1:2], woop[:, k, 2:3], woop[:, k, 3:4])

    u0, u1, u2, u3 = row(0)
    v0, v1, v2, v3 = row(1)
    w0, w1, w2, w3 = row(2)
    d3 = lambda a, b, c, x, y, z: fma(c, z, fma(a, x, b * y))
    o_u = d3(u0, u1, u2, ox, oy, oz) + u3  # [T, R]
    o_v = d3(v0, v1, v2, ox, oy, oz) + v3
    o_w = d3(w0, w1, w2, ox, oy, oz) + w3
    d_u = d3(u0, u1, u2, dx, dy, dz)
    d_v = d3(v0, v1, v2, dx, dy, dz)
    d_w = d3(w0, w1, w2, dx, dy, dz)

    not_parallel = torch.abs(d_w) > _PARALLEL_EPS
    safe_wd = torch.where(not_parallel, d_w, torch.ones_like(d_w))
    t = -o_w / safe_wd
    u = fma(t, d_u, o_u)
    v = fma(t, d_v, o_v)
    valid = (
        not_parallel
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > eps)
    )
    t = torch.where(valid, t, torch.full_like(t, INF))
    return _argmin_rows(t)


def intersect_triangles(orig, dirn, woop, eps: float, tri_chunk: int = 1024):
    """Nearest triangle per ray. Returns (t [R] (+inf miss), index [R]);
    chunks of ``tri_chunk`` rows carry the running winner (strict <)."""
    t_count = woop.shape[0]
    r = orig.shape[1]
    if t_count == 0:
        return (torch.full((r,), INF, dtype=orig.dtype, device=orig.device),
                torch.zeros((r,), dtype=torch.int32, device=orig.device))
    if t_count <= tri_chunk:
        return _tri_block(orig, dirn, woop, eps)
    best_t = torch.full((r,), INF, dtype=orig.dtype, device=orig.device)
    best_i = torch.zeros((r,), dtype=torch.int32, device=orig.device)
    for base in range(0, t_count, tri_chunk):
        ct, ci = _tri_block(orig, dirn, woop[base:base + tri_chunk], eps)
        take = ct < best_t
        best_t = torch.where(take, ct, best_t)
        best_i = torch.where(take, ci + base, best_i)
    return best_t, best_i


def _triangle_shade_info(orig, dirn, t, idx, woop, normals, mat_id):
    """Recompute (u, v, w_d) for each ray's winning triangle and build the
    interpolated, backface-flipped normal (src/dod/Scene.cpp:99-113)."""
    idx = idx.long()
    c = woop.reshape(-1, 12)[idx].T  # [12, R]
    n = normals.reshape(-1, 9)[idx].T  # [9, R]
    ox, oy, oz = orig[0], orig[1], orig[2]
    dx, dy, dz = dirn[0], dirn[1], dirn[2]
    d3 = lambda a, b, c_, x, y, z: fma(c_, z, fma(a, x, b * y))
    o_u = d3(c[0], c[1], c[2], ox, oy, oz) + c[3]
    o_v = d3(c[4], c[5], c[6], ox, oy, oz) + c[7]
    d_u = d3(c[0], c[1], c[2], dx, dy, dz)
    d_v = d3(c[4], c[5], c[6], dx, dy, dz)
    d_w = d3(c[8], c[9], c[10], dx, dy, dz)
    u = fma(t, d_u, o_u)
    v = fma(t, d_v, o_v)
    interp = vec3(
        fma(v, n[6] - n[0], fma(u, n[3] - n[0], n[0])),
        fma(v, n[7] - n[1], fma(u, n[4] - n[1], n[1])),
        fma(v, n[8] - n[2], fma(u, n[5] - n[2], n[2])),
    )
    interp = normalise(interp)
    # det_MT = -w_d * |n_un|^2, backfacing iff det_MT < eps ~ w_d > 0
    backfacing = d_w > 0.0
    normal = torch.where(backfacing, -interp, interp)
    return normal, backfacing, mat_id[idx].to(torch.int32)


def intersect_scene(scene, orig, dirn, eps: float, tri_chunk: int = 1024,
                    backend: str = "xla", live=None, packed=None) -> Hits:
    """Nearest hit across spheres + triangles (src/dod/Scene.cpp:115-122).

    backend="kernel" takes the winner from kernel K2
    (ops/intersect_kernel.intersect_packed) on ``packed``, the scene's
    ``PackedScene`` (built here when None); "xla" is the broadcast scan
    above. ``live`` lanes that are False report a miss.
    """
    sph = scene.spheres
    tri = scene.triangles
    if backend == "kernel":
        from .intersect_kernel import PackedScene, intersect_packed

        r = orig.shape[1]
        if live is None:
            live = torch.ones((r,), dtype=torch.bool, device=orig.device)
        if packed is None:
            packed = PackedScene(scene)
        t, pidx = intersect_packed(packed, orig, dirn, eps, live=live)
        n_tri = scene.num_triangles
        tri_wins = pidx < n_tri
        zero = torch.zeros_like(pidx)
        i_t = torch.where(tri_wins, pidx, zero)
        i_s = torch.where(tri_wins, zero, pidx - n_tri)
    else:
        t_s, i_s = intersect_spheres(
            orig, dirn, sph.centre, sph.radius_sq, sph.centre_sq, eps
        )
        t_t, i_t = intersect_triangles(orig, dirn, tri.woop, eps, tri_chunk)
        tri_wins = t_t < t_s
        t = torch.where(tri_wins, t_t, t_s)
        if live is not None:
            t = torch.where(live, t, torch.full_like(t, INF))
    return hits_from_winner(scene, orig, dirn, t, tri_wins, i_t, i_s)


def hits_from_winner(scene, orig, dirn, t, tri_wins, i_t, i_s) -> Hits:
    """Hits reconstruction from a known winner (shared by both backends)."""
    sph = scene.spheres
    tri = scene.triangles
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    pos = fma(t_safe, dirn, orig)

    has_s = scene.num_spheres > 0
    has_t = scene.num_triangles > 0

    if has_s:
        i_sl = i_s.long()
        c = sph.centre[i_sl].T  # [3, R]
        n_sph = normalise(pos - c)
        inside_s = dotc(n_sph, dirn) > 0.0
        n_sph = torch.where(inside_s, -n_sph, n_sph)
        mat_s = sph.mat_id[i_sl].to(torch.int32)
    if has_t:
        n_tri, inside_t, mat_t = _triangle_shade_info(
            orig, dirn, t_safe, i_t, tri.woop, tri.normals, tri.mat_id
        )

    if has_s and has_t:
        normal = torch.where(tri_wins, n_tri, n_sph)
        inside = torch.where(tri_wins, inside_t, inside_s)
        mat_id = torch.where(tri_wins, mat_t, mat_s)
    elif has_t:
        normal, inside, mat_id = n_tri, inside_t, mat_t
    elif has_s:
        normal, inside, mat_id = n_sph, inside_s, mat_s
    else:
        normal = torch.zeros_like(pos)
        inside = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        mat_id = torch.zeros(t.shape, dtype=torch.int32, device=t.device)

    return Hits(t=t, hit=hit, pos=pos, normal=normal, inside=inside, mat_id=mat_id)
