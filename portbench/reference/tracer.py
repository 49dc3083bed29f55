"""The path tracer's estimator in plain PyTorch, at any precision.

One function traces a batch of camera samples (pixel, sample pass) with
their K = nu x nv first-bounce lanes to depth ``max_depth``, the upstream
estimator (pt-three-ways ``src/dod/Scene.cpp``):

* camera ray (thin lens), nearest hit over every sphere and triangle
  (brute force), emission at the hit, the environment on a miss;
* at each hit: Fresnel reflectance (or the material's fixed
  reflectivity) against ``p`` chooses a glossy cone sample about the
  mirror direction (the throughput kept) or a cosine hemisphere sample
  (the throughput tinted by the diffuse colour); a path whose throughput
  is exactly zero stops; the first bounce is stratified over K cells;
* the sample's radiance: the camera hit's emission plus the mean over the
  K lanes of what each path gathered.

Draws come from callbacks, so a caller supplies the program's streams.
Everything is differentiable w.r.t. the material table with the discrete
choices (winner, event, liveness) held fixed, and the hit distance
differentiable w.r.t. the ray; the branch weight P / stop_grad(P) (1 in
value) carries the derivative of the event's probability. Nothing here
comes from the program: it is written from the upstream description.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scene import RefScene

PARALLEL = 1e-12
COINCIDENT = 0.9999


class Geometry:
    """A RefScene's tensors on ``device``: Woop rows (world -> (u, v, w) of
    each triangle, from its vertices in float64), face normals, spheres,
    and the material table [M, 9] in ``dtype``."""

    def __init__(self, rs: RefScene, device, dtype, search_dtype=None):
        self.dtype = dtype
        self.search_dtype = search_dtype or dtype
        f = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        v = rs.verts
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        n = np.cross(e1, e2)
        m = np.stack([e1, e2, n], axis=-1)
        inv = np.linalg.inv(m) if len(v) else np.zeros((0, 3, 3))
        woop = np.concatenate([inv, -np.einsum("tij,tj->ti", inv, v[:, 0])[:, :, None]], -1)
        self.n_tri, self.n_sph = len(v), len(rs.radius)
        self.woop = f(woop)  # [T, 3, 4]
        self.woop_s = f(woop, self.search_dtype)
        nn = np.linalg.norm(n, axis=1, keepdims=True)
        self.face_n = f(n / np.maximum(nn, 1e-300))
        self.centre = f(rs.centre)
        self.centre_s = f(rs.centre, self.search_dtype)
        self.r2 = f(rs.radius ** 2)
        self.r2_s = f(rs.radius ** 2, self.search_dtype)
        self.tri_mat = torch.as_tensor(rs.tri_mat, device=device)
        self.sph_mat = torch.as_tensor(rs.sph_mat, device=device)
        self.env = f(rs.environment)
        self.mats = f(rs.materials)  # [M, 9]: the table a render traces with
        self.eps = rs.epsilon


def search(g: Geometry, o, d, live, chunk: int = 1 << 15):
    """Nearest hit of rays o, d [N, 3] (no gradient): (t [N] in the search
    dtype, +inf where none or dead; is_tri [N]; index [N]; minus [N], a
    sphere hit on its near root). Spheres first; a triangle takes over only
    when strictly nearer; the lowest index wins a tie."""
    n = o.shape[0]
    dev = o.device
    sd = g.search_dtype
    t_out = torch.full((n,), math.inf, dtype=sd, device=dev)
    tri_out = torch.zeros((n,), dtype=torch.bool, device=dev)
    idx_out = torch.zeros((n,), dtype=torch.int64, device=dev)
    minus_out = torch.zeros((n,), dtype=torch.bool, device=dev)
    eps = g.eps
    rows = live.nonzero()[:, 0]
    with torch.no_grad():
        for c in range(0, rows.shape[0], chunk):
            r = rows[c:c + chunk]
            oc, dc = o[r].to(sd), d[r].to(sd)
            best = torch.full((r.shape[0],), math.inf, dtype=sd, device=dev)
            is_tri = torch.zeros_like(best, dtype=torch.bool)
            idx = torch.zeros_like(best, dtype=torch.int64)
            minus = torch.zeros_like(is_tri)
            if g.n_sph:
                rel = g.centre_s[None] - oc[:, None]  # [R, S, 3]
                b = (rel * dc[:, None]).sum(-1)
                det = b * b - (rel * rel).sum(-1) + g.r2_s[None]
                ok = det >= 0
                sq = torch.sqrt(torch.where(ok, det, torch.zeros_like(det)))
                tm, tp = b - sq, b + sq
                near = tm > eps
                t = torch.where(near, tm, tp)
                t = torch.where(ok & (t > eps), t, torch.full_like(t, math.inf))
                best, j = t.min(dim=1)
                idx = j
                minus = near.gather(1, j[:, None])[:, 0]
            if g.n_tri:
                w = g.woop_s  # [T, 3, 4]
                ou = oc @ w[:, 0, :3].T + w[:, 0, 3]
                ov = oc @ w[:, 1, :3].T + w[:, 1, 3]
                ow = oc @ w[:, 2, :3].T + w[:, 2, 3]
                du, dv, dw = dc @ w[:, 0, :3].T, dc @ w[:, 1, :3].T, dc @ w[:, 2, :3].T
                par = dw.abs() > PARALLEL
                t = -ow / torch.where(par, dw, torch.ones_like(dw))
                u = ou + t * du
                v = ov + t * dv
                ok = par & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
                t = torch.where(ok, t, torch.full_like(t, math.inf))
                tt, jt = t.min(dim=1)
                take = tt < best
                best = torch.where(take, tt, best)
                idx = torch.where(take, jt, idx)
                is_tri = take
            t_out[r], tri_out[r], idx_out[r], minus_out[r] = best, is_tri, idx, minus
    return t_out, tri_out, idx_out, minus_out


def _norm(x):
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-30))


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _onb(z):
    use_y = (z[..., 0].abs() > COINCIDENT)[..., None]
    e = torch.zeros_like(z)
    pivot = torch.where(use_y, e + torch.tensor([0.0, 1.0, 0.0], dtype=z.dtype, device=z.device),
                        e + torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype, device=z.device))
    x = _norm(_cross(pivot, z))
    return x, _norm(_cross(z, x))


def hit_info(g: Geometry, mats, o, d, t_s, is_tri, idx, minus):
    """Differentiable hit (t, position, oriented normal, inside, material
    rows [N, 9]) at a known winner; t recomputed in the tracing dtype."""
    hit = torch.isfinite(t_s)
    tri = hit & is_tri
    sph = hit & ~is_tri
    dt = g.dtype
    zero = torch.zeros_like(o[:, 0])
    if g.n_tri:
        w = g.woop[torch.where(tri, idx, 0), 2]  # [N, 4]
        dw = (w[:, :3] * d).sum(-1)
        t_t = -((w[:, :3] * o).sum(-1) + w[:, 3]) / torch.where(tri, dw, torch.ones_like(dw))
    else:
        t_t = zero
    if g.n_sph:
        c = g.centre[torch.where(sph, idx, 0)]
        rel = c - o
        b = (rel * d).sum(-1)
        det = b * b - (rel * rel).sum(-1) + g.r2[torch.where(sph, idx, 0)]
        sq = torch.sqrt(torch.where(sph & (det > 0), det, torch.ones_like(det)))
        t_p = torch.where(minus, b - sq, b + sq)
    else:
        t_p = zero
    t = torch.where(tri, t_t, torch.where(sph, t_p, zero))
    pos = o + t[:, None] * d
    if g.n_tri:
        fn = g.face_n[torch.where(tri, idx, 0)]
        back = (fn * d).sum(-1) > 0
        n_t = torch.where(back[:, None], -fn, fn)
    else:
        back, n_t = torch.zeros_like(hit), torch.zeros_like(o)
    if g.n_sph:
        n_s = _norm(pos - c)
        ins = (n_s * d).sum(-1) > 0
        n_s = torch.where(ins[:, None], -n_s, n_s)
    else:
        ins, n_s = torch.zeros_like(hit), torch.zeros_like(o)
    normal = torch.where(is_tri[:, None], n_t, n_s)
    inside = torch.where(is_tri, back, ins)
    if g.n_tri and g.n_sph:
        row = torch.where(is_tri, g.tri_mat[torch.clamp(idx, max=g.n_tri - 1)],
                          g.sph_mat[torch.clamp(idx, max=g.n_sph - 1)])
    elif g.n_tri:
        row = g.tri_mat[idx]
    else:
        row = g.sph_mat[idx]
    return hit, pos, normal, inside, mats[torch.where(hit, row, 0)].to(dt)


def reflectivity(m, normal, d, inside):
    """Fresnel (upstream's rPerp formula for both polarisations, 1 beyond
    total internal reflection) or the fixed reflectivity when >= 0."""
    ior = m[:, 6]
    one = torch.ones_like(ior)
    a = torch.where(inside, ior, one)
    b = torch.where(inside, one, ior)
    ratio = a / b
    cos_i = -(d * normal).sum(-1)
    sin2 = ratio * ratio * (1.0 - cos_i * cos_i)
    q = 1.0 - sin2
    cos_t = torch.where(q > 0, torch.sqrt(torch.where(q > 0, q, one)), torch.zeros_like(q))
    den = a * cos_i + b * cos_t
    ok = den > 0
    r = torch.where(ok, (a * cos_i - b * cos_t) / torch.where(ok, den, one), one)
    fres = torch.where(sin2 > 1.0, one, r * r)
    return torch.where(m[:, 7] < 0, fres, m[:, 7])


def scatter(m, normal, d, u, v, acos_u, spec, mirror_below: float):
    """Next direction: cone sample about the mirror direction (``spec``)
    or cosine hemisphere sample about the normal."""
    rdir = d - normal * (2.0 * (d * normal).sum(-1, keepdim=True))
    cone = m[:, 8]
    theta = cone * (1.0 - 2.0 * acos_u / math.pi)
    cx, cy = _onb(rdir)
    rt = v * (2.0 * math.pi)
    s = _norm(cx * (torch.cos(rt) * torch.sin(theta))[:, None]
              + cy * (torch.sin(rt) * torch.sin(theta))[:, None]
              + rdir * torch.cos(theta)[:, None])
    cdir = torch.where((cone < mirror_below)[:, None], rdir, s)
    hx, hy = _onb(normal)
    ht = u * (2.0 * math.pi)
    hr = torch.sqrt(torch.clamp(v, min=0.0))
    h = _norm(hx * (torch.cos(ht) * hr)[:, None] + hy * (torch.sin(ht) * hr)[:, None]
              + normal * torch.sqrt(torch.clamp(1.0 - v, min=0.0))[:, None])
    return torch.where(spec[:, None], cdir, h)


def branch_weight(refl, spec):
    rh = refl.detach()
    return torch.where(spec, refl / torch.clamp(rh, min=1e-12),
                       (1.0 - refl) / torch.clamp(1.0 - rh, min=1e-12))


def camera_rays(cam: dict, px, py, u4, dtype):
    """Thin-lens camera rays [P, 3] of pixels (px, py) with uniforms u4 [P, 4]
    (jitter x, jitter y, lens angle, lens radius)."""
    dev = px.device
    c = {k: torch.as_tensor(np.asarray(cam[k]), dtype=dtype, device=dev)
         for k in ("eye", "x", "y", "z")}
    ux = 2.0 * ((px.to(dtype) + u4[:, 0]) / cam["w"]) - 1.0
    uy = 2.0 * ((py.to(dtype) + u4[:, 1]) / cam["h"]) - 1.0
    d = _norm(c["x"] * (-ux * cam["aspect"])[:, None] + c["y"] * (-uy)[:, None]
              + c["z"] * cam["plane_dist"])
    eye = c["eye"].expand_as(d)
    if cam["aperture"] <= 0:
        return eye, d
    focal = eye + d * cam["focal_dist"]
    ang = u4[:, 2] * (2.0 * math.pi)
    rad = u4[:, 3] * cam["aperture"]
    o = eye + c["x"] * (torch.cos(ang) * rad)[:, None] + c["y"] * (torch.sin(ang) * rad)[:, None]
    return o, _norm(focal - o)


def trace(g: Geometry, mats, cam: dict, px, py, u4, fb, bounce_draws, nb: int,
          nu: int = 4, nv: int = 4, kernel_mirror: float = 1e-9, count_until=None,
          winners=None):
    """Radiance [P, 3] of P camera samples.

    ``u4`` [P, 4] camera uniforms; ``fb`` [P, K, 3] first-bounce uniforms
    (the K = nu*nv cells, lane order k = iu * nv + iv); ``bounce_draws(d,
    alive)`` -> (u, v, p) [P*K] of depth d (lanes sample-major, then k).
    ``mats`` [M, 9]: the material table (a leaf for gradients). Returns
    (radiance, live bounces per lane [P*K] counted over the samples whose
    mask ``count_until`` [P] is True, or None). ``winners``: a list that the
    searches' results are appended to, or, when it already holds them, read
    from instead of searching again (a second pass over the same rays)."""
    recorded = winners is not None and len(winners) > 0

    def find(o_, d_, live_, i):
        if recorded:
            return winners[i]
        w = search(g, o_, d_, live_)
        if winners is not None:
            winners.append(w)
        return w

    dt = g.dtype
    k = nu * nv
    p_n = px.shape[0]
    o, d = camera_rays(cam, px, py, u4.to(dt), dt)
    live = torch.ones((p_n,), dtype=torch.bool, device=px.device)
    hit0, pos0, n0, in0, m0 = hit_info(g, mats, o, d, *find(o, d, live, 0))
    env = g.env.to(dt)
    fb = fb.to(dt)
    cell = torch.arange(k, device=px.device)
    u0 = ((cell // nv).to(dt)[None] + fb[..., 0]) / nu
    v0 = ((cell % nv).to(dt)[None] + fb[..., 1]) / nv
    refl0 = reflectivity(m0, n0, d, in0)
    spec0 = (fb[..., 2] < refl0[:, None]).reshape(-1)
    rep = lambda x: torch.repeat_interleave(x, k, dim=0)
    mx = rep(m0)
    u0, v0 = u0.reshape(-1), v0.reshape(-1)
    dirn = scatter(mx, rep(n0), rep(d), u0, v0, torch.arccos(torch.clamp(u0, 0.0, 1.0)),
                   spec0, 1e-4)
    beta = torch.where(spec0[:, None], torch.ones_like(mx[:, 3:6]), mx[:, 3:6]) \
        * branch_weight(rep(refl0), spec0)[:, None]
    alive = rep(hit0) & (beta != 0).any(-1)
    org = rep(pos0)
    acc = torch.zeros_like(beta)
    counts = torch.zeros((p_n * k,), dtype=torch.int64, device=px.device)
    cmask = None if count_until is None else rep(count_until)
    for depth in range(1, nb + 1):
        if count_until is not None:
            counts += (alive & cmask).to(torch.int64)
        u, v, p = (x.to(dt) for x in bounce_draws(depth, alive))
        hit, pos, nrm, ins, m = hit_info(g, mats, org, dirn, *find(org, dirn, alive, depth))
        hit = hit & alive
        miss = alive & ~hit
        acc = acc + torch.where(miss[:, None], beta * env, torch.zeros_like(beta)) \
            + torch.where(hit[:, None], beta * m[:, 0:3], torch.zeros_like(beta))
        refl = reflectivity(m, nrm, dirn, ins)
        spec = p < refl
        ndir = scatter(m, nrm, dirn, u, v, torch.arccos(torch.clamp(u, 0.0, 1.0)), spec,
                       kernel_mirror)
        nbeta = torch.where(spec[:, None], beta, beta * m[:, 3:6]) \
            * branch_weight(refl, spec)[:, None]
        org = torch.where(hit[:, None], pos, org)
        dirn = torch.where(hit[:, None], ndir, dirn)
        beta = torch.where(hit[:, None], nbeta, beta)
        alive = hit & (nbeta != 0).any(-1)
    mean = acc.reshape(p_n, k, 3).mean(1)
    rad = torch.where(hit0[:, None], m0[:, 0:3] + mean, env.expand_as(mean))
    return rad, (counts if count_until is not None else None)
