"""smallpt sidecar: the ground-truth integrator with the features the three
ways dropped, Russian roulette and true dielectric refraction.

The port of the JAX package's ``models/smallpt.py``, a wavefront form of the
vendored smallpt.cpp (src/smallpt/smallpt.cpp, Kevin Beason's 99-line
tracer):

  * the 9-sphere Cornell scene (smallpt.cpp:57-73);
  * smallpt's camera: a 2x2 subpixel grid with a tent filter, rays pushed
    140 units forward along the unit direction, the image y-flipped
    (smallpt.cpp:140-160);
  * radiance: black on a miss, emission at every hit, Russian roulette from
    depth 5 with survival p = the albedo's largest component
    (smallpt.cpp:98-103); DIFF cosine sampling in smallpt's own basis
    (|w.x| > .1 pivot), SPEC mirror, REFR Schlick-Fresnel dielectric with a
    reflect/refract roulette (smallpt.cpp:104-137), where smallpt splits
    paths at depth <= 2: the JAX package's one deviation, kept;
  * a per-subpixel clamp before accumulation (smallpt.cpp:158-159).

The sphere quadratic is evaluated in double-single ("df64") arithmetic: the
walls are spheres of radius 1e5, and plain float32 leaves about half a unit
of error on wall hits. The error-free transforms (``_two_sum``,
``_split``, ``_two_prod``) need every product and sum rounded on its own:
on a CUDA device they are separate tensor operations (never a fused or
compiled op), on the CPU the products that XLA's CPU code contracts into
sums go through ``ops/vecmath.fma`` so CPU renders follow the JAX package.

Draws come from the JAX package's threefry streams (ops/rng.py); the
winner's data is an indexed load from the [S, 10] sphere table (the JAX
package's one-hot matmul is a TPU gather). Layout: component-major
([3, N]). Runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import rng
from ..ops.vecmath import cross, dotc, fcos, fma, fsin, fsqrt, normalise, reflect, safe_sqrt

DIFF, SPEC, REFR = 0, 1, 2

# radius, position, emission, colour, material (smallpt.cpp:57-73)
_SPHERES = [
    (1e5, (1e5 + 1, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), DIFF),  # left
    (1e5, (-1e5 + 99, 40.8, 81.6), (0, 0, 0), (0.25, 0.25, 0.75), DIFF),  # right
    (1e5, (50, 40.8, 1e5), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),  # back
    (1e5, (50, 40.8, -1e5 + 170), (0, 0, 0), (0, 0, 0), DIFF),  # front
    (1e5, (50, 1e5, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),  # bottom
    (1e5, (50, -1e5 + 81.6, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),  # top
    (16.5, (27, 16.5, 47), (0, 0, 0), (0.999, 0.999, 0.999), SPEC),  # mirror
    (16.5, (73, 16.5, 78), (0, 0, 0), (0.999, 0.999, 0.999), REFR),  # glass
    (600, (50, 681.6 - 0.27, 81.6), (12, 12, 12), (0, 0, 0), DIFF),  # light
]

EPS = 1e-3  # the df64 quadratic leaves ~1e-4-scale t error at t ~ 100

# --- double-single ("df64") arithmetic for the sphere quadratic ---------
_SPLIT = 4097.0  # 2^12 + 1: Dekker's split of a float32


def _two_sum(a, b):
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _two_diff(a, b):
    s = a - b
    v = s - a
    e = (a - (s - v)) - (b + v)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    # the split halves' products are exact, so contracting them changes nothing
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _dd_add(x, y):
    """(hi, lo) + (hi, lo)"""
    s, e = _two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return _two_sum(s, e)


def _dd_mul_dd_f(x, f):
    """dd * float -> dd"""
    p, e = _two_prod(x[0], f)
    e = fma(x[1], f, e)
    return _two_sum(p, e)


def _dd_neg(x):
    return -x[0], -x[1]


def _dd_sqr(x):
    """dd^2 -> dd (drops the lo*lo term)"""
    p, e = _two_prod(x[0], x[0])
    e = fma(2.0 * x[0], x[1], e)
    return _two_sum(p, e)


class SmallptScene(NamedTuple):
    centre: torch.Tensor  # [S, 3]
    radius_sq: torch.Tensor  # [S] hi part of r^2 (df64)
    radius_sq_lo: torch.Tensor  # [S] lo part of r^2
    emission: torch.Tensor  # [S, 3]
    colour: torch.Tensor  # [S, 3]
    refl_type: torch.Tensor  # [S] int32

    def table(self) -> torch.Tensor:
        """[S, 10] rows (centre, colour, emission, type) of the winner load."""
        return torch.cat([self.centre, self.colour, self.emission,
                          self.refl_type.to(self.centre.dtype)[:, None]], dim=1)


def smallpt_scene(dtype=torch.float32, device="cpu") -> SmallptScene:
    centre = np.array([s[1] for s in _SPHERES], np.float64)
    radius = np.array([s[0] for s in _SPHERES], np.float64)
    r2 = radius * radius
    r2_hi = r2.astype(np.float32).astype(np.float64)
    r2_lo = r2 - r2_hi
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
    return SmallptScene(
        centre=f(centre),
        radius_sq=f(r2_hi),
        radius_sq_lo=f(r2_lo),
        emission=f([s[2] for s in _SPHERES]),
        colour=f([s[3] for s in _SPHERES]),
        refl_type=torch.tensor([s[4] for s in _SPHERES], dtype=torch.int32, device=device),
    )


def _intersect(scene: SmallptScene, org, dirn):
    """smallpt's sphere test on [3, R] rays (smallpt.cpp:45-53) over [S, R]
    tiles, the quadratic in df64. Returns (t [R] (+inf on a miss), index
    [R] int32, the lowest sphere on a tie)."""
    opx = _two_diff(scene.centre[:, 0:1], org[0][None, :])
    opy = _two_diff(scene.centre[:, 1:2], org[1][None, :])
    opz = _two_diff(scene.centre[:, 2:3], org[2][None, :])
    # b = op . d
    b = _dd_add(
        _dd_add(_dd_mul_dd_f(opx, dirn[0]), _dd_mul_dd_f(opy, dirn[1])),
        _dd_mul_dd_f(opz, dirn[2]),
    )
    # det = b^2 - |op|^2 + r^2
    op2 = _dd_add(_dd_add(_dd_sqr(opx), _dd_sqr(opy)), _dd_sqr(opz))
    r2 = (scene.radius_sq[:, None], scene.radius_sq_lo[:, None])
    det = _dd_add(_dd_add(_dd_sqr(b), _dd_neg(op2)), r2)
    det_hi = det[0] + det[1]
    ok = det_hi >= 0.0
    zero = torch.zeros_like(det_hi)
    # sqrt with one dd Newton refinement
    s0 = fsqrt(torch.where(ok, det_hi, zero))
    s0_sq = _two_prod(s0, s0)
    resid = _dd_add(det, _dd_neg(s0_sq))
    pos = s0 > 0
    corr = torch.where(pos, (resid[0] + resid[1])
                       / (2.0 * torch.where(pos, s0, torch.ones_like(s0))), zero)
    # roots b -/+ sqrt(det), recombined at working precision with the dd tails
    mt = _two_diff(b[0], s0)
    minus_t = mt[0] + (mt[1] + b[1] - corr)
    pt = _two_sum(b[0], s0)
    plus_t = pt[0] + (pt[1] + b[1] + corr)
    t = torch.where(minus_t > EPS, minus_t, plus_t)
    valid = ok & (t > EPS)
    t = torch.where(valid, t, torch.full_like(t, math.inf))
    best, idx = torch.min(t, dim=0)
    return best, idx.to(torch.int32)


def _bounce(scene: SmallptScene, table, state, uniforms, rr: bool):
    """One smallpt bounce over all live paths (smallpt.cpp:90-138); ``rr``:
    Russian roulette (depth 5 on)."""
    org, dirn, beta, acc, alive = state
    u1, u2, u_rr, u_refr = uniforms
    t, idx = _intersect(scene, org, dirn)
    found = torch.isfinite(t)
    live = alive & found
    t_safe = torch.where(found, t, torch.zeros_like(t))
    x = fma(t_safe, dirn, org)
    g = table[idx.long()].T  # [10, R]
    n = normalise(x - g[0:3])
    nl = torch.where(dotc(n, dirn) < 0, n, -n)
    f = g[3:6]
    e = g[6:9]
    refl = torch.round(g[9]).to(torch.int32)

    acc = acc + torch.where(live, beta * e, torch.zeros_like(acc))

    if rr:
        p = torch.maximum(torch.maximum(f[0], f[1]), f[2])
        survive = u_rr < p
        f = f / torch.clamp(p, min=1e-12)
        live = live & survive

    # DIFF: cosine-weighted in smallpt's basis (smallpt.cpp:105-111)
    r1 = 2.0 * math.pi * u1
    r2s = fsqrt(u2)
    w = nl
    use_y = torch.abs(w[0]) > 0.1
    piv_y = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device).reshape(3, 1)
    piv_x = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device).reshape(3, 1)
    uax = normalise(cross(torch.where(use_y, piv_y, piv_x), w))
    vax = cross(w, uax)
    d_diff = normalise(fma(w, safe_sqrt(1.0 - u2),
                           fma(uax, fcos(r1) * r2s, vax * (fsin(r1) * r2s))))

    # SPEC: mirror (smallpt.cpp:112-114)
    d_spec = reflect(dirn, n)

    # REFR: dielectric with Schlick's Fresnel (smallpt.cpp:115-137)
    into = dotc(n, nl) > 0
    nc, nt = 1.0, 1.5
    nnt = torch.where(into, torch.full_like(u1, nc / nt), torch.full_like(u1, nt / nc))
    ddn = dotc(dirn, nl)
    cos2t = fma(-(nnt * nnt), fma(-ddn, ddn, 1.0), 1.0)
    tir = cos2t < 0
    sgn = torch.where(into, torch.ones_like(u1), -torch.ones_like(u1))
    tdir = normalise(fma(dirn, nnt, -(n * (sgn * fma(ddn, nnt, safe_sqrt(cos2t))))))
    a, b_ = nt - nc, nt + nc
    r0 = (a * a) / (b_ * b_)
    c = 1.0 - torch.where(into, -ddn, dotc(tdir, n))
    c5 = c * ((c * c) * (c * c))  # c**5 as XLA's integer power
    re = fma(c5, 1.0 - r0, r0)
    tr = 1.0 - re
    prob = fma(re, 0.5, 0.25)
    pick_refl = u_refr < prob
    one = torch.ones_like(re)
    d_refr = torch.where(tir, d_spec, torch.where(pick_refl, d_spec, tdir))
    w_refr = torch.where(tir, one, torch.where(pick_refl, re / prob, tr / (1.0 - prob)))

    is_diff = refl == DIFF
    is_spec = refl == SPEC
    new_dir = torch.where(is_diff, d_diff, torch.where(is_spec, d_spec, d_refr))
    weight = torch.where(is_diff | is_spec, one, w_refr)
    new_beta = beta * f * weight

    return (
        torch.where(live, x, org),
        torch.where(live, new_dir, dirn),
        torch.where(live, new_beta, beta),
        acc,
        live,
    )


def _camera_rays(key, px, py, sx: int, sy: int, width: int, height: int, dtype):
    """smallpt's camera with the tent filter (smallpt.cpp:142-157): [3, R]
    origins and unit directions."""
    dev = px.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=dev).reshape(3, 1)
    cam_o = t([50.0, 52.0, 295.6])
    cam_dir = np.array([0.0, -0.042612, -1.0])
    cam_dir = cam_dir / np.linalg.norm(cam_dir)
    cx_v = np.array([width * 0.5135 / height, 0.0, 0.0])
    cy_v = np.cross(cx_v, cam_dir)
    cy_v = cy_v / np.linalg.norm(cy_v) * 0.5135
    cam_d, cx, cy = t(cam_dir), t(cx_v), t(cy_v)

    us = rng.uniforms(key, (2, px.shape[0]), dev, dtype)
    r1 = 2.0 * us[0]
    dx = torch.where(r1 < 1, fsqrt(r1) - 1, 1 - safe_sqrt(2 - r1))
    r2 = 2.0 * us[1]
    dy = torch.where(r2 < 1, fsqrt(r2) - 1, 1 - safe_sqrt(2 - r2))
    fx = ((sx + 0.5 + dx) / 2.0 + px.to(dtype)) / width - 0.5
    fy = ((sy + 0.5 + dy) / 2.0 + py.to(dtype)) / height - 0.5
    d = fma(cx, fx, cy * fy) + cam_d
    # smallpt.cpp:157 pushes the origin along the NORMALISED direction
    # (``d.norm()`` mutates d and gcc evaluates the arguments right to left)
    dn = normalise(d)
    return fma(dn, 140.0, cam_o), dn


def radiance_pass(scene: SmallptScene, table, key, px, py, sx: int, sy: int, width: int,
                  height: int, max_bounces: int = 40) -> torch.Tensor:
    """Radiance of one 1-sample pass at subpixel (sx, sy) -> [R, 3], in the
    scene's dtype; ``table``: ``scene.table()``, built once a render."""
    n = px.shape[0]
    dev = px.device
    dtype = scene.centre.dtype
    org, dirn = _camera_rays(rng.stream_key(key, rng.CAMERA_STREAM), px, py, sx, sy,
                             width, height, dtype)
    state = (org, dirn, torch.ones((3, n), dtype=dtype, device=dev),
             torch.zeros((3, n), dtype=dtype, device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev))
    bkey = rng.stream_key(key, rng.BOUNCE_STREAM_BASE)
    # Russian roulette from depth 5 on (the JAX package scans depths 5..)
    for depth in range(max_bounces):
        u = rng.uniforms(rng.fold_in(bkey, depth), (4, n), dev, dtype)
        state = _bounce(scene, table, state, (u[0], u[1], u[2], u[3]), depth >= 5)
    return state[3].T


def render_smallpt(width: int, height: int, spp: int, seed: int = 1,
                   max_bounces: int = 40, device="cuda") -> np.ndarray:
    """Full smallpt render in float32 on ``device`` -> [H, W, 3] linear
    image (float64, y flipped to smallpt's PPM row order, smallpt.cpp:147
    ``i=(h-y-1)*w+x``). ``spp`` samples a pixel: spp // 4 (at least 1) at
    each of the four subpixels, each subpixel's mean clamped to [0, 1]."""
    from .render import resolve_device

    dev = resolve_device(device)
    scene = smallpt_scene(torch.float32, dev)
    table = scene.table()
    samps = max(spp // 4, 1)
    xs = torch.arange(width, dtype=torch.int32, device=dev).repeat(height)
    ys = torch.arange(height, dtype=torch.int32, device=dev).repeat_interleave(width)
    base = rng.base_key(seed)
    img = np.zeros((height * width, 3), np.float64)
    with torch.no_grad():
        for sy in range(2):
            for sx in range(2):
                sub = np.zeros((height * width, 3), np.float64)
                for s in range(samps):
                    k = rng.pass_key(base, ((sy * 2 + sx) << 20) + s)
                    rad = radiance_pass(scene, table, k, xs, ys, sx, sy, width, height,
                                        max_bounces)
                    sub += rad.cpu().numpy().astype(np.float64)
                sub /= samps
                img += 0.25 * np.clip(sub, 0.0, 1.0)  # smallpt.cpp:158-159
    return img.reshape(height, width, 3)[::-1]
