"""The path-tracing megakernels: K5 and K4 (rendering; K4's stream mode with
K6 for large meshes), K10 (the compacting wavefront), K7, K8, K4 replay and
K9 (training).

K5 and K4 trace S sample passes per lane in one launch. A lane is a fixed
(pixel, sub-stratum) slot; when its path dies it reloads the next alive
sample's first-bounce state (computed by the camera stage,
models/integrator._first_bounce_state) and keeps tracing, so occupancy stays
high and one launch replaces S * depth per-bounce launches. Per bounce:
nearest hit (the winner search of kernel K2), environment on miss, winner
attributes, emission, Fresnel-or-fixed reflectivity event, cone or
cosine-hemisphere continuation, zero-throughput kill, depth cutoff ``d >
nb`` (reference: src/dod/Scene.cpp:124-179, src/oo/Material.cpp).

K5 ``fused_passes`` replaces ``_megakernel_regen`` / ``_run_regen`` /
``fused_passes`` of the JAX package's ``ops/pallas_megakernel.py``: the
bounce uniforms (u, acos u, v, p) come from precomputed threefry tables
(``[S*nb, N, 4]``, lane-major: the JAX package's ``[S*nb*4, N]`` rows
regrouped) and a next-alive table ``[S+1, N]`` drives the refill, so it
is bit-compatible with the scan wavefront's streams. The table row of a
(sample, depth) event is a direct index. On the card it is a case of K4's
lane-queue loop with K2's searches (the unpacked winner: a one-chunk scene
staged in shared memory, any other culled by a ``PackedSceneStream``'s
window boxes, which it needs), and equals its plain version bit for bit.

K4 ``fused_passes_krng`` replaces ``_megakernel_regen_krng`` /
``_run_regen_krng`` / ``fused_passes_krng``: uniforms are hashed in the
kernel from (lane, sample, depth, seed) (kernel K1, ``csrc/kernel_rng.cuh``),
a two-word per-lane alive bitmask drives the refill (S <= 64), and the
winner is one packed (t, row) minimum per chunk. Its ``thresh``/``resume``
modes are the tail compaction: a block stops once fewer than
``thresh = tail_frac * BLOCK`` of its lanes are alive, writes the in-flight
state ([12, N]: state rows 0..9, sample, depth), and a continuation launch
over the packed survivors resumes it. Its ``replay`` mode (the regenerating
training path's forward) also writes one residual slot per live iteration
of a lane, ``[S*nb, 13, N]``: the input org/dir/beta, the winner (t, packed
index), the sample and the depth; a lane's slots are exactly ``j < cnt``.
Replay runs without tail compaction, as in the JAX package, and culls its
search by a ``PackedSceneStream``'s window boxes (the kernel needs them;
the plain version also takes a ``PackedSceneFused`` and scans every
triangle), which keeps every output bit-equal.
Its resident mode (no ``replay``, no ``stream``) searches with a scan of
the whole scene per lane when the scene is one 64-row chunk whose tables
fit 48 KB of shared memory (``csrc/megakernel.cu: flat_fits``: they are
staged there) and otherwise with the culled warp search over a
``PackedSceneStream``'s window boxes, as replay does. On the card K4 takes
a ``PackedSceneStream`` in every mode; the plain version also takes a
``PackedSceneFused`` and scans every triangle. Its
``stream`` mode, for scenes above the measured resident range
(``scene_fits_resident``), takes the triangle search K6
(``_stream_tri`` in the JAX package; ``csrc/stream_tri.cuh``): the table is
cut into windows of ``window`` triangles with one box each and one level-1
box per ``fan`` windows (``PackedSceneStream``), and a block stages in
shared memory, window by window, only the windows one of its rays can still
win in, spreading the voting rays' tests over the whole block. It composes
with the tail compaction, not with ``replay``, and equals the resident
launch bit for bit.

K10 ``bounce_step`` replaces ``_bounce_kernel`` / ``_run_bounce`` /
``bounce_step``: one bounce of the compacting wavefront
(models/integrator.trace_passes_compact) on a [13, N] state whose rows
10..12 carry the radiance, with the unpacked winner and table uniforms
(``csrc/bounce_step.cu``). Its searches are K2's (the one-chunk scan from
shared memory, or the culled warp search over any pack's window boxes), and
a wholly dead warp, as every warp past the compacted live prefix is, skips
the search and copies its columns through.

Design on the H100 (``csrc/megakernel.cu``): one thread per lane, the path
state in registers, the scene and attribute tables in global memory behind
the read-only cache (``[T, 30]`` and ``[S, 12]`` float32 rows: a winner's
attributes are one indexed row load), or, for K4 and K5 on a one-chunk
scene, in shared memory. A refill is one strided load of the sample's ten
state rows ``state0[(s*10 + r)*N + lane]``. The kernels are bound by FP32
operations in the per-bounce winner search; the bytes they must move
(state tables in, radiance and counts out) are small next to that. Without
tail compaction K4's and K5's threads take their lanes from a queue
(persistent blocks; a thread whose lane is exhausted takes the next lane of
the launch), so a warp does not idle behind its longest lane; with tail
compaction, and in the stream mode, the loop is block-synchronous
(``__syncthreads_count`` of the live lanes).

K7 ``fused_bounces`` replaces ``_megakernel`` / ``_run_fused`` /
``fused_bounces``: the ``nb`` bounces of ONE sample pass per lane with table
uniforms ``[4*nb, N]`` and, ``with_residuals``, the path-replay residuals
(each bounce's input state and winner) that the training path's backward
replays (``csrc/fused_bounces.cu``). K8 ``bounce_bwd_step`` replaces
``_bounce_bwd_kernel`` / ``_bounce_bwd_body`` / ``_run_bounce_bwd`` /
``bounce_bwd_step``: the VJP of one replayed bounce. The JAX kernel's body
is ``jax.vjp`` of the bounce; the CUDA kernel's is the same derivative
written by hand in reverse mode (``csrc/replay.cuh``), and its material
gradient is summed over lanes without float atomics, in a fixed order, in
one launch (``csrc/bounce_bwd.cu``, ``csrc/grad_reduce.cuh``): a persistent grid
whose last block to finish sums the blocks' partials. A lane reads by class
(dead: its alive row, winner t, beta and cotangents, staged ahead in shared
memory; a hit also the rest of its input). Its plain version is
``torch.func.vjp`` of the same function with the same guards.

K9 ``regen_replay_bwd`` replaces ``_regen_replay_bwd_kernel`` /
``_run_regen_replay_bwd`` / ``regen_replay_bwd``: the reverse walk over K4's
replay residuals, one lane per thread (``csrc/regen_replay_bwd.cu``). Per
slot, from the lane's last to its first: a sample change zeroes the state
cotangent, the uniforms are redrawn with K1 from (lane, sample, depth), K8's
adjoint runs at the saved state and winner, and at depth 1 the input-state
cotangent is the sample's ``d_state0``. Its plain version runs the same walk
on whole [*, N] tensors through ``bounce_bwd_plain``.

Beside each kernel is its plain PyTorch version on whole [*, N] tensors
(masked loop iterations, like the Pallas body); the wrappers take it only
for CPU tensors.

Each public wrapper is a span of ``utils/tracing``, timed on the device:
``pt3.k4`` (``fused_passes_krng`` and ``fused_passes``), ``pt3.k7``
(``fused_bounces``), ``pt3.k8`` (``bounce_bwd_step``), ``pt3.k9``
(``regen_replay_bwd``) and ``pt3.k10`` (``bounce_step``).
"""

from __future__ import annotations

import copy
import math

import torch

from ..utils import tracing
from . import _cuda
from . import kernel_rng as kr
from .intersect_kernel import (  # noqa: F401 (WBOX_MARGIN: the tests read it here)
    TC,
    WBOX_MARGIN,
    WINDOW,
    WINDOW_FAN,
    PackedScene,
    chunk_min_plain,
    sphere_search_plain,
    winner_search_plain,
)
from .vecmath import fcos, fsin, fsqrt

S_COUNT_MAX = 64  # the K4 alive bitmask is two 32-bit words
EPSILON = 1e-9  # reference Epsilon (cone mirror early-out, Samples.cpp:9)
BLOCK = 128  # lanes per CUDA block (and per tail-compaction tile)
TRI_ATTR = 30  # woop 12, vertex normals 9, emission 3, diffuse 3, ior, refl, cone
SPH_ATTR = 12  # centre 3, emission 3, diffuse 3, ior, refl, cone
_M32 = 0xFFFFFFFF

WOOP_ROW_BYTES = 48
# A placeholder, not a crossover: the largest mesh on which K4's resident
# mode (the culled warp search) and its stream mode (K6) were timed against
# each other on the H100 (suzanne-sub6, chip_smoke.py --crossover). The
# resident mode took 0.20-0.64x the stream mode's time at every size from
# 38 triangles up to this one, the gap growing with size (PERF.md), so no
# measured scene is faster streamed. Larger scenes take the stream mode
# unmeasured (ROADMAP: find where K6 wins, or drop the render's stream route).
RESIDENT_MAX_TRIANGLES = 3_973_120


class PackedSceneFused(PackedScene):
    """PackedScene + per-primitive attribute rows for the megakernels:
    ``tri_attr`` [T, 30] and ``sph_attr`` [S, 12] float32, in the column
    order of the JAX package's ``tri_coef``/``sph_coef`` rows; for the
    training kernels also each primitive's material id (``tri_mat``,
    ``sph_mat``) and the material table as ``mat9`` [M, 9] (emission 3,
    diffuse 3, ior, reflectivity, cone angle).

    The tables are kernel inputs and never differentiated through: they are
    built from detached materials, so a training step's material gradient
    comes only from the kernels' backward (K8) and never twice.

    ``with_materials`` gives a copy for other materials that shares every
    geometry table (a training step's materials change, its geometry does
    not)."""

    def __init__(self, scene, window: int = WINDOW, fan: int = WINDOW_FAN):
        super().__init__(scene, window, fan)
        dev = scene.device
        f32 = torch.float32

        def ids(mid):
            if mid.numel() == 0:
                return torch.zeros((1,), dtype=torch.int32, device=dev)
            return mid.to(torch.int32).contiguous()

        self.tri_mat = ids(scene.triangles.mat_id)
        self.sph_mat = ids(scene.spheres.mat_id)
        # the geometry columns of the attribute rows (Woop rows and vertex
        # normals; sphere centres); _set_materials appends the material rows
        if self.n_tri:
            tri = scene.triangles
            self._tri_geo = torch.cat([tri.woop.to(f32).reshape(self.n_tri, 12),
                                       tri.normals.to(f32).reshape(self.n_tri, 9)], dim=1)
        if self.n_sph:
            self._sph_geo = scene.spheres.centre.to(f32)
        self._set_materials(scene.materials, scene.environment)

    def _set_materials(self, materials, environment):
        mats = type(materials)(*(m.detach() for m in materials))
        dev = self.tri_mat.device
        f32 = torch.float32
        cone = mats.cone_angle
        self.mat9 = torch.cat(
            [mats.emission.to(f32), mats.diffuse.to(f32), mats.ior.to(f32)[:, None],
             mats.reflectivity.to(f32)[:, None], mats.cone_angle.to(f32)[:, None]],
            dim=1,
        ).contiguous()
        self.n_mat = int(self.mat9.shape[0])
        if self.n_tri:
            self.tri_attr = torch.cat([self._tri_geo, self.mat9[self.tri_mat.long()]],
                                      dim=1).contiguous()
        else:
            self.tri_attr = torch.zeros((1, TRI_ATTR), dtype=f32, device=dev)
        if self.n_sph:
            self.sph_attr = torch.cat([self._sph_geo, self.mat9[self.sph_mat.long()]],
                                      dim=1).contiguous()
        else:
            self.sph_attr = torch.zeros((1, SPH_ATTR), dtype=f32, device=dev)
        self.environment = environment.detach().to(f32)
        # the launches pass the environment by value: read once here, not
        # (with a device-to-host copy and its wait) at every launch
        with tracing.span("pt3.sync.materials"):
            self.no_glossy = bool(cone.numel() == 0 or float(cone.max()) < EPSILON)
            self.env_host = tuple(float(x) for x in self.environment.tolist())

    def with_materials(self, materials, environment):
        """This pack for ``materials`` and ``environment``: the geometry
        tables (Woop rows, boxes, windows, normals, sphere rows) are shared,
        the material rows, ``mat9``, ``no_glossy`` and the environment built
        anew, exactly as a new pack of the same scene with these materials
        would build them."""
        new = copy.copy(self)
        new._set_materials(materials, environment)
        return new


def scene_fits_resident(scene) -> bool:
    """True when K4 runs in its resident mode on this scene: at most
    ``RESIDENT_MAX_TRIANGLES`` triangles, the measured range in which its
    culled warp search beat the stream mode (K6) at every size. Larger
    scenes take the stream mode; that bound is a placeholder (the largest
    mesh measured), not a crossover. The same rule on the CPU, so CPU runs route
    as the card does."""
    return scene.num_triangles <= RESIDENT_MAX_TRIANGLES


class PackedSceneStream(PackedSceneFused):
    """PackedSceneFused + K6's window rows (the port of the JAX package's
    ``PackedSceneStream``): ``tri_win`` [n_windows * window, 12], the
    Morton-ordered Woop rows with all-zero padding rows (rejected as
    parallel), read window by window beside the pack's window boxes
    (``wbox``, ``wbox1``: ``PackedScene``; the same boxes cull K4's resident
    and replay modes, K7 and K2). The winner's attribute row stays one
    indexed load from ``tri_attr``: the TPU kernel's 128-column table and
    in-loop attribute capture are not needed."""

    def __init__(self, scene, window: int = WINDOW, fan: int = WINDOW_FAN):
        super().__init__(scene, window, fan)
        self.tri_win = torch.zeros((self.n_windows * self.window, 12), dtype=torch.float32,
                                   device=scene.device)
        self.tri_win[:self.n_tri] = self.tri_tab[:self.n_tri]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _normalise3(x, y, z):
    inv = 1.0 / fsqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x * inv, y * inv, z * inv


def _onb_from_z(zx, zy, zz):
    """OrthoNormalBasis::fromZ with the 0.9999 coincident guard."""
    use_y = torch.abs(zx) > 0.9999
    one = torch.ones_like(zx)
    zero = torch.zeros_like(zx)
    px = torch.where(use_y, zero, one)
    py = torch.where(use_y, one, zero)
    xx_ = py * zz
    xy_ = -px * zz
    xz_ = px * zy - py * zx
    xx_, xy_, xz_ = _normalise3(xx_, xy_, xz_)
    yx_ = zy * xz_ - zz * xy_
    yy_ = zz * xx_ - zx * xz_
    yz_ = zx * xy_ - zy * xx_
    yx_, yy_, yz_ = _normalise3(yx_, yy_, yz_)
    return (xx_, xy_, xz_), (yx_, yy_, yz_)


def _shade_plain(pk: PackedSceneFused, st, acc, t, idx, hit, u, acos_u, v, p,
                 no_glossy: bool):
    """One shading event for the ``hit`` lanes (``shade`` in
    csrc/pt3_device.cuh); other lanes keep their state. Updates ``st``
    rows 0..9 and ``acc`` in place; returns the lanes whose event is
    specular (the mirror or cone direction)."""
    ox, oy, oz, dx, dy, dz, bx, by, bz = (st[r] for r in range(9))
    n_tri, n_sph = pk.n_tri, pk.n_sph
    tri_win = hit & (idx < n_tri)
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    px_ = ox + t_safe * dx
    py_ = oy + t_safe * dy
    pz_ = oz + t_safe * dz
    if n_tri > 0:
        a = pk.tri_attr[torch.clamp(idx, 0, n_tri - 1).long()].T  # [30, N]
        o_u = a[0] * ox + a[1] * oy + a[2] * oz + a[3]
        o_v = a[4] * ox + a[5] * oy + a[6] * oz + a[7]
        d_u = a[0] * dx + a[1] * dy + a[2] * dz
        d_v = a[4] * dx + a[5] * dy + a[6] * dz
        d_w = a[8] * dx + a[9] * dy + a[10] * dz
        uu = o_u + t * d_u
        vv = o_v + t * d_v
        inx = a[12] + uu * (a[15] - a[12]) + vv * (a[18] - a[12])
        iny = a[13] + uu * (a[16] - a[13]) + vv * (a[19] - a[13])
        inz = a[14] + uu * (a[17] - a[14]) + vv * (a[20] - a[14])
        inx, iny, inz = _normalise3(inx, iny, inz)
        backface = d_w > 0.0
        flip = torch.where(backface, -torch.ones_like(inx), torch.ones_like(inx))
        tri_vals = (inx * flip, iny * flip, inz * flip, a[21], a[22], a[23],
                    a[24], a[25], a[26], a[27], a[28], a[29])
        t_inside = backface
    if n_sph > 0:
        a = pk.sph_attr[torch.clamp(idx - n_tri, 0, n_sph - 1).long()].T  # [12, N]
        snx, sny, snz = _normalise3(px_ - a[0], py_ - a[1], pz_ - a[2])
        s_inside = snx * dx + sny * dy + snz * dz > 0.0
        flip = torch.where(s_inside, -torch.ones_like(snx), torch.ones_like(snx))
        sph_vals = (snx * flip, sny * flip, snz * flip, a[3], a[4], a[5],
                    a[6], a[7], a[8], a[9], a[10], a[11])
    if n_tri > 0 and n_sph > 0:
        vals = tuple(torch.where(tri_win, tv, sv) for tv, sv in zip(tri_vals, sph_vals))
        inside = torch.where(tri_win, t_inside, s_inside)
    elif n_tri > 0:
        vals, inside = tri_vals, t_inside
    else:
        vals, inside = sph_vals, s_inside
    nx, ny, nz, emr, emg, emb, dir_, dig, dib, ior, refl0, cone = vals

    zero = torch.zeros_like(bx)
    acc[0] += torch.where(hit, bx * emr, zero)
    acc[1] += torch.where(hit, by * emg, zero)
    acc[2] += torch.where(hit, bz * emb, zero)

    one = torch.ones_like(ior)
    ior_from = torch.where(inside, ior, one)
    ior_to = torch.where(inside, one, ior)
    ratio = ior_from / ior_to
    cos_i = -(dx * nx + dy * ny + dz * nz)
    sin_t_sq = ratio * ratio * (1.0 - cos_i * cos_i)
    cos_t = fsqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
    den_f = ior_from * cos_i + ior_to * cos_t
    ok_f = den_f > 0.0
    r_perp = torch.where(
        ok_f, (ior_from * cos_i - ior_to * cos_t) / torch.where(ok_f, den_f, one), one
    )
    fresnel = torch.where(sin_t_sq > 1.0, one, r_perp * r_perp)
    refl = torch.where(refl0 < 0.0, fresnel, refl0)
    spec = p < refl

    rdot = 2.0 * (dx * nx + dy * ny + dz * nz)
    rx, ry, rz = dx - nx * rdot, dy - ny * rdot, dz - nz * rdot
    if no_glossy:
        conex, coney, conez = rx, ry, rz
    else:
        theta = cone * (1.0 - 2.0 * acos_u / math.pi)
        cradius = fsin(theta)
        cz_scale = fcos(theta)
        rth = v * (2.0 * math.pi)
        (cxx, cxy, cxz), (cyx, cyy, cyz) = _onb_from_z(rx, ry, rz)
        lx = fcos(rth) * cradius
        ly = fsin(rth) * cradius
        sx = cxx * lx + cyx * ly + rx * cz_scale
        sy = cxy * lx + cyy * ly + ry * cz_scale
        sz = cxz * lx + cyz * ly + rz * cz_scale
        sx, sy, sz = _normalise3(sx, sy, sz)
        mirror = cone < EPSILON
        conex = torch.where(mirror, rx, sx)
        coney = torch.where(mirror, ry, sy)
        conez = torch.where(mirror, rz, sz)

    (hxx, hxy, hxz), (hyx, hyy, hyz) = _onb_from_z(nx, ny, nz)
    hth = (2.0 * math.pi) * u
    hr = fsqrt(torch.clamp(v, min=0.0))
    hlx = fcos(hth) * hr
    hly = fsin(hth) * hr
    hlz = fsqrt(torch.clamp(1.0 - v, min=0.0))
    hx = hxx * hlx + hyx * hly + nx * hlz
    hy = hxy * hlx + hyy * hly + ny * hlz
    hz = hxz * hlx + hyz * hly + nz * hlz
    hx, hy, hz = _normalise3(hx, hy, hz)

    ndx = torch.where(spec, conex, hx)
    ndy = torch.where(spec, coney, hy)
    ndz = torch.where(spec, conez, hz)
    nbx = torch.where(spec, bx, bx * dir_)
    nby = torch.where(spec, by, by * dig)
    nbz = torch.where(spec, bz, bz * dib)
    alive_next = hit & ((nbx != 0.0) | (nby != 0.0) | (nbz != 0.0))
    new = (px_, py_, pz_, ndx, ndy, ndz, nbx, nby, nbz)
    for r in range(9):
        st[r] = torch.where(hit, new[r], st[r])
    st[9] = torch.where(hit, alive_next.to(st.dtype), st[9])
    return hit & spec


def _safe_recip(d):
    return 1.0 / torch.where(d.abs() > 1e-20, d, torch.full_like(d, 1e-20))


def window_enter_plain(box, org, inv_d, best_t, eps: float, packed_winner: bool = True):
    """K6's window test (``stream_tri.cuh: window_enter``) for every ray:
    can its winner still come from inside ``box`` (lo3 hi3)? With the
    packed winner the box entry is compared with the top of best_t's
    packing bucket (its bits | 63), so a triangle the packed winner would
    prefer to a sphere is never skipped; unpacked, a triangle must be
    strictly nearer than best_t, so an entry at or beyond it is skipped."""
    t0 = (box[0:3, None] - org) * inv_d
    t1 = (box[3:6, None] - org) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=0)
    tmax = torch.maximum(t0, t1).amin(dim=0)
    inside = tmax >= torch.clamp(tmin, min=eps)
    if not packed_winner:
        return inside & (tmin < best_t)
    bucket = (best_t > 0.0) & torch.isfinite(best_t)
    top = torch.where(bucket, (best_t.view(torch.int32) | 63).view(torch.float32), best_t)
    return inside & (tmin <= top)


def stream_search_plain(pk: PackedSceneStream, org, dirn, active, eps: float,
                        packed_winner: bool = True):
    """Plain version of K6's search with the packed winner (and of the
    culled warp search of K4's resident and replay modes, which walks the
    same boxes; with ``packed_winner=False``, of K7's): the spheres, then
    the level-1 boxes in order and, inside each one a ray enters, its
    windows in order; a ray scans a window's chunks only where
    ``window_enter_plain`` says its winner can still lie in the window's
    box (K6's block scans a window for the rays that voted for it, the
    culled search's warp for its lanes that entered it). Chunk boundaries
    and arithmetic are the resident scan's, so the winners are bit-equal to
    ``winner_search_plain(..., packed_winner=packed_winner)``. Returns
    (best_t, best_i) as it does.

    Each test is per ray, so only the active rays are tested, a group's
    windows only against the rays that enter the group, and a window's
    chunks only against the rays that enter the window."""
    best_t, best_i = sphere_search_plain(pk, org, dirn, active, eps)
    n_tri, tc = pk.n_tri, pk.chunk_rows
    if n_tri == 0:
        return best_t, best_i
    lanes = active.nonzero()[:, 0]
    org, dirn = org[:, lanes], dirn[:, lanes]
    bt, bi = best_t[lanes], best_i[lanes]
    inv_d = _safe_recip(dirn)
    for g in range(pk.n_groups):
        sg = window_enter_plain(pk.wbox1[g], org, inv_d, bt, eps, packed_winner).nonzero()[:, 0]
        if sg.numel() == 0:
            continue
        og, dg, ig = org[:, sg], dirn[:, sg], inv_d[:, sg]
        tg, jg = bt[sg], bi[sg]
        for w in range(g * pk.fan, min((g + 1) * pk.fan, pk.n_windows)):
            sel = window_enter_plain(pk.wbox[w], og, ig, tg, eps, packed_winner).nonzero()[:, 0]
            if sel.numel() == 0:
                continue
            o, d = og[:, sel], dg[:, sel]
            t_w, i_w = tg[sel], jg[sel]
            base = w * pk.window
            rows = min(pk.window, n_tri - base)
            for c in range(0, rows, tc):
                first = base + c
                ct, ci = chunk_min_plain(pk.tri_win[first:first + min(tc, rows - c)], first,
                                         o, d, eps, packed_winner)
                take = ct < t_w
                i_w = torch.where(take, ci, i_w)
                t_w = torch.where(take, ct, t_w)
            tg[sel], jg[sel] = t_w, i_w
        bt[sg], bi[sg] = tg, jg
    best_t[lanes], best_i[lanes] = bt, bi
    return best_t, best_i


def _bounce_common(pk, st, acc, cnt, active, packed_winner, eps, stream=False):
    """Winner search + environment on miss for the ``active`` lanes; every
    active lane dies unless the shading that follows revives it."""
    cnt += active.to(torch.int32)
    if stream:
        t, idx = stream_search_plain(pk, st[0:3], st[3:6], active, eps)
    else:
        t, idx = winner_search_plain(pk, st[0:3], st[3:6], active, eps,
                                     packed_winner=packed_winner)
    hit = active & torch.isfinite(t) & (t > 0.0)
    miss = active & ~hit
    env = pk.environment
    for c in range(3):
        acc[c] += torch.where(miss, st[6 + c] * env[c], torch.zeros_like(acc[c]))
    st[9] = torch.where(active, torch.zeros_like(st[9]), st[9])
    return t, idx, hit


def fused_passes_plain(pk: PackedSceneFused, state0, nexta, unif, eps: float,
                       nb: int, s_count: int):
    """Plain version of K5. state0 [S*10, N], nexta [S+1, N] int, unif
    [S*nb, N, 4]: a lane's (u, acos u, v, p) per (sample, depth). Returns
    (acc [3, N], cnt [N] int32)."""
    n = state0.shape[1]
    dev = state0.device
    lanes = torch.arange(n, device=dev)
    s0 = state0.reshape(s_count, 10, n)
    st = torch.zeros((10, n), dtype=torch.float32, device=dev)
    acc = torch.zeros((3, n), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    s_cur = torch.zeros((n,), dtype=torch.int64, device=dev)
    d_cur = torch.zeros((n,), dtype=torch.int64, device=dev)

    def load(can, s_next):
        pick = s0[torch.clamp(s_next, 0, s_count - 1), :, lanes].T  # [10, N]
        st.copy_(torch.where(can[None, :], pick, st))

    s_next = nexta[0].long()
    can = s_next < s_count
    load(can, s_next)
    s_cur = torch.where(can, s_next, s_cur)
    d_cur = torch.where(can, torch.ones_like(d_cur), d_cur)
    st[9] = torch.where(can, st[9], torch.zeros_like(st[9]))

    it = 0
    while it < s_count * (nb + 1):
        active = st[9] != 0.0
        if not bool(active.any()):
            break
        t, idx, hit = _bounce_common(pk, st, acc, cnt, active, False, eps)
        row = (torch.clamp(s_cur, 0, s_count - 1) * nb
               + torch.clamp(d_cur - 1, 0, max(nb - 1, 0)))
        u, au, v, p = unif[row, lanes].T
        _shade_plain(pk, st, acc, t, idx, hit, u, au, v, p, pk.no_glossy)
        d_cur = torch.where(hit, d_cur + 1, d_cur)
        st[9] = torch.where(d_cur > nb, torch.zeros_like(st[9]), st[9])
        want = st[9] == 0.0
        s_next = nexta[torch.clamp(s_cur + 1, 0, s_count), lanes].long()
        can = want & (s_next < s_count)
        load(can, s_next)
        s_cur = torch.where(can, s_next, s_cur)
        d_cur = torch.where(can, torch.ones_like(d_cur), d_cur)
        it += 1
    return acc, cnt


def _lsb_index(x):
    """Index of the lowest set bit of uint32 values (int64); x != 0."""
    low = x & (-x)
    return torch.log2(low.to(torch.float64)).to(torch.int64)


def _next_alive(amask, s_cur, s_count: int, first: bool):
    am_lo, am_hi = amask[0], amask[1]
    if first:
        rem_lo, rem_hi = am_lo, am_hi
        base_lo = torch.zeros_like(s_cur)
        base_hi = torch.full_like(s_cur, 32)
    else:
        in_lo = s_cur < 32
        sh_lo = torch.clamp(s_cur, max=31)
        rem_lo = torch.where(in_lo, (am_lo >> sh_lo) >> 1, torch.zeros_like(am_lo))
        sh_hi = torch.clamp(s_cur - 32, 0, 31)
        rem_hi = torch.where(in_lo, am_hi, (am_hi >> sh_hi) >> 1)
        base_lo = s_cur + 1
        base_hi = torch.where(in_lo, torch.full_like(s_cur, 32), s_cur + 1)
    nz_lo = rem_lo != 0
    nz_hi = rem_hi != 0
    one = torch.ones_like(rem_lo)
    s_lo = base_lo + _lsb_index(torch.where(nz_lo, rem_lo, one))
    s_hi = base_hi + _lsb_index(torch.where(nz_hi, rem_hi, one))
    return torch.where(nz_lo, s_lo, torch.where(nz_hi, s_hi, torch.full_like(s_lo, s_count)))


def regen_krng_plain(pk: PackedSceneFused, lane_ids, amask, state0, resid_in,
                     seeds, sample0: int, eps: float, nb: int, s_count: int,
                     thresh: int = 0, no_glossy: bool = False, block: int = BLOCK,
                     rres: torch.Tensor | None = None, stream: bool = False):
    """Plain version of one K4 launch. lane_ids [N] int, amask [2, N] uint32
    words (int64), state0 [S*10, N] sample-major, resid_in [12, N] or None
    (resume), seeds: three uint32 ints. With ``thresh`` > 0, N is a multiple
    of ``block`` and each block of lanes stops once fewer than ``thresh`` of
    its lanes are alive. ``stream`` (``pk`` a PackedSceneStream) searches
    the triangles window by window (``stream_search_plain``): the same
    winners, so the same outputs. With ``rres`` [S*nb, 13, N0] (no
    ``thresh``, no ``resid_in``) the launch also writes the replay
    residuals in place (slot j of lane i: the input org3 dir3 beta3 of its
    j-th live iteration, the winner t (+inf on a miss), its packed index (0
    on a miss), the sample and the depth); with ``pk`` a PackedSceneStream
    the replay search is culled by its boxes (``stream_search_plain``: the
    same winners). Returns (acc [3, N], cnt [N] int32, resid_out [12, N] or
    None)."""
    n = state0.shape[1]
    dev = state0.device
    lanes = torch.arange(n, device=dev)
    s0 = state0.reshape(s_count, 10, n)
    acc = torch.zeros((3, n), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    hlane = kr.mul32(lane_ids.to(torch.int64) & _M32, kr._IN_P1)
    amask = amask.to(torch.int64) & _M32
    seeds_col = torch.tensor(seeds, dtype=torch.int64, device=dev).reshape(3, 1)
    culled = stream or (rres is not None and isinstance(pk, PackedSceneStream))

    def refill(first: bool):
        nonlocal s_cur, d_cur, sdt
        if first:
            want = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            want = (st[9] == 0.0) & (s_cur < s_count)
        s_next = _next_alive(amask, s_cur, s_count, first)
        can = want & (s_next < s_count)
        pick = s0[torch.clamp(s_next, 0, s_count - 1), :, lanes].T
        st.copy_(torch.where(can[None, :], pick, st))
        s_cur = torch.where(want, s_next, s_cur)
        d_cur = torch.where(can, torch.ones_like(d_cur), d_cur)
        sdt = torch.where(can, kr.sd_term(sample0, s_next, 1), sdt)

    if resid_in is not None:
        st = resid_in[0:10].clone()
        s_cur = resid_in[10].to(torch.int64)
        d_cur = resid_in[11].to(torch.int64)
        sdt = kr.sd_term(sample0, s_cur, d_cur)
    else:
        st = torch.zeros((10, n), dtype=torch.float32, device=dev)
        s_cur = torch.zeros((n,), dtype=torch.int64, device=dev)
        d_cur = torch.zeros((n,), dtype=torch.int64, device=dev)
        sdt = torch.zeros((n,), dtype=torch.int64, device=dev)
        refill(first=True)

    it = 0
    # a sample takes at most nb iterations: S*nb replay slots suffice
    while it < (s_count * nb if rres is not None else s_count * (nb + 1)):
        alive = st[9] != 0.0
        if thresh:
            tile_live = alive.reshape(-1, block).sum(dim=1)
            running = (tile_live >= max(thresh, 1)).repeat_interleave(block)
            active = alive & running
        else:
            active = alive
        if not bool(active.any()):
            break
        slot_j = cnt.long()  # a live lane's slot is its iteration count
        t, idx, hit = _bounce_common(pk, st, acc, cnt, active, True, eps, culled)
        if rres is not None:
            slot = torch.cat([st[0:9], torch.where(hit, t, torch.full_like(t, math.inf))[None],
                              torch.where(hit, idx, torch.zeros_like(idx)).to(torch.float32)[None],
                              s_cur.to(torch.float32)[None], d_cur.to(torch.float32)[None]])
            rres[slot_j[active], :, lanes[active]] = slot[:, active].T
        u, v, p = kr.event_uniforms_premixed(((hlane + sdt) & _M32)[None, :], seeds_col)
        au = u if no_glossy else kr.acos01(u)
        _shade_plain(pk, st, acc, t, idx, hit, u, au, v, p, no_glossy)
        d_cur = torch.where(hit, d_cur + 1, d_cur)
        sdt = torch.where(hit, (sdt + kr._IN_P2) & _M32, sdt)
        st[9] = torch.where(d_cur > nb, torch.zeros_like(st[9]), st[9])
        # a stopped block's lanes are alive or exhausted: refill skips them
        refill(first=False)
        it += 1
    resid = None
    if thresh:
        resid = torch.cat([st, s_cur.to(torch.float32)[None], d_cur.to(torch.float32)[None]])
    return acc, cnt, resid


def fused_bounces_plain(pk: PackedSceneFused, org, dirn, beta, alive, unif,
                        eps: float, nb: int, with_residuals: bool = False):
    """Plain version of K7: ``nb`` bounces of every lane with table uniforms
    ``unif`` [4*nb, N] (u, acos u, v, p per bounce). Returns (acc [3, N],
    cnt [N] int32) and, ``with_residuals``, each bounce's input state
    [13*nb, N] (org3 dir3 beta3 alive1 acc3) and winner (t [nb, N], +inf on
    a miss; idx [nb, N], 0 on a miss)."""
    n = org.shape[1]
    dev = org.device
    st = torch.cat([org, dirn, beta, alive.to(torch.float32)[None, :]]).to(torch.float32)
    acc = torch.zeros((3, n), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    states, ts, idxs = [], [], []
    for d in range(nb):
        if with_residuals:
            states.append(torch.cat([st, acc]))
        active = st[9] != 0.0
        t, idx, hit = _bounce_common(pk, st, acc, cnt, active, False, eps)
        if with_residuals:
            ts.append(torch.where(hit, t, torch.full_like(t, float("inf"))))
            idxs.append(torch.where(hit, idx, torch.zeros_like(idx)))
        u, au, v, p = (unif[4 * d + k] for k in range(4))
        _shade_plain(pk, st, acc, t, idx, hit, u, au, v, p, pk.no_glossy)
    if not with_residuals:
        return acc, cnt
    return acc, cnt, torch.cat(states), torch.stack(ts), torch.stack(idxs)


def _bounce_fn(pk: PackedSceneFused, state, t, idx, unif):
    """(f, t_c, hit, g, mid) for the plain K8: f(st, m, env, t) is the
    output state [13, N] of one bounce from the saved input state, as the
    JAX package's _bounce_bwd_body writes it for jax.vjp, guards included;
    m [9, N] is each lane's winner material row (``mat9[mid].T``) and env
    [3, N] the environment per lane, so the VJP gives per-lane material and
    environment gradients."""
    n_tri, n_sph = pk.n_tri, pk.n_sph
    alive = state[9] != 0.0
    hit = alive & torch.isfinite(t) & (t > 0.0)
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)
    t_c = torch.where(hit, t, zero)
    tri_win = hit & (idx < n_tri)
    sph_win = hit & ~tri_win
    i_t = torch.where(tri_win, idx, torch.zeros_like(idx)).long()
    i_s = torch.where(sph_win, idx - n_tri, torch.zeros_like(idx)).long()
    geo_t = pk.tri_attr[i_t, :21].T if n_tri else None  # woop 12, normals 9
    geo_s = pk.sph_attr[i_s, :3].T if n_sph else None  # centre
    mid = torch.zeros_like(i_t)
    if n_tri:
        mid = torch.where(tri_win, pk.tri_mat.long()[i_t], mid)
    if n_sph:
        mid = torch.where(sph_win, pk.sph_mat.long()[i_s], mid)
    u, acos_u, v, p_ev = unif[0], unif[1], unif[2], unif[3]
    mf = (alive & ~hit).to(torch.float32)
    hf = hit.to(torch.float32)

    def unit_where(cond, x, y, z):
        return torch.where(cond, x, one), torch.where(cond, y, zero), torch.where(cond, z, zero)

    def f(st, m_lane, env, tt):
        ox, oy, oz, dx, dy, dz, bx, by, bz = (st[r] for r in range(9))
        acc0 = st[10] + mf * bx * env[0]
        acc1 = st[11] + mf * by * env[1]
        acc2 = st[12] + mf * bz * env[2]
        px_ = ox + tt * dx
        py_ = oy + tt * dy
        pz_ = oz + tt * dz
        if n_tri:
            a = geo_t
            o_u = a[0] * ox + a[1] * oy + a[2] * oz + a[3]
            o_v = a[4] * ox + a[5] * oy + a[6] * oz + a[7]
            d_u = a[0] * dx + a[1] * dy + a[2] * dz
            d_v = a[4] * dx + a[5] * dy + a[6] * dz
            d_w = a[8] * dx + a[9] * dy + a[10] * dz
            uu = o_u + tt * d_u
            vv = o_v + tt * d_v
            inx = a[12] + uu * (a[15] - a[12]) + vv * (a[18] - a[12])
            iny = a[13] + uu * (a[16] - a[13]) + vv * (a[19] - a[13])
            inz = a[14] + uu * (a[17] - a[14]) + vv * (a[20] - a[14])
            # normalise(0) has infinite partials: a unit vector where untaken
            inx, iny, inz = _normalise3(*unit_where(tri_win, inx, iny, inz))
            flip_t = torch.where(d_w > 0.0, -one, one)
            tn = (inx * flip_t, iny * flip_t, inz * flip_t)
            t_inside = d_w > 0.0
        if n_sph:
            c = geo_s
            snx, sny, snz = _normalise3(*unit_where(sph_win, px_ - c[0], py_ - c[1], pz_ - c[2]))
            s_inside = snx * dx + sny * dy + snz * dz > 0.0
            flip_s = torch.where(s_inside, -one, one)
            sn = (snx * flip_s, sny * flip_s, snz * flip_s)
        if n_tri and n_sph:
            nx, ny, nz = (torch.where(tri_win, tn[k], sn[k]) for k in range(3))
            inside = (tri_win & t_inside) | (~tri_win & s_inside)
        elif n_tri:
            (nx, ny, nz), inside = tn, t_inside
        else:
            (nx, ny, nz), inside = sn, s_inside
        m = torch.where(hit[None, :], m_lane, torch.zeros((9, 1), device=st.device))
        emr, emg, emb, dir_, dig, dib, ior, refl0, cone = m
        ior = torch.where(hit, ior, one)  # no 0/0 on lanes without a winner
        acc0 = acc0 + hf * bx * emr
        acc1 = acc1 + hf * by * emg
        acc2 = acc2 + hf * bz * emb

        ior_from = torch.where(inside, ior, one)
        ior_to = torch.where(inside, one, ior)
        ratio = ior_from / ior_to
        cos_i = torch.where(hit, -(dx * nx + dy * ny + dz * nz), one)
        sin_t_sq = ratio * ratio * (1.0 - cos_i * cos_i)
        # double-where sqrt: sqrt'(0) = inf stays out of the untaken branch
        ct_pos = 1.0 - sin_t_sq > 0.0
        cos_t = torch.where(ct_pos, fsqrt(torch.where(ct_pos, 1.0 - sin_t_sq, one)), zero)
        den_f = ior_from * cos_i + ior_to * cos_t
        ok_f = den_f > 0.0
        r_perp = torch.where(ok_f, (ior_from * cos_i - ior_to * cos_t)
                             / torch.where(ok_f, den_f, one), one)
        fresnel = torch.where(sin_t_sq > 1.0, one, r_perp * r_perp)
        refl = torch.where(refl0 < 0.0, fresnel, refl0)
        spec = p_ev < refl

        rdot = 2.0 * (dx * nx + dy * ny + dz * nz)
        # pad and dead lanes carry d = 0 (r = 0): a unit r where untaken
        rx, ry, rz = unit_where(hit, dx - nx * rdot, dy - ny * rdot, dz - nz * rdot)
        theta = cone * (1.0 - 2.0 * acos_u / math.pi)
        cradius = fsin(theta)
        cz_scale = fcos(theta)
        rth = v * (2.0 * math.pi)
        (cxx, cxy, cxz), (cyx, cyy, cyz) = _onb_from_z(rx, ry, rz)
        lx = fcos(rth) * cradius
        ly = fsin(rth) * cradius
        sx, sy, sz = _normalise3(cxx * lx + cyx * ly + rx * cz_scale,
                                 cxy * lx + cyy * ly + ry * cz_scale,
                                 cxz * lx + cyz * ly + rz * cz_scale)
        mirror = cone < EPSILON
        conex, coney, conez = (torch.where(mirror, a_, b_)
                               for a_, b_ in ((rx, sx), (ry, sy), (rz, sz)))

        (hxx, hxy, hxz), (hyx, hyy, hyz) = _onb_from_z(nx, ny, nz)
        hth = (2.0 * math.pi) * u
        hr = fsqrt(torch.clamp(v, min=0.0))
        hlx = fcos(hth) * hr
        hly = fsin(hth) * hr
        hlz = fsqrt(torch.clamp(1.0 - v, min=0.0))
        hx, hy, hz = _normalise3(hxx * hlx + hyx * hly + nx * hlz,
                                 hxy * hlx + hyy * hly + ny * hlz,
                                 hxz * hlx + hyz * hly + nz * hlz)
        ndx, ndy, ndz = (torch.where(spec, a_, b_)
                         for a_, b_ in ((conex, hx), (coney, hy), (conez, hz)))

        # likelihood-ratio branch weight, primal 1 (integrator.branch_weight)
        refl_hat = refl.detach()
        w = torch.where(spec, refl / torch.clamp(refl_hat, min=1e-12),
                        (1.0 - refl) / torch.clamp(1.0 - refl_hat, min=1e-12))
        sf = spec.to(torch.float32)
        nbx = bx * (sf + (1.0 - sf) * dir_) * w
        nby = by * (sf + (1.0 - sf) * dig) * w
        nbz = bz * (sf + (1.0 - sf) * dib) * w
        rows = [torch.where(hit, a_, b_) for a_, b_ in
                ((px_, ox), (py_, oy), (pz_, oz), (ndx, dx), (ndy, dy), (ndz, dz),
                 (nbx, bx), (nby, by), (nbz, bz))]
        return torch.stack(rows + [zero, acc0, acc1, acc2])

    # the winner's unnormalised geometric normal: the Woop w-row of a
    # triangle, x - c of a sphere
    g_sph = state[0:3] + t_c * state[3:6] - geo_s if n_sph else None
    if n_tri and n_sph:
        g = torch.where(tri_win[None, :], geo_t[8:11], g_sph)
    else:
        g = geo_t[8:11] if n_tri else g_sph
    return f, t_c, hit, g, mid


def _bounce_bwd64(pk: PackedSceneFused, state, t, idx, unif, cot_out):
    """``bounce_bwd_plain`` with the lane sums of the material and
    environment gradients taken in float64 (each lane's terms are the
    float32 adjoint's)."""
    f, t_c, hit, g, mid = _bounce_fn(pk, state, t, idx, unif)
    n = state.shape[1]
    env = pk.environment[:, None].expand(3, n)
    _, vjp = torch.func.vjp(f, state, pk.mat9[mid].T, env, t_c)
    d_st, d_m, d_e, d_t = vjp(cot_out)
    d_mat = torch.zeros((pk.n_mat, 9), dtype=torch.float64, device=state.device)
    d_mat.index_add_(0, mid, d_m.T.to(torch.float64))
    d_env = d_e.to(torch.float64).sum(dim=1)
    # winner distance: dt/do = -g / (g.d), dt/dd = -t g / (g.d)
    dirn = state[3:6]
    gd = g[0] * dirn[0] + g[1] * dirn[1] + g[2] * dirn[2]
    inv = torch.where(gd.abs() > 1e-20, 1.0 / torch.where(gd == 0.0, torch.ones_like(gd), gd),
                      torch.zeros_like(gd))
    scale = torch.where(hit, -d_t * inv, torch.zeros_like(gd))
    d_st = d_st + torch.cat([g * scale, g * scale * t_c, torch.zeros_like(d_st[6:])])
    return d_st, d_mat, d_env


def bounce_bwd_plain(pk: PackedSceneFused, state, t, idx, unif, cot_out):
    """Plain version of K8: ``torch.func.vjp`` of the bounce ``f`` (the JAX
    package's kernel body is ``jax.vjp`` of the same function) at the saved
    input state [13, N], winner (t, idx [N]) and uniforms [4, N], with the
    winner distance's implicit-function-theorem term. Returns (cot_in
    [13, N], d_mat [M, 9] (emission 3, diffuse 3, ior, reflectivity, cone),
    d_env [3]); the sums over lanes are taken in float64, so the kernel's
    float32 sums are held against a reference that does not round."""
    d_st, d_mat, d_env = _bounce_bwd64(pk, state, t, idx, unif, cot_out)
    return d_st, d_mat.to(torch.float32), d_env.to(torch.float32)


def regen_replay_bwd_plain(pk: PackedSceneFused, lane_ids, resid, cnt, acc_bar, seeds,
                           sample0: int, s_count: int):
    """Plain version of K9: every lane walks its replay slots j = cnt-1 ... 0
    (resid [S*nb, 13, N] from K4's replay mode, cnt [N]) with the running
    output-state cotangent, which starts as (0, acc_bar) and loses rows
    0..9 at each sample change; per slot the uniforms come from K1 at
    (lane, sample0 + s, d) and the bounce's adjoint is ``bounce_bwd_plain``
    (a lane past its count runs it as a dead lane: zero state, +inf t).
    Returns (d_state0 [S*10, N] sample-major, zero alive rows; d_mat [M, 9];
    d_env [3]); the material and environment sums over lanes and slots are
    taken in float64."""
    n = acc_bar.shape[1]
    dev = acc_bar.device
    f32 = dict(dtype=torch.float32, device=dev)
    lanes = torch.arange(n, device=dev)
    cnt = cnt.to(torch.int64)
    hlane = kr.mul32(lane_ids.to(torch.int64) & _M32, kr._IN_P1)
    seeds_col = torch.tensor(seeds, dtype=torch.int64, device=dev).reshape(3, 1)
    d0 = torch.zeros((s_count, 10, n), **f32)
    d_mat = torch.zeros((pk.n_mat, 9), dtype=torch.float64, device=dev)
    d_env = torch.zeros((3,), dtype=torch.float64, device=dev)
    cot = torch.cat([torch.zeros((10, n), **f32), acc_bar])
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for jj in range(int(cnt.max()) if n else 0):
        j = cnt - 1 - jj
        active = j >= 0
        blk = resid[j.clamp(min=0), :, lanes].T  # [13, N]
        s = torch.where(active, blk[11].to(torch.int64), 0)
        d = torch.where(active, blk[12].to(torch.int64), 1)
        newseg = active & (s != prev)
        cot = torch.cat([torch.where(newseg, 0.0, cot[0:10]), cot[10:13]])
        u, v, p = kr.event_uniforms_premixed(
            ((hlane + kr.sd_term(sample0, s, d)) & _M32)[None, :], seeds_col)
        state = torch.cat([torch.where(active, blk[0:9], 0.0), active.to(torch.float32)[None],
                           torch.zeros((3, n), **f32)])
        t = torch.where(active, blk[9], math.inf)
        idx = torch.where(active, blk[10], 0.0).to(torch.int32)
        cin, dm, de = _bounce_bwd64(pk, state, t, idx, torch.stack([u, kr.acos01(u), v, p]),
                                    cot)
        d_mat = d_mat + dm
        d_env = d_env + de
        start = active & (d == 1)
        d0[s[start], 0:9, lanes[start]] = cin[0:9, start].T
        cot = torch.where(active, cin, cot)
        prev = torch.where(active, s, prev)
    return d0.reshape(s_count * 10, n), d_mat.to(torch.float32), d_env.to(torch.float32)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _scene_ptrs(pk: PackedSceneFused):
    if pk.tri_tab.data_ptr() % 16 or pk.sph_tab.data_ptr() % 16:
        raise ValueError("the kernels read Woop and sphere rows as float4: the tables "
                         "must be 16-byte aligned")
    env = pk.env_host
    return (pk.tri_tab.data_ptr(), pk.sph_tab.data_ptr(), pk.tri_attr.data_ptr(),
            pk.sph_attr.data_ptr(), pk.n_tri, pk.n_sph, pk.t_pad, env[0], env[1], env[2])


def _regen_table_cuda(pk, state0, nexta, unif, eps, nb, s_count):
    if not isinstance(pk, PackedSceneStream):
        raise ValueError("K5 on the card takes a PackedSceneStream: its culled search "
                         "reads the window boxes")
    n = state0.shape[1]
    dev = state0.device
    acc = torch.empty((3, n), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    next_lane = torch.zeros((1,), dtype=torch.int32, device=dev)  # the lane queue's head
    err = _cuda.lib().pt3_regen_table(
        *_scene_ptrs(pk), state0.data_ptr(), nexta.data_ptr(), unif.data_ptr(),
        acc.data_ptr(), cnt.data_ptr(), next_lane.data_ptr(), pk.wbox.data_ptr(),
        pk.wbox1.data_ptr(), pk.n_windows, pk.n_groups, pk.window, pk.fan, n, s_count, nb,
        float(eps), int(pk.no_glossy), _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pt3_regen_table")
    fused_passes.launches += 1
    return acc, cnt


def _regen_krng_cuda(pk, lane_ids, amask, state0, resid_in, seeds, sample0, eps,
                     nb, s_count, thresh, no_glossy, block, rres=None, stream=False):
    n = state0.shape[1]
    dev = state0.device
    acc = torch.empty((3, n), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    resid_out = (torch.empty((12, n), dtype=torch.float32, device=dev)
                 if thresh else None)
    rres_n = rres.shape[2] if rres is not None else 0
    if not isinstance(pk, PackedSceneStream):
        raise ValueError("K4 on the card takes a PackedSceneStream: its culled search "
                         "reads the window boxes")
    win = (_cuda.ptr(pk.tri_win if stream else None), pk.wbox.data_ptr(), pk.wbox1.data_ptr(),
           pk.n_windows, pk.n_groups, pk.window, pk.fan)
    next_lane = torch.zeros((1,), dtype=torch.int32, device=dev)  # the lane queue's head
    err = _cuda.lib().pt3_regen_krng(
        *_scene_ptrs(pk), seeds[0], seeds[1], seeds[2], int(sample0),
        lane_ids.data_ptr(), amask.data_ptr(), state0.data_ptr(),
        _cuda.ptr(resid_in), acc.data_ptr(), cnt.data_ptr(), _cuda.ptr(resid_out),
        _cuda.ptr(rres), next_lane.data_ptr(), rres_n, *win, n, s_count, nb,
        float(eps), int(thresh), int(no_glossy), int(block), _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pt3_regen_krng")
    fused_passes_krng.launches += 1
    if stream:
        fused_passes_krng.stream_launches += 1
    return acc, cnt, resid_out


def _fused_bounces_cuda(pk, org, dirn, beta, alive, unif, eps, nb, with_residuals):
    if not isinstance(pk, PackedSceneStream):
        raise ValueError("K7 on the card culls its search by the window boxes of a "
                         "PackedSceneStream")
    n = org.shape[1]
    dev = org.device
    f32 = dict(dtype=torch.float32, device=dev)
    acc = torch.empty((3, n), **f32)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    res = ((torch.empty((13 * nb, n), **f32), torch.empty((nb, n), **f32),
            torch.empty((nb, n), dtype=torch.int32, device=dev))
           if with_residuals else (None, None, None))
    err = _cuda.lib().pt3_fused_bounces(
        *_scene_ptrs(pk), org.data_ptr(), dirn.data_ptr(), beta.data_ptr(),
        alive.data_ptr(), unif.data_ptr(), acc.data_ptr(), cnt.data_ptr(),
        *(_cuda.ptr(r) for r in res), pk.wbox.data_ptr(), pk.wbox1.data_ptr(), pk.n_windows,
        pk.n_groups, pk.window, pk.fan, n, nb, float(eps), int(pk.no_glossy),
        _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pt3_fused_bounces")
    fused_bounces.launches += 1
    return (acc, cnt, *res) if with_residuals else (acc, cnt)


def _bounce_step_cuda(pk, state, unif, eps, with_hit):
    n = state.shape[1]
    dev = state.device
    out = torch.empty((13, n), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    hit = ((torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev)) if with_hit else (None, None))
    err = _cuda.lib().pt3_bounce_step(
        *_scene_ptrs(pk), pk.wbox.data_ptr(), pk.wbox1.data_ptr(), pk.n_windows, pk.n_groups,
        pk.window, pk.fan, state.data_ptr(), unif.data_ptr(), out.data_ptr(), cnt.data_ptr(),
        *(_cuda.ptr(h) for h in hit), n, float(eps), int(pk.no_glossy), _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pt3_bounce_step")
    bounce_step.launches += 1
    return (out, cnt, *hit) if with_hit else (out, cnt)


BWD_BLOCK = 128  # lanes per K9 block (kBlock in regen_replay_bwd.cu)
K8_BLOCK = 256  # lanes per K8 block (kBlock in bounce_bwd.cu)
_K8_TICKETS = {}  # device -> K8's ticket counter (0 between launches: each resets it)


def _bounce_bwd_cuda(pk, state, t, idx, unif, cot_out):
    n = state.shape[1]
    dev = state.device
    n_col = 9 * pk.n_mat + 3
    cot_in = torch.empty((13, n), dtype=torch.float32, device=dev)
    # a row a block of the persistent grid (at most one a K8_BLOCK lanes)
    partial = torch.empty((-(-n // K8_BLOCK), n_col), dtype=torch.float32, device=dev)
    d_out = torch.empty((n_col,), dtype=torch.float32, device=dev)
    ticket = _K8_TICKETS.get(dev)
    if ticket is None:
        ticket = _K8_TICKETS[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    err = _cuda.lib().pt3_bounce_bwd(
        *_scene_ptrs(pk), pk.tri_mat.data_ptr(), pk.sph_mat.data_ptr(), pk.n_mat,
        state.data_ptr(), t.data_ptr(), idx.data_ptr(), unif.data_ptr(),
        cot_out.data_ptr(), cot_in.data_ptr(), partial.data_ptr(), d_out.data_ptr(),
        ticket.data_ptr(), n, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pt3_bounce_bwd")
    bounce_bwd_step.launches += 1
    return cot_in, d_out[:-3].reshape(pk.n_mat, 9), d_out[-3:]


def _regen_replay_bwd_cuda(pk, lane_ids, resid, cnt, acc_bar, seeds, sample0, s_count):
    n = acc_bar.shape[1]
    dev = acc_bar.device
    n_col = 9 * pk.n_mat + 3
    d_state0 = torch.empty((s_count * 10, n), dtype=torch.float32, device=dev)  # written whole
    partial = torch.empty((n_col, -(-n // BWD_BLOCK)), dtype=torch.float32, device=dev)
    d_out = torch.empty((n_col,), dtype=torch.float32, device=dev)
    err = _cuda.lib().pt3_regen_replay_bwd(
        *_scene_ptrs(pk), pk.tri_mat.data_ptr(), pk.sph_mat.data_ptr(), pk.n_mat,
        seeds[0], seeds[1], seeds[2], int(sample0), lane_ids.data_ptr(), resid.data_ptr(),
        cnt.data_ptr(), acc_bar.data_ptr(), d_state0.data_ptr(),
        partial.data_ptr(), d_out.data_ptr(), n, int(s_count), _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "pt3_regen_replay_bwd")
    regen_replay_bwd.launches += 1
    return d_state0, d_out[:-3].reshape(pk.n_mat, 9), d_out[-3:]


def _device_kind(*tensors) -> str:
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"megakernel: tensors on devices {kinds}")
    return kinds.pop()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def next_alive_table(state0: torch.Tensor, s_count: int) -> torch.Tensor:
    """[S+1, N] int32: row 0 = first alive sample (or S), row ss+1 = next
    alive sample after ss (or S), from the per-sample alive rows."""
    n = state0.shape[1]
    alive0 = state0.reshape(s_count, 10, n)[:, 9] != 0.0
    nxt = torch.full((n,), s_count, dtype=torch.int32, device=state0.device)
    rows = [None] * (s_count + 1)
    for ss in range(s_count - 1, -1, -1):
        rows[ss + 1] = nxt
        nxt = torch.where(alive0[ss], torch.full_like(nxt, ss), nxt)
    rows[0] = nxt
    return torch.stack(rows).contiguous()


def lane_major_table(unif_rows: torch.Tensor, nb: int, s_count: int) -> torch.Tensor:
    """A row-major uniform table [S*nb*4, N] (rows u, acos u, v, p per
    sample and depth: the JAX package's layout, and ``bounce_rows``'s) as
    K5 takes it, [S*nb, N, 4]."""
    n = unif_rows.shape[1]
    return unif_rows.reshape(s_count * nb, 4, n).transpose(1, 2).contiguous()


@tracing.spanned("pt3.k4", device=True)
def fused_passes(pk: PackedSceneFused, state0: torch.Tensor, unif: torch.Tensor,
                 eps: float, nb: int, s_count: int):
    """K5: S regenerating passes with table uniforms. state0 [S*10, N] rows
    (org3 dir3 beta3 alive1) per sample; unif [S*nb, N, 4]: each lane's
    (u, acos u, v, p) per (sample, depth), lane-major so that a bounce reads
    its four draws at once (``integrator.bounce_rows(lane_major=True)``;
    ``lane_major_table`` converts the row-major table). Returns (acc [3, N]
    summed over samples, live-bounce counts [N] int32). On the card ``pk``
    is a ``PackedSceneStream`` (the culled search reads its window boxes);
    the plain version takes either pack and scans every triangle."""
    n = state0.shape[1]
    if state0.shape[0] != 10 * s_count or unif.shape != (nb * s_count, n, 4):
        raise ValueError("fused_passes: state0 [S*10, N], unif [S*nb, N, 4]")
    state0 = state0.to(torch.float32).contiguous()
    unif = unif.to(torch.float32).contiguous()
    nexta = next_alive_table(state0, s_count)
    if _device_kind(state0, unif, pk.tri_tab) == "cuda":
        acc, cnt = _regen_table_cuda(pk, state0, nexta, unif, eps, nb, s_count)
    else:
        acc, cnt = fused_passes_plain(pk, state0, nexta, unif, eps, nb, s_count)
    return acc, cnt


fused_passes.launches = 0


def alive_mask_words(state0: torch.Tensor, s_count: int) -> torch.Tensor:
    """[2, N] int32: bit ss of word ss // 32 set <=> sample ss alive (the
    uint32 words in two's complement: a sum of distinct bits, bit 31 the
    int32 minimum, so it never overflows)."""
    n = state0.shape[1]
    alive0 = state0.reshape(s_count, 10, n)[:, 9] != 0.0
    words = []
    for lo in (0, 32):
        nbits = max(min(s_count - lo, 32), 0)
        shift = torch.arange(nbits, dtype=torch.int32, device=state0.device)[:, None]
        words.append((alive0[lo:lo + nbits].to(torch.int32) << shift).sum(dim=0,
                                                                          dtype=torch.int32))
    return torch.stack(words).contiguous()


def _krng_launch(pk, lane_ids, amask, state0, resid_in, seeds, sample0, eps, nb,
                 s_count, thresh, no_glossy, block, rres, stream):
    launch = _regen_krng_cuda if lane_ids.device.type == "cuda" else regen_krng_plain
    return launch(pk, lane_ids, amask, state0, resid_in, seeds, sample0, eps, nb, s_count,
                  thresh, no_glossy, block, rres, stream)


@tracing.spanned("pt3.k4", device=True)
def fused_passes_krng(pk: PackedSceneFused, state0: torch.Tensor,
                      lane_ids: torch.Tensor, key_words, sample0: int, eps: float,
                      nb: int, s_count: int, tail_frac: float = 0.0,
                      tail_levels: int = 1, stream: bool = False,
                      replay: bool = False, block: int = BLOCK):
    """K4: S regenerating passes with in-kernel counter RNG. Same contract
    as ``fused_passes``; bounce uniforms come from (lane_ids, sample0 + s,
    depth, key_words). ``tail_frac`` > 0 enables tail compaction (exact:
    per-lane contributions are unchanged; only the float32 summation
    grouping at level boundaries differs). Returns (acc [3, N], cnt [N]);
    with ``replay``, (acc, cnt, resid): the replay residuals [S*nb, 13, N],
    of which a lane's slots j < cnt are written (``acc`` and ``cnt`` are
    bit-equal to a launch without ``replay``). Replay runs without tail
    compaction and outside the stream mode, as in the JAX package: either
    raises ``ValueError``. The replay search is culled by the window boxes
    of ``pk``, a PackedSceneStream (the same winners; on the CPU a
    PackedSceneFused scans every triangle).
    ``stream`` (``pk`` a PackedSceneStream) searches the triangles with
    K6, window by window; ``acc`` and ``cnt`` are bit-equal to the
    resident launch."""
    if replay and (tail_frac > 0.0 or stream):
        raise ValueError("replay residuals are incompatible with tail compaction and the "
                         "stream mode")
    if stream and not isinstance(pk, PackedSceneStream):
        raise ValueError("stream=True needs a PackedSceneStream")
    if s_count > S_COUNT_MAX:
        raise ValueError(
            f"krng regen supports at most {S_COUNT_MAX} fused passes, got {s_count}"
        )
    n = state0.shape[1]
    if state0.shape[0] != 10 * s_count or lane_ids.shape != (n,):
        raise ValueError("fused_passes_krng: state0/lane_ids shapes do not match S")
    _device_kind(state0, lane_ids, pk.tri_tab)
    dev = state0.device
    # tail compaction needs whole blocks; padding lanes are dead from the
    # start, so they write no replay slot (the residuals keep N columns)
    pad = (-n) % block
    state0 = state0.to(torch.float32)
    lane_ids = lane_ids.to(torch.int32)
    if pad:
        state0 = torch.cat([state0, state0.new_zeros((state0.shape[0], pad))], dim=1)
        lane_ids = torch.cat([lane_ids, lane_ids.new_zeros((pad,))])
    state0 = state0.contiguous()
    lane_ids = lane_ids.contiguous()
    amask = alive_mask_words(state0, s_count)
    seeds = kr.channel_seeds(int(key_words[0]), int(key_words[1]))
    no_glossy = pk.no_glossy
    npad = state0.shape[1]
    thresh = int(tail_frac * block) if npad > block else 0
    rres = None
    if replay:
        # only the slots j < cnt of a lane are written (zeros on the CPU)
        alloc = torch.zeros if dev.type == "cpu" else torch.empty
        rres = alloc((s_count * nb, 13, n), dtype=torch.float32, device=dev)
    run = lambda lid, am, s0, res, th: _krng_launch(
        pk, lid, am, s0, res, seeds, sample0, eps, nb, s_count, th, no_glossy, block,
        rres, stream)
    if thresh:
        # tail compaction: every level but the last stops its blocks at
        # live < thresh; survivors (sorted by remaining samples) are packed
        # into a smaller continuation launch; the last level runs to the end
        levels = max(int(tail_levels), 1)
        acc = cnt = None
        gidx = None  # survivor columns in original lane coordinates
        cur = (lane_ids, amask, state0, None)
        level_n = npad
        for level in range(levels + 1):
            n2 = (level_n // block) * thresh
            n2 = min(-(-n2 // block) * block, level_n)
            last = level == levels or level_n <= block or n2 >= level_n
            acc_l, cnt_l, resid = run(*cur, 0 if last else thresh)
            if gidx is None:
                acc, cnt = acc_l, cnt_l
            else:
                acc = acc.index_add(1, gidx, acc_l)
                cnt = cnt.index_add(0, gidx, cnt_l)
            if last:
                break
            alive = resid[9] != 0.0
            remaining = torch.where(
                alive, s_count - resid[10].to(torch.int64), torch.full_like(alive, -1, dtype=torch.int64)
            )
            idx2 = torch.argsort(-remaining, stable=True)[:n2]
            gidx = idx2 if gidx is None else gidx[idx2]
            take = lambda a: a[..., idx2].contiguous()
            cur = (take(cur[0]), take(cur[1]), take(cur[2]), take(resid))
            level_n = n2
    else:
        acc, cnt, _ = run(lane_ids, amask, state0, None, 0)
    if pad:
        acc = acc[:, :n]
        cnt = cnt[:n]
    return (acc, cnt, rres) if replay else (acc, cnt)


fused_passes_krng.launches = 0
fused_passes_krng.stream_launches = 0  # the launches in stream mode (K6)


def bounce_step_plain(pk: PackedSceneFused, state, unif, eps: float, with_hit: bool = False):
    """Plain version of K10: one bounce of the [13, N] state (org3 dir3
    beta3 alive1 acc3) with the unpacked winner and this bounce's uniforms
    [4, N]. Returns (state' [13, N], cnt [N] int32: 1 where the lane was
    alive) and, ``with_hit``, the winner (t [N], +inf on a miss or a dead
    lane; idx [N], 0 there)."""
    st = state[0:10].clone()
    acc = state[10:13].clone()
    cnt = torch.zeros((state.shape[1],), dtype=torch.int32, device=state.device)
    t, idx, hit = _bounce_common(pk, st, acc, cnt, st[9] != 0.0, False, eps)
    _shade_plain(pk, st, acc, t, idx, hit, unif[0], unif[1], unif[2], unif[3], pk.no_glossy)
    out = (torch.cat([st, acc]), cnt)
    if not with_hit:
        return out
    return (*out, torch.where(hit, t, torch.full_like(t, math.inf)),
            torch.where(hit, idx, torch.zeros_like(idx)))


@tracing.spanned("pt3.k10", device=True)
def bounce_step(pk: PackedSceneFused, state: torch.Tensor, unif: torch.Tensor, eps: float,
                with_hit: bool = False):
    """K10: one bounce of the compacting wavefront. state [13, N] (org3
    dir3 beta3 alive1 acc3), unif [4, N] (u, acos u, v, p). Returns (state'
    [13, N], cnt [N] int32, 1 where the lane was alive on entry) and, with
    ``with_hit``, the winner record (t [N], +inf on a miss or a dead lane;
    packed idx [N], 0 there). A dead lane's column is copied through."""
    n = state.shape[1]
    if state.shape != (13, n) or unif.shape != (4, n):
        raise ValueError("bounce_step: state [13, N], unif [4, N]")
    f32 = lambda x: x.detach().to(torch.float32).contiguous()
    state, unif = f32(state), f32(unif)
    if _device_kind(state, unif, pk.tri_tab) == "cuda":
        return _bounce_step_cuda(pk, state, unif, eps, with_hit)
    return bounce_step_plain(pk, state, unif, eps, with_hit)


bounce_step.launches = 0


@tracing.spanned("pt3.k7", device=True)
def fused_bounces(pk: PackedSceneFused, org: torch.Tensor, dirn: torch.Tensor,
                  beta: torch.Tensor, alive: torch.Tensor, unif: torch.Tensor,
                  eps: float, nb: int, with_residuals: bool = False):
    """K7: ``nb`` bounces of one sample pass. org/dirn/beta [3, N], alive
    [N], unif [4*nb, N] rows (u, acos u, v, p) per bounce. Returns (acc
    [3, N], live-bounce counts [N] int32) and, ``with_residuals``, the
    path-replay residuals: each bounce's input state [13*nb, N], winner t
    [nb, N] (+inf on a miss) and packed index [nb, N] (0 on a miss)."""
    n = org.shape[1]
    if any(x.shape != (3, n) for x in (dirn, beta)) or alive.shape != (n,) \
            or unif.shape != (4 * nb, n):
        raise ValueError("fused_bounces: org/dirn/beta [3, N], alive [N], unif [4*nb, N]")
    f32 = lambda x: x.detach().to(torch.float32).contiguous()
    args = (f32(org), f32(dirn), f32(beta), f32(alive), f32(unif))
    if _device_kind(*args, pk.tri_tab) == "cuda":
        return _fused_bounces_cuda(pk, *args, eps, nb, with_residuals)
    return fused_bounces_plain(pk, *args[:3], args[3] != 0.0, args[4], eps, nb,
                               with_residuals)


fused_bounces.launches = 0

# K9's shared memory holds 4 warps x (9 * n_mat + 3) floats beside its slot
# stages and accumulators, K8's 8 warps': 340 materials keep both within a
# block's 227 KB
MAX_BWD_MATERIALS = 340


@tracing.spanned("pt3.k8", device=True)
def bounce_bwd_step(pk: PackedSceneFused, state: torch.Tensor, t: torch.Tensor,
                    idx: torch.Tensor, unif: torch.Tensor, cot_out: torch.Tensor):
    """K8: the VJP of one replayed bounce. state [13, N]: the saved input
    state (org3 dir3 beta3 alive1 acc3); t, idx [N]: its saved winner; unif
    [4, N]: its (u, acos u, v, p); cot_out [13, N]: the cotangent of the
    output state. Returns (cot_in [13, N], d_mat [M, 9] (emission 3,
    diffuse 3, ior, reflectivity, cone angle), d_env [3]). The geometry
    (Woop rows, vertex normals, sphere centres) is a constant."""
    n = state.shape[1]
    if state.shape != (13, n) or cot_out.shape != (13, n) or unif.shape != (4, n) \
            or t.shape != (n,) or idx.shape != (n,):
        raise ValueError("bounce_bwd_step: state/cot_out [13, N], unif [4, N], t/idx [N]")
    f32 = lambda x: x.detach().to(torch.float32).contiguous()
    state, t, unif, cot_out = f32(state), f32(t), f32(unif), f32(cot_out)
    idx = idx.detach().to(torch.int32).contiguous()
    if _device_kind(state, t, idx, unif, cot_out, pk.tri_tab) == "cuda":
        if pk.n_mat > MAX_BWD_MATERIALS:
            raise ValueError(f"bounce_bwd_step: at most {MAX_BWD_MATERIALS} materials")
        return _bounce_bwd_cuda(pk, state, t, idx, unif, cot_out)
    return bounce_bwd_plain(pk, state, t, idx, unif, cot_out)


bounce_bwd_step.launches = 0


@tracing.spanned("pt3.k9", device=True)
def regen_replay_bwd(pk: PackedSceneFused, lane_ids: torch.Tensor, key_words,
                     sample0: int, resid: torch.Tensor, cnt: torch.Tensor,
                     acc_bar: torch.Tensor, s_count: int):
    """K9: the reverse walk over K4's replay residuals (``fused_passes_krng``
    with ``replay=True``, on the same lane ids, key words and sample0).
    resid [S*nb, 13, N], cnt [N], acc_bar [3, N]: the cotangent of K4's
    radiance sum. Returns (d_state0 [S*10, N] in state0's sample-major
    layout, zero alive rows; d_mat [M, 9] (emission 3, diffuse 3, ior,
    reflectivity, cone angle); d_env [3])."""
    n = acc_bar.shape[1]
    if resid.dim() != 3 or resid.shape[1:] != (13, n) or resid.shape[0] % s_count \
            or cnt.shape != (n,) or lane_ids.shape != (n,):
        raise ValueError("regen_replay_bwd: resid [S*nb, 13, N], cnt/lane_ids [N], "
                         "acc_bar [3, N]")
    seeds = kr.channel_seeds(int(key_words[0]), int(key_words[1]))
    resid = resid.detach().to(torch.float32).contiguous()
    acc_bar = acc_bar.detach().to(torch.float32).contiguous()
    cnt = cnt.to(torch.int32).contiguous()
    lane_ids = lane_ids.to(torch.int32).contiguous()
    if _device_kind(resid, cnt, lane_ids, acc_bar, pk.tri_tab) == "cuda":
        if pk.n_mat > MAX_BWD_MATERIALS:
            raise ValueError(f"regen_replay_bwd: at most {MAX_BWD_MATERIALS} materials")
        return _regen_replay_bwd_cuda(pk, lane_ids, resid, cnt, acc_bar, seeds, sample0,
                                      s_count)
    return regen_replay_bwd_plain(pk, lane_ids, resid, cnt, acc_bar, seeds, sample0, s_count)


regen_replay_bwd.launches = 0
