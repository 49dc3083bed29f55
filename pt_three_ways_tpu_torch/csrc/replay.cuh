// Per-lane bodies of the training path's kernels:
//
//   K7 fused_bounces_lane: nb bounces of one sample pass from uniform
//      tables, optionally writing the path-replay residuals (each bounce's
//      input state and winner record), the winner from the culled warp
//      search with the unpacked winner (stream_tri.cuh
//      culled_search_warp_near, K2's);
//   K8 bounce_bwd_lane: the adjoint of one shading bounce, written by hand
//      in reverse mode, at a saved input state and winner.
//
// The forward arithmetic is pt3_device.cuh's (woop_hit_t, shade) so a
// replayed bounce makes the same discrete choices (winner, event, liveness)
// as the forward that saved it. The adjoint differentiates the function
// that the JAX package's _bounce_bwd_body hands to jax.vjp
// (ops/pallas_megakernel.py:2347-2517) plus its winner-t term (2522-2552):
// every NaN guard there is a branch here, so an untaken branch contributes
// nothing (never 0 * inf). Geometry (Woop rows, vertex normals, sphere
// centres), liveness, the winner and the event choice are constants.
#pragma once

#include "pt3_device.cuh"
#include "stream_tri.cuh"

namespace pt3 {

// ----------------------------------------------------------------- K7 ----

// One lane of nb bounces. st: org3 dir3 beta3 alive1 (updated in place);
// acc and cnt accumulate. unif rows (u, acos u, v, p) per bounce, strided
// [(4 d + k) * n + lane]. EMIT writes the input state of every bounce
// (13 rows: st then acc) and its winner (t, +inf on a miss; idx, 0 on a
// miss), the layout of the JAX package's fused_bounces(with_residuals=True).
// The winner is the unpacked one (the exact minimum t, the lowest row on
// ties, spheres first), found by the culled warp search over the window
// boxes w: every lane of the warp runs all nb bounces; a lane past n
// (!valid) is never live and writes nothing.
template <bool NO_GLOSSY, bool EMIT>
__device__ __forceinline__ void fused_bounces_lane(
    const SceneView& s, const StreamView& w, float* st, float* acc, int& cnt,
    const float* __restrict__ unif, float* __restrict__ states,
    float* __restrict__ ts, int* __restrict__ idxs, int lane, int n, int nb,
    float eps, bool valid) {
  for (int d = 0; d < nb; ++d) {
    if (EMIT && valid) {
#pragma unroll
      for (int r = 0; r < 10; ++r) states[(size_t)(13 * d + r) * n + lane] = st[r];
#pragma unroll
      for (int c = 0; c < 3; ++c) states[(size_t)(13 * d + 10 + c) * n + lane] = acc[c];
    }
    const bool live = valid && st[9] != 0.0f;
    const Ray r{st[0], st[1], st[2], st[3], st[4], st[5]};
    float t;
    int idx;
    culled_search_warp_near(s, w, r, live, eps, t, idx);
    bool hit = false;
    if (live) {
      cnt += 1;
      hit = isfinite(t) && t > 0.0f;
      if (!hit) {
        acc[0] = acc[0] + st[6] * s.env[0];
        acc[1] = acc[1] + st[7] * s.env[1];
        acc[2] = acc[2] + st[8] * s.env[2];
      }
    }
    if (EMIT && valid) {
      ts[(size_t)d * n + lane] = hit ? t : kInf;
      idxs[(size_t)d * n + lane] = hit ? idx : 0;
    }
    st[9] = 0.0f;
    if (hit) {
      const size_t row = (size_t)4 * d;
      shade<NO_GLOSSY>(s, st, acc, t, idx, unif[row * n + lane],
                       unif[(row + 1) * n + lane], unif[(row + 2) * n + lane],
                       unif[(row + 3) * n + lane]);
    }
  }
}

// ----------------------------------------------------------------- K8 ----

// y = x / |x| with |x|^2 clamped below at kNormFloor (normalise3). Given the
// cotangent g of y, returns that of x: g inv - (g.x) inv^3 x; the clamp
// passes nothing below the floor.
__device__ __forceinline__ void normalise3_bwd(float x, float y, float z,
                                               float gx, float gy, float gz,
                                               float& dx, float& dy, float& dz) {
  const float n2 = x * x + y * y + z * z;
  const float inv = 1.0f / sqrtf(fmaxf(n2, kNormFloor));
  dx = gx * inv;
  dy = gy * inv;
  dz = gz * inv;
  if (n2 >= kNormFloor) {
    const float k = -(gx * x + gy * y + gz * z) * (inv * inv * inv);
    dx = dx + k * x;
    dy = dy + k * y;
    dz = dz + k * z;
  }
}

// Adjoint of onb_from_z: adds to dz the cotangent reaching z from the
// cotangents (gx*, gy*) of the basis vectors xx and yy. The pivot choice
// (the 0.9999 guard) is a constant.
__device__ __forceinline__ void onb_from_z_bwd(float zx, float zy, float zz,
                                               float gxx, float gxy, float gxz,
                                               float gyx, float gyy, float gyz,
                                               float& dzx, float& dzy, float& dzz) {
  const bool use_y = fabsf(zx) > kCoincident;
  const float px = use_y ? 0.0f : 1.0f;
  const float py = use_y ? 1.0f : 0.0f;
  // xx = normalise(pivot x z)
  const float rx = py * zz, ry = -px * zz, rz = px * zy - py * zx;
  float xx = rx, xy = ry, xz = rz;
  normalise3(xx, xy, xz);
  // yy = normalise(z x xx)
  const float sx = zy * xz - zz * xy;
  const float sy = zz * xx - zx * xz;
  const float sz = zx * xy - zy * xx;
  float dsx, dsy, dsz;
  normalise3_bwd(sx, sy, sz, gyx, gyy, gyz, dsx, dsy, dsz);
  // s = z x xx: z gets xx x ds, xx gets ds x z
  dzx = dzx + (xy * dsz - xz * dsy);
  dzy = dzy + (xz * dsx - xx * dsz);
  dzz = dzz + (xx * dsy - xy * dsx);
  const float gx2 = gxx + (dsy * zz - dsz * zy);
  const float gy2 = gxy + (dsz * zx - dsx * zz);
  const float gz2 = gxz + (dsx * zy - dsy * zx);
  float drx, dry, drz;
  normalise3_bwd(rx, ry, rz, gx2, gy2, gz2, drx, dry, drz);
  dzz = dzz + (py * drx - px * dry);
  dzy = dzy + px * drz;
  dzx = dzx - py * drz;
}

struct BwdOut {
  float cot_in[13];  // cotangent of the input state rows
  float g_mat[9];    // emission3 diffuse3 ior reflectivity cone of `mat`
  float g_env[3];    // environment (miss lanes)
  int mat;           // the winner's material, -1 when the lane did not hit
};

// Adjoint of one bounce of a lane. st: the saved input state (org3 dir3
// beta3 alive1 acc3); (t, idx): its saved winner; (u, acos_u, v, p): its
// uniforms; C: the cotangent of the output state.
__device__ __forceinline__ void bounce_bwd_lane(
    const SceneView& s, const int* __restrict__ tri_mat,
    const int* __restrict__ sph_mat, const float* st, float t, int idx,
    float u, float acos_u, float v, float p, const float* C, BwdOut& o) {
#pragma unroll
  for (int k = 0; k < 9; ++k) o.g_mat[k] = 0.0f;
  o.g_env[0] = o.g_env[1] = o.g_env[2] = 0.0f;
  o.mat = -1;
  const bool alive = st[9] != 0.0f;
  const bool hit = alive && isfinite(t) && t > 0.0f;
  if (!hit) {
    // state rows pass through; a dead lane stays dead (row 9 is not
    // differentiable); a live miss adds beta * environment to acc
#pragma unroll
    for (int r = 0; r < 13; ++r) o.cot_in[r] = C[r];
    o.cot_in[9] = 0.0f;
    if (alive) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o.cot_in[6 + c] = o.cot_in[6 + c] + C[10 + c] * s.env[c];
        o.g_env[c] = C[10 + c] * st[6 + c];
      }
    }
    return;
  }

  // ---- forward, as shade() computes it ----
  const float ox = st[0], oy = st[1], oz = st[2];
  const float dx = st[3], dy = st[4], dz = st[5];
  const float bx = st[6], by = st[7], bz = st[8];
  const float px_ = ox + t * dx;
  const float py_ = oy + t * dy;
  const float pz_ = oz + t * dz;
  const bool tri = idx < s.n_tri;
  float w[12];      // triangle: Woop rows; sphere: centre in w[0..2]
  float n0[3], n1[3], n2[3];  // triangle vertex normals
  float d_u = 0.0f, d_v = 0.0f;
  float ix, iy, iz;  // unnormalised normal
  float nx, ny, nz, flip, em[3], di[3], ior, refl0, cone;
  bool inside;
  if (tri) {
    const float* a = s.tri_attr + (size_t)kTriAttr * idx;
#pragma unroll
    for (int k = 0; k < 12; ++k) w[k] = __ldg(a + k);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      n0[c] = __ldg(a + 12 + c);
      n1[c] = __ldg(a + 15 + c);
      n2[c] = __ldg(a + 18 + c);
      em[c] = __ldg(a + 21 + c);
      di[c] = __ldg(a + 24 + c);
    }
    ior = __ldg(a + 27);
    refl0 = __ldg(a + 28);
    cone = __ldg(a + 29);
    o.mat = tri_mat[idx];
    const float o_u = w[0] * ox + w[1] * oy + w[2] * oz + w[3];
    const float o_v = w[4] * ox + w[5] * oy + w[6] * oz + w[7];
    d_u = w[0] * dx + w[1] * dy + w[2] * dz;
    d_v = w[4] * dx + w[5] * dy + w[6] * dz;
    const float d_w = w[8] * dx + w[9] * dy + w[10] * dz;
    const float uu = o_u + t * d_u;
    const float vv = o_v + t * d_v;
    ix = n0[0] + uu * (n1[0] - n0[0]) + vv * (n2[0] - n0[0]);
    iy = n0[1] + uu * (n1[1] - n0[1]) + vv * (n2[1] - n0[1]);
    iz = n0[2] + uu * (n1[2] - n0[2]) + vv * (n2[2] - n0[2]);
    nx = ix;
    ny = iy;
    nz = iz;
    normalise3(nx, ny, nz);
    inside = d_w > 0.0f;
  } else {
    const int j = idx - s.n_tri;
    const float* a = s.sph_attr + (size_t)kSphAttr * j;
    w[0] = __ldg(a);
    w[1] = __ldg(a + 1);
    w[2] = __ldg(a + 2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      em[c] = __ldg(a + 3 + c);
      di[c] = __ldg(a + 6 + c);
    }
    ior = __ldg(a + 9);
    refl0 = __ldg(a + 10);
    cone = __ldg(a + 11);
    o.mat = sph_mat[j];
    ix = px_ - w[0];
    iy = py_ - w[1];
    iz = pz_ - w[2];
    nx = ix;
    ny = iy;
    nz = iz;
    normalise3(nx, ny, nz);
    inside = nx * dx + ny * dy + nz * dz > 0.0f;
  }
  flip = inside ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;

  const float ior_from = inside ? ior : 1.0f;
  const float ior_to = inside ? 1.0f : ior;
  const float ratio = ior_from / ior_to;
  const float cos_i = -(dx * nx + dy * ny + dz * nz);
  const float sin_t_sq = ratio * ratio * (1.0f - cos_i * cos_i);
  const float cos_t = sqrtf(fmaxf(1.0f - sin_t_sq, 0.0f));
  const float den_f = ior_from * cos_i + ior_to * cos_t;
  const float r_perp = den_f > 0.0f ? (ior_from * cos_i - ior_to * cos_t) / den_f : 1.0f;
  const float fresnel = sin_t_sq > 1.0f ? 1.0f : r_perp * r_perp;
  const float refl = refl0 < 0.0f ? fresnel : refl0;
  const bool spec = p < refl;
  const float rdot = 2.0f * (dx * nx + dy * ny + dz * nz);
  const float rx = dx - nx * rdot, ry = dy - ny * rdot, rz = dz - nz * rdot;

  // ---- reverse ----
  const float Cp[3] = {C[0], C[1], C[2]};
  const float Cd[3] = {C[3], C[4], C[5]};
  const float Cb[3] = {C[6], C[7], C[8]};
  const float Ca[3] = {C[10], C[11], C[12]};
  const float b[3] = {bx, by, bz};
  // position p = o + t d
  float d_o[3] = {Cp[0], Cp[1], Cp[2]};
  float d_d[3] = {Cp[0] * t, Cp[1] * t, Cp[2] * t};
  float d_t = Cp[0] * dx + Cp[1] * dy + Cp[2] * dz;
  float d_n[3] = {0.0f, 0.0f, 0.0f};
  float d_b[3];
  // emission: acc += beta * emission
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.g_mat[c] = Ca[c] * b[c];
    d_b[c] = Ca[c] * em[c];
  }
  // throughput: beta' = beta * (spec ? 1 : diffuse) * w, with the
  // likelihood-ratio weight w = P / stop_grad(P), primal 1
  const float w_den = spec ? fmaxf(refl, kParallelEps) : fmaxf(1.0f - refl, kParallelEps);
  const float wgt = (spec ? refl : 1.0f - refl) / w_den;
  float d_w = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float q = spec ? 1.0f : di[c];
    d_b[c] = d_b[c] + Cb[c] * q * wgt;
    o.g_mat[3 + c] = spec ? 0.0f : Cb[c] * b[c] * wgt;
    d_w = d_w + Cb[c] * b[c] * q;
  }
  const float d_refl = spec ? d_w / w_den : -d_w / w_den;

  // direction
  if (spec) {
    float drx = Cd[0], dry = Cd[1], drz = Cd[2];
    if (!(cone < kMirrorEps)) {
      // cone sample around the mirror direction r
      const float scale_t = 1.0f - 2.0f * acos_u / kPi;
      const float theta = cone * scale_t;
      const float cradius = sinf(theta);
      const float cz_scale = cosf(theta);
      const float rth = v * kTwoPi;
      float cxx, cxy, cxz, cyx, cyy, cyz;
      onb_from_z(rx, ry, rz, cxx, cxy, cxz, cyx, cyy, cyz);
      const float crt = cosf(rth), srt = sinf(rth);
      const float lx = crt * cradius;
      const float ly = srt * cradius;
      const float sx = cxx * lx + cyx * ly + rx * cz_scale;
      const float sy = cxy * lx + cyy * ly + ry * cz_scale;
      const float sz = cxz * lx + cyz * ly + rz * cz_scale;
      float dsx, dsy, dsz;
      normalise3_bwd(sx, sy, sz, Cd[0], Cd[1], Cd[2], dsx, dsy, dsz);
      drx = dsx * cz_scale;
      dry = dsy * cz_scale;
      drz = dsz * cz_scale;
      const float d_lx = dsx * cxx + dsy * cxy + dsz * cxz;
      const float d_ly = dsx * cyx + dsy * cyy + dsz * cyz;
      const float d_cz = dsx * rx + dsy * ry + dsz * rz;
      const float d_cr = d_lx * crt + d_ly * srt;
      const float d_theta = d_cr * cz_scale - d_cz * cradius;
      o.g_mat[8] = d_theta * scale_t;
      onb_from_z_bwd(rx, ry, rz, dsx * lx, dsy * lx, dsz * lx, dsx * ly,
                     dsy * ly, dsz * ly, drx, dry, drz);
    }
    // r = d - n rdot, rdot = 2 (d . n)
    const float d_rdot = -(drx * nx + dry * ny + drz * nz);
    d_d[0] = d_d[0] + drx + 2.0f * d_rdot * nx;
    d_d[1] = d_d[1] + dry + 2.0f * d_rdot * ny;
    d_d[2] = d_d[2] + drz + 2.0f * d_rdot * nz;
    d_n[0] = d_n[0] - drx * rdot + 2.0f * d_rdot * dx;
    d_n[1] = d_n[1] - dry * rdot + 2.0f * d_rdot * dy;
    d_n[2] = d_n[2] - drz * rdot + 2.0f * d_rdot * dz;
  } else {
    // cosine hemisphere around n
    float hxx, hxy, hxz, hyx, hyy, hyz;
    onb_from_z(nx, ny, nz, hxx, hxy, hxz, hyx, hyy, hyz);
    const float hth = kTwoPi * u;
    const float hr = sqrtf(fmaxf(v, 0.0f));
    const float hlx = cosf(hth) * hr;
    const float hly = sinf(hth) * hr;
    const float hlz = sqrtf(fmaxf(1.0f - v, 0.0f));
    const float hx = hxx * hlx + hyx * hly + nx * hlz;
    const float hy = hxy * hlx + hyy * hly + ny * hlz;
    const float hz = hxz * hlx + hyz * hly + nz * hlz;
    float dhx, dhy, dhz;
    normalise3_bwd(hx, hy, hz, Cd[0], Cd[1], Cd[2], dhx, dhy, dhz);
    d_n[0] = d_n[0] + dhx * hlz;
    d_n[1] = d_n[1] + dhy * hlz;
    d_n[2] = d_n[2] + dhz * hlz;
    onb_from_z_bwd(nx, ny, nz, dhx * hlx, dhy * hlx, dhz * hlx, dhx * hly,
                   dhy * hly, dhz * hly, d_n[0], d_n[1], d_n[2]);
  }

  // event probability: fixed reflectivity or Fresnel
  float d_fres = 0.0f;
  if (refl0 < 0.0f)
    d_fres = d_refl;
  else
    o.g_mat[7] = d_refl;
  if (d_fres != 0.0f && !(sin_t_sq > 1.0f)) {
    const float d_rp = 2.0f * r_perp * d_fres;
    float d_ifrom = 0.0f, d_ito = 0.0f, d_cosi = 0.0f, d_cost = 0.0f;
    if (den_f > 0.0f) {
      // r_perp = (f cos_i - o cos_t) / (f cos_i + o cos_t)
      const float d_num = d_rp / den_f;
      const float d_den = -d_rp * r_perp / den_f;
      d_ifrom = (d_num + d_den) * cos_i;
      d_cosi = (d_num + d_den) * ior_from;
      d_ito = (d_den - d_num) * cos_t;
      d_cost = (d_den - d_num) * ior_to;
    }
    // cos_t = sqrt(1 - sin_t_sq) where positive, else 0 (no gradient)
    const float d_sts = 1.0f - sin_t_sq > 0.0f ? -d_cost * 0.5f / cos_t : 0.0f;
    const float d_ratio = d_sts * 2.0f * ratio * (1.0f - cos_i * cos_i);
    d_cosi = d_cosi + d_sts * ratio * ratio * (-2.0f * cos_i);
    d_ifrom = d_ifrom + d_ratio / ior_to;
    d_ito = d_ito - d_ratio * ratio / ior_to;
    o.g_mat[6] = inside ? d_ifrom : d_ito;
    // cos_i = -(d . n)
    d_d[0] = d_d[0] - d_cosi * nx;
    d_d[1] = d_d[1] - d_cosi * ny;
    d_d[2] = d_d[2] - d_cosi * nz;
    d_n[0] = d_n[0] - d_cosi * dx;
    d_n[1] = d_n[1] - d_cosi * dy;
    d_n[2] = d_n[2] - d_cosi * dz;
  }

  // normal: n = flip * normalise(raw)
  float dix, diy, diz;
  normalise3_bwd(ix, iy, iz, d_n[0] * flip, d_n[1] * flip, d_n[2] * flip, dix, diy, diz);
  float g[3];
  if (tri) {
    // raw = n0 + uu (n1 - n0) + vv (n2 - n0), uu = o_u + t d_u, vv alike
    const float d_uu = dix * (n1[0] - n0[0]) + diy * (n1[1] - n0[1]) + diz * (n1[2] - n0[2]);
    const float d_vv = dix * (n2[0] - n0[0]) + diy * (n2[1] - n0[1]) + diz * (n2[2] - n0[2]);
    d_t = d_t + d_uu * d_u + d_vv * d_v;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float e = d_uu * w[c] + d_vv * w[4 + c];
      d_o[c] = d_o[c] + e;
      d_d[c] = d_d[c] + t * e;
      g[c] = w[8 + c];
    }
  } else {
    // raw = o + t d - centre
    d_t = d_t + (dix * dx + diy * dy + diz * dz);
    const float dr[3] = {dix, diy, diz};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d_o[c] = d_o[c] + dr[c];
      d_d[c] = d_d[c] + t * dr[c];
    }
    g[0] = px_ - w[0];
    g[1] = py_ - w[1];
    g[2] = pz_ - w[2];
  }

  // winner distance: dt/do = -g / (g.d), dt/dd = -t g / (g.d)
  const float gd = g[0] * dx + g[1] * dy + g[2] * dz;
  const float inv = fabsf(gd) > kSafeDir ? 1.0f / gd : 0.0f;
  const float sc = -d_t * inv;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.cot_in[c] = d_o[c] + g[c] * sc;
    o.cot_in[3 + c] = d_d[c] + g[c] * (sc * t);
    o.cot_in[6 + c] = d_b[c];
    o.cot_in[10 + c] = Ca[c];
  }
  o.cot_in[9] = 0.0f;
}

}  // namespace pt3
