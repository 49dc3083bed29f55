// Device code shared by the intersect kernel (K2) and the regenerating
// megakernels (K4, K5): the nearest-hit winner search and one shading event.
//
// One thread owns one ray / path lane. Scene tables stay in global memory
// and are read with __ldg (read-only cache; a Woop row as three float4); at
// catalog scene sizes they sit in L1/L2. With SMEM the same functions read a
// copy of the tables that the kernel staged in shared memory (the one-chunk
// design of K2 and K4, flat_scene.cuh). Arithmetic mirrors the plain PyTorch versions operation for
// operation (ops/intersect_kernel.py: winner_search_plain,
// ops/megakernel.py: _shade_plain); with -fmad=false every product and sum is
// rounded on its own, division and sqrtf are IEEE, so kernel and plain
// version differ at most in sinf/cosf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pt3 {

constexpr float kInf = INFINITY;
constexpr float kPi = 0x1.921fb6p+1f;      // float32(pi)
constexpr float kTwoPi = 0x1.921fb6p+2f;   // float32(2 pi)
constexpr float kParallelEps = 0x1.197998p-40f;  // float32(1e-12)
constexpr float kNormFloor = 0x1.4484c0p-100f;   // float32(1e-30)
constexpr float kMirrorEps = 0x1.12e0bep-30f;    // float32(1e-9)
constexpr float kCoincident = 0x1.fff2e4p-1f;    // float32(0.9999)
constexpr float kSafeDir = 0x1.79ca10p-67f;      // float32(1e-20)
constexpr int kTc = 64;   // triangles per chunk (and per culling window)
constexpr int kTriAttr = 30;
constexpr int kSphAttr = 12;

struct SceneView {
  const float* __restrict__ tri;       // [t_pad, 12] Woop rows
  const float* __restrict__ sph;       // [s_pad, 8] c3, r^2, |c|^2, pad3
  const float* __restrict__ tri_attr;  // [T, 30] woop12 n9 em3 di3 ior refl cone
  const float* __restrict__ sph_attr;  // [S, 12] c3 em3 di3 ior refl cone
  int n_tri;
  int n_sph;
  int t_pad;
  float env[3];
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// A scene table read: through the read-only cache, or from shared memory.
template <bool SMEM>
__device__ __forceinline__ float ldf(const float* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}

template <bool SMEM>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}

// Spheres: smallpt quadratic in the expanded form of the TPU kernel; the
// lowest sphere index wins a tie. Seeds (best_t, best_i).
template <bool SMEM = false>
__device__ __forceinline__ void sphere_search(const SceneView& s, const Ray& r,
                                              float eps, float& best_t,
                                              int& best_i) {
  if (s.n_sph <= 0) return;
  const float od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  const float oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  float ct = kInf;
  int ci = 0;
  for (int i = 0; i < s.n_sph; ++i) {
    const float* sp = s.sph + 8 * i;
    const float4 c = ld4<SMEM>(reinterpret_cast<const float4*>(sp));
    const float cx = c.x, cy = c.y, cz = c.z;
    const float b = cx * r.dx + cy * r.dy + cz * r.dz - od;
    const float det = b * b - ldf<SMEM>(sp + 4) +
                      2.0f * (cx * r.ox + cy * r.oy + cz * r.oz) - oo + c.w;
    const bool ok = det >= 0.0f;
    const float sq = sqrtf(ok ? det : 0.0f);
    const float minus_t = b - sq;
    const float plus_t = b + sq;
    float t = minus_t > eps ? minus_t : plus_t;
    t = (ok && t > eps) ? t : kInf;
    if (t < ct) {
      ct = t;
      ci = i;
    }
  }
  if (ct < best_t) {
    best_t = ct;
    best_i = ci + s.n_tri;
  }
}

// The ray's distance to one Woop triangle (w0..w11: the u, v, w rows of its
// affine map): +inf unless it is a valid hit beyond eps. Every triangle test
// of every kernel is this arithmetic, so the resident scan (rows from global
// memory) and the stream scan (rows from shared memory) round alike.
__device__ __forceinline__ float woop_hit_t(float w0, float w1, float w2, float w3,
                                            float w4, float w5, float w6, float w7,
                                            float w8, float w9, float w10, float w11,
                                            const Ray& r, float eps) {
  const float o_u = w0 * r.ox + w1 * r.oy + w2 * r.oz + w3;
  const float o_v = w4 * r.ox + w5 * r.oy + w6 * r.oz + w7;
  const float o_w = w8 * r.ox + w9 * r.oy + w10 * r.oz + w11;
  const float d_u = w0 * r.dx + w1 * r.dy + w2 * r.dz;
  const float d_v = w4 * r.dx + w5 * r.dy + w6 * r.dz;
  const float d_w = w8 * r.dx + w9 * r.dy + w10 * r.dz;
  const bool not_par = fabsf(d_w) > kParallelEps;
  const float den = not_par ? d_w : 1.0f;
  float rcp = 1.0f / den;
  rcp = rcp * (2.0f - den * rcp);
  const float t = -o_w * rcp;
  const float u = o_u + t * d_u;
  const float v = o_v + t * d_v;
  const bool valid = not_par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps;
  return valid ? t : kInf;
}

// One chunk of triangles [c0, c0 + tc) (clipped to n_tri). Within the chunk
// the lowest row wins a tie; the chunk must be strictly nearer than best_t.
// PACKED folds the row into the low 6 bits of t's bit pattern (one minimum;
// t rounds down by up to 63 ulp), as the TPU krng kernel does. A row is
// three float4 loads (the table is 16-byte aligned: 48 B a row).
template <bool PACKED, bool SMEM = false>
__device__ __forceinline__ void triangle_chunk(const SceneView& s, const Ray& r,
                                               float eps, int c0, int tc,
                                               float& best_t, int& best_i) {
  const int end = min(c0 + tc, s.n_tri);
  float ct = kInf;
  int ci = 0;
  int cp = 0x7FFFFFFF;
  for (int j = c0; j < end; ++j) {
    const float4* w = reinterpret_cast<const float4*>(s.tri) + 3 * j;
    const float4 a = ld4<SMEM>(w), b = ld4<SMEM>(w + 1), c = ld4<SMEM>(w + 2);
    const float t =
        woop_hit_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, r, eps);
    if (PACKED) {
      const int pk = (__float_as_int(t) & ~63) | (j - c0);
      cp = min(cp, pk);
    } else if (t < ct) {
      ct = t;
      ci = j - c0;
    }
  }
  if (PACKED) {
    ct = __int_as_float(cp & ~63);
    ci = cp & 63;
  }
  if (ct < best_t) {
    best_t = ct;
    best_i = c0 + ci;
  }
}

// The ray's parameter range [tmin, tmax] inside an axis-aligned box
// (lo3 hi3 at box), from the reciprocal direction.
__device__ __forceinline__ void slab_range(const float* box, const Ray& r, float idx_,
                                           float idy, float idz, float& tmin, float& tmax) {
  const float t0x = (__ldg(box) - r.ox) * idx_;
  const float t1x = (__ldg(box + 3) - r.ox) * idx_;
  const float t0y = (__ldg(box + 1) - r.oy) * idy;
  const float t1y = (__ldg(box + 4) - r.oy) * idy;
  const float t0z = (__ldg(box + 2) - r.oz) * idz;
  const float t1z = (__ldg(box + 5) - r.oz) * idz;
  tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) > kSafeDir ? d : kSafeDir;
}

// Nearest hit of one live ray by a scan of every primitive. Returns best_t
// (+inf: miss) and the packed index (triangles [0, T), spheres [T, T+S)).
// The culled searches are stream_tri.cuh's, over a PackedSceneStream's
// window boxes; they find the same winner.
template <bool PACKED, bool SMEM = false>
__device__ __forceinline__ void winner_search(const SceneView& s, const Ray& r,
                                              float eps, float& best_t, int& best_i) {
  best_t = kInf;
  best_i = 0;
  sphere_search<SMEM>(s, r, eps, best_t, best_i);
  const int tc = min(s.t_pad, kTc);
  for (int c0 = 0; c0 < s.n_tri; c0 += tc)
    triangle_chunk<PACKED, SMEM>(s, r, eps, c0, tc, best_t, best_i);
}

__device__ __forceinline__ void normalise3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, kNormFloor));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// OrthoNormalBasis::fromZ with the 0.9999 coincident guard.
__device__ __forceinline__ void onb_from_z(float zx, float zy, float zz,
                                           float& xx, float& xy, float& xz,
                                           float& yx, float& yy, float& yz) {
  const bool use_y = fabsf(zx) > kCoincident;
  const float px = use_y ? 0.0f : 1.0f;
  const float py = use_y ? 1.0f : 0.0f;
  xx = py * zz;
  xy = -px * zz;
  xz = px * zy - py * zx;
  normalise3(xx, xy, xz);
  yx = zy * xz - zz * xy;
  yy = zz * xx - zx * xz;
  yz = zx * xy - zy * xx;
  normalise3(yx, yy, yz);
}

// One shading event of a lane whose ray hit primitive idx at distance t.
// st: org3 dir3 beta3 alive1 (updated in place); acc += beta * emission.
// NO_GLOSSY: every material's cone angle is below 1e-9, so the cone sample
// is the mirror direction (exactly what the glossy branch would select).
template <bool NO_GLOSSY, bool SMEM = false>
__device__ __forceinline__ void shade(const SceneView& s, float* st, float* acc,
                                      float t, int idx, float u, float acos_u,
                                      float v, float p) {
  const float ox = st[0], oy = st[1], oz = st[2];
  const float dx = st[3], dy = st[4], dz = st[5];
  const float bx = st[6], by = st[7], bz = st[8];
  const float px_ = ox + t * dx;
  const float py_ = oy + t * dy;
  const float pz_ = oz + t * dz;
  float nx, ny, nz, emr, emg, emb, dir_, dig, dib, ior, refl0, cone;
  bool inside;
  if (idx < s.n_tri) {
    const float* a = s.tri_attr + (size_t)kTriAttr * idx;
    float av[kTriAttr];
#pragma unroll
    for (int k = 0; k < kTriAttr; ++k) av[k] = ldf<SMEM>(a + k);
    const float o_u = av[0] * ox + av[1] * oy + av[2] * oz + av[3];
    const float o_v = av[4] * ox + av[5] * oy + av[6] * oz + av[7];
    const float d_u = av[0] * dx + av[1] * dy + av[2] * dz;
    const float d_v = av[4] * dx + av[5] * dy + av[6] * dz;
    const float d_w = av[8] * dx + av[9] * dy + av[10] * dz;
    const float uu = o_u + t * d_u;
    const float vv = o_v + t * d_v;
    float inx = av[12] + uu * (av[15] - av[12]) + vv * (av[18] - av[12]);
    float iny = av[13] + uu * (av[16] - av[13]) + vv * (av[19] - av[13]);
    float inz = av[14] + uu * (av[17] - av[14]) + vv * (av[20] - av[14]);
    normalise3(inx, iny, inz);
    inside = d_w > 0.0f;
    const float flip = inside ? -1.0f : 1.0f;
    nx = inx * flip;
    ny = iny * flip;
    nz = inz * flip;
    emr = av[21]; emg = av[22]; emb = av[23];
    dir_ = av[24]; dig = av[25]; dib = av[26];
    ior = av[27]; refl0 = av[28]; cone = av[29];
  } else {
    const float* a = s.sph_attr + (size_t)kSphAttr * (idx - s.n_tri);
    float snx = px_ - ldf<SMEM>(a), sny = py_ - ldf<SMEM>(a + 1), snz = pz_ - ldf<SMEM>(a + 2);
    normalise3(snx, sny, snz);
    inside = snx * dx + sny * dy + snz * dz > 0.0f;
    const float flip = inside ? -1.0f : 1.0f;
    nx = snx * flip;
    ny = sny * flip;
    nz = snz * flip;
    emr = ldf<SMEM>(a + 3); emg = ldf<SMEM>(a + 4); emb = ldf<SMEM>(a + 5);
    dir_ = ldf<SMEM>(a + 6); dig = ldf<SMEM>(a + 7); dib = ldf<SMEM>(a + 8);
    ior = ldf<SMEM>(a + 9); refl0 = ldf<SMEM>(a + 10); cone = ldf<SMEM>(a + 11);
  }

  // emission per shading event (Material.cpp:18-21)
  acc[0] = acc[0] + bx * emr;
  acc[1] = acc[1] + by * emg;
  acc[2] = acc[2] + bz * emb;

  // Fresnel-or-fixed reflectivity, with the reference's rPerp == rParallel
  // quirk and the 0/0 guard at the exact-grazing TIR boundary
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

  // mirror direction and cone sample around it (Samples.cpp:6-20)
  const float rdot = 2.0f * (dx * nx + dy * ny + dz * nz);
  const float rx = dx - nx * rdot, ry = dy - ny * rdot, rz = dz - nz * rdot;
  // the cone sample only where it is taken: a specular event on a glossy
  // material (the other lanes of the warp skip it)
  float conex = rx, coney = ry, conez = rz;
  if (!NO_GLOSSY && spec && !(cone < kMirrorEps)) {
    const float theta = cone * (1.0f - 2.0f * acos_u / kPi);
    const float cradius = sinf(theta);
    const float cz_scale = cosf(theta);
    const float rth = v * kTwoPi;
    float cxx, cxy, cxz, cyx, cyy, cyz;
    onb_from_z(rx, ry, rz, cxx, cxy, cxz, cyx, cyy, cyz);
    const float lx = cosf(rth) * cradius;
    const float ly = sinf(rth) * cradius;
    float sx = cxx * lx + cyx * ly + rx * cz_scale;
    float sy = cxy * lx + cyy * ly + ry * cz_scale;
    float sz = cxz * lx + cyz * ly + rz * cz_scale;
    normalise3(sx, sy, sz);
    conex = sx;
    coney = sy;
    conez = sz;
  }

  // cosine hemisphere around the normal (Samples.cpp:22-31)
  float hxx, hxy, hxz, hyx, hyy, hyz;
  onb_from_z(nx, ny, nz, hxx, hxy, hxz, hyx, hyy, hyz);
  const float hth = kTwoPi * u;
  const float hr = sqrtf(fmaxf(v, 0.0f));
  const float hlx = cosf(hth) * hr;
  const float hly = sinf(hth) * hr;
  const float hlz = sqrtf(fmaxf(1.0f - v, 0.0f));
  float hx = hxx * hlx + hyx * hly + nx * hlz;
  float hy = hxy * hlx + hyy * hly + ny * hlz;
  float hz = hxz * hlx + hyz * hly + nz * hlz;
  normalise3(hx, hy, hz);

  const float nbx = spec ? bx : bx * dir_;
  const float nby = spec ? by : by * dig;
  const float nbz = spec ? bz : bz * dib;
  st[0] = px_;
  st[1] = py_;
  st[2] = pz_;
  st[3] = spec ? conex : hx;
  st[4] = spec ? coney : hy;
  st[5] = spec ? conez : hz;
  st[6] = nbx;
  st[7] = nby;
  st[8] = nbz;
  // zero-throughput kill
  st[9] = (nbx != 0.0f || nby != 0.0f || nbz != 0.0f) ? 1.0f : 0.0f;
}

}  // namespace pt3
