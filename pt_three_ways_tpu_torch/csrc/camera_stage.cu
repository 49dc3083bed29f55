// Kernel K13: the render's camera stage, as two kernels beside K2 and K11.
//
// Replaces no Pallas kernel: its counterpart in the JAX package is XLA's
// fusion of the camera stage (pt_three_ways_tpu/models/integrator.py:
// _first_bounce_state), which the port first wrote as eager PyTorch
// (models/integrator._first_bounce_state: dozens of elementwise kernels a
// stage and two waits on the card, the aperture test and the basis pivots).
// On the card a render's stage is five launches and no read by the host:
//
//   K11  the camera uniforms (ops/rng.uniforms)
//   K13a camera_rays_kernel: one thread a pixel, ops/camera.generate_rays:
//        pixel jitter, lens disc, focal point; the camera's fields are read
//        from device memory, so lens or pinhole is chosen per thread
//   K2   the winner search (ops/intersect_kernel.intersect_packed)
//   K11  the first-bounce uniforms
//   K13b first_bounce_kernel: one thread a lane (r, k) of the K-fold first
//        bounce: the hit from K2's winner (ops/intersect.hits_from_winner),
//        the material from the pack's attribute rows, Fresnel, the stratified
//        (u, v), the hemisphere and (unless NO_GLOSSY) cone samples with the
//        bases' pivots in registers, the throughput and the kill; it writes
//        the lane's ten state rows and adds the pixel's base colour
//
// The arithmetic follows the eager stage on the card operation for
// operation, so the rows are its rows bit for bit: the build's -fmad=false
// rounds every product and sum alone, as PyTorch's separate elementwise
// kernels do; each fma(a, b, c) of ops/vecmath is a product and a separate
// sum in the order it nests; normalise is 1.0f / sqrtf (IEEE); sinf, cosf,
// acosf and sqrtf are what torch.sin, cos, arccos and sqrt call; and a
// division by a Python number is a product with its float32 reciprocal,
// which is how PyTorch divides a tensor by a scalar on the card (u0, v0 and
// the cone's theta).
//
// Bound: bytes. A lane writes its ten rows (40 B) and reads its three
// uniforms (12 B); a pixel reads its ray, winner and attribute row once per
// block's worth of lanes. The wrapper allocates every output; the kernels
// allocate nothing and launch on PyTorch's current stream.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTriAttr = 30;  // woop 12, vertex normals 9, emission 3, diffuse 3, ior, refl, cone
constexpr int kSphAttr = 12;  // centre 3, emission 3, diffuse 3, ior, refl, cone
constexpr float kTwoPi = 0x1.921fb6p+2f;       // float32(2 pi)
constexpr float kInvPi = 0x1.45f306p-2f;       // float32(1) / float32(pi)
constexpr float kCoincident = 0x1.fff2e4p-1f;  // float32(0.9999)
constexpr float kConeMirror = 0x1.a36e2ep-14f; // float32(1e-4): ops/vecmath.EPSILON
constexpr float kWeightFloor = 0x1.197998p-40f;  // float32(1e-12): branch_weight's clamp

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

// vecmath.dotc: fma(a2, b2, fma(a0, b0, a1 * b1))
__device__ __forceinline__ float dotc(V3 a, V3 b) { return a.z * b.z + (a.x * b.x + a.y * b.y); }

// vecmath.normalise: zero input gives zero
__device__ __forceinline__ V3 normalise(V3 a) {
  const float n2 = dotc(a, a);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
  return {a.x * inv, a.y * inv, a.z * inv};
}

// vecmath.cross: fma(a1, b2, -(a2 * b1)), ...
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z + -(a.z * b.y), a.z * b.x + -(a.x * b.z), a.x * b.y + -(a.y * b.x)};
}

// vecmath.onb_from_z: the pivot (0, 1, 0) where |z.x| > 0.9999, else
// (1, 0, 0), selected in registers
__device__ __forceinline__ void onb_from_z(V3 z, V3& x, V3& y) {
  const bool use_y = fabsf(z.x) > kCoincident;
  const V3 pivot = {use_y ? 0.0f : 1.0f, use_y ? 1.0f : 0.0f, 0.0f};
  x = normalise(cross(pivot, z));
  y = normalise(cross(z, x));
}

// Onb.transform: fma(z, v2, fma(x, v0, y * v1))
__device__ __forceinline__ V3 transform(V3 x, V3 y, V3 z, float v0, float v1, float v2) {
  return {z.x * v2 + (x.x * v0 + y.x * v1), z.y * v2 + (x.y * v0 + y.y * v1),
          z.z * v2 + (x.z * v0 + y.z * v1)};
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ V3 ld3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }

struct CameraView {
  const float* centre;  // [3]
  const float* axis_x;
  const float* axis_y;
  const float* axis_z;
  const float* aspect;  // []
  const float* plane_dist;
  const float* recip_w;
  const float* recip_h;
  const float* aperture;
  const float* focal_dist;
};

// K13a: Camera::randomRay for pixel i (ops/camera.generate_rays)
__global__ void __launch_bounds__(kBlock)
camera_rays_kernel(CameraView cam, const int* __restrict__ px, const int* __restrict__ py,
                   const float* __restrict__ unif, float* __restrict__ org,
                   float* __restrict__ dir, int r) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= r) return;
  const float j0 = unif[i], j1 = unif[r + i], j2 = unif[2 * r + i], j3 = unif[3 * r + i];
  const V3 centre = ld3(cam.centre), ax = ld3(cam.axis_x), ay = ld3(cam.axis_y),
           az = ld3(cam.axis_z);
  const float aspect = __ldg(cam.aspect), plane_dist = __ldg(cam.plane_dist);
  const float aperture = __ldg(cam.aperture), focal = __ldg(cam.focal_dist);
  const float ux = ((float)px[i] + j0) * (2.0f * __ldg(cam.recip_w)) + -1.0f;
  const float uy = ((float)py[i] + j1) * (2.0f * __ldg(cam.recip_h)) + -1.0f;
  const float mx = -ux * aspect;
  const float my = -uy;
  V3 d = normalise({(ax.x * mx + ay.x * my) + az.x * plane_dist,
                    (ax.y * mx + ay.y * my) + az.y * plane_dist,
                    (ax.z * mx + ay.z * my) + az.z * plane_dist});
  V3 o = centre;
  if (aperture > 0.0f) {
    const V3 fp = {d.x * focal + centre.x, d.y * focal + centre.y, d.z * focal + centre.z};
    const float angle = j2 * kTwoPi;
    const float radius = j3 * aperture;
    const float s = sinf(angle) * radius;
    const float c = cosf(angle) * radius;
    o = {ay.x * s + (ax.x * c + centre.x), ay.y * s + (ax.y * c + centre.y),
         ay.z * s + (ax.z * c + centre.z)};
    d = normalise({fp.x - o.x, fp.y - o.y, fp.z - o.z});
  }
  org[i] = o.x;
  org[r + i] = o.y;
  org[2 * r + i] = o.z;
  dir[i] = d.x;
  dir[r + i] = d.y;
  dir[2 * r + i] = d.z;
}

struct FirstBounceArgs {
  const float* tri_attr;  // [T, 30]
  const float* sph_attr;  // [S, 12]
  const float* mat9;      // [M, 9]: material 0, the hit of a scene with no primitive
  int n_tri, n_sph;
  float env[3];
  const float* org;  // [3, R] camera rays (K13a)
  const float* dir;
  const float* t;    // [R] K2's winner: +inf on a miss
  const int* idx;    // [R] packed index: triangles [0, T), spheres [T, T+S)
  const float* fb_u; // [3, R, K] the first bounce's uniforms
  int r, k, nv;
  float inv_nu, inv_nv;  // float32(1) / nu, / nv
  float* state;  // [10, R*K]: org3 dir3 beta3 alive1
  float* base;   // [3, R]
  int accumulate;  // base += the base colour (else base =)
};

// K13b: one lane (r, k) of the first bounce (integrator._first_bounce_state
// after the search)
template <bool NO_GLOSSY, bool KILL_DEAD>
__global__ void __launch_bounds__(kBlock) first_bounce_kernel(FirstBounceArgs a) {
  const long long n = (long long)a.r * a.k;
  const long long lane = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (lane >= n) return;
  const int r = (int)(lane / a.k);
  const int kk = (int)(lane - (long long)r * a.k);
  const V3 o = {a.org[r], a.org[a.r + r], a.org[2 * a.r + r]};
  const V3 d = {a.dir[r], a.dir[a.r + r], a.dir[2 * a.r + r]};
  const float t = a.t[r];
  const int idx = a.idx[r];

  // hits_from_winner
  const bool hit = isfinite(t);
  const float ts = hit ? t : 0.0f;
  const V3 pos = {ts * d.x + o.x, ts * d.y + o.y, ts * d.z + o.z};
  const bool tri_wins = idx < a.n_tri;
  V3 nrm;
  bool inside;
  const float* mat;
  if (a.n_tri > 0 && (tri_wins || a.n_sph == 0)) {
    // _triangle_shade_info: the winner's (u, v), interpolated normal,
    // backface flip
    const float* av = a.tri_attr + (size_t)kTriAttr * (tri_wins ? idx : 0);
    float c[21];
#pragma unroll
    for (int j = 0; j < 21; ++j) c[j] = __ldg(av + j);
    const float o_u = (c[2] * o.z + (c[0] * o.x + c[1] * o.y)) + c[3];
    const float o_v = (c[6] * o.z + (c[4] * o.x + c[5] * o.y)) + c[7];
    const float d_u = c[2] * d.z + (c[0] * d.x + c[1] * d.y);
    const float d_v = c[6] * d.z + (c[4] * d.x + c[5] * d.y);
    const float d_w = c[10] * d.z + (c[8] * d.x + c[9] * d.y);
    const float u = ts * d_u + o_u;
    const float v = ts * d_v + o_v;
    const float* nn = c + 12;
    const V3 in = normalise({v * (nn[6] - nn[0]) + (u * (nn[3] - nn[0]) + nn[0]),
                             v * (nn[7] - nn[1]) + (u * (nn[4] - nn[1]) + nn[1]),
                             v * (nn[8] - nn[2]) + (u * (nn[5] - nn[2]) + nn[2])});
    inside = d_w > 0.0f;
    nrm = inside ? neg(in) : in;
    mat = av + 21;
  } else if (a.n_sph > 0) {
    const float* sv = a.sph_attr + (size_t)kSphAttr * (tri_wins ? 0 : idx - a.n_tri);
    const V3 ns = normalise({pos.x - __ldg(sv), pos.y - __ldg(sv + 1), pos.z - __ldg(sv + 2)});
    inside = dotc(ns, d) > 0.0f;
    nrm = inside ? neg(ns) : ns;
    mat = sv + 3;
  } else {
    nrm = {0.0f, 0.0f, 0.0f};
    inside = false;
    mat = a.mat9;
  }
  const V3 em = ld3(mat), di = ld3(mat + 3);
  const float ior = __ldg(mat + 6), refl0 = __ldg(mat + 7), cone = __ldg(mat + 8);

  if (kk == 0) {  // the pixel's base colour: emission where hit, else the environment
    const float b[3] = {hit ? em.x : a.env[0], hit ? em.y : a.env[1], hit ? em.z : a.env[2]};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* p = a.base + (size_t)c * a.r + r;
      *p = a.accumulate ? *p + b[c] : b[c];
    }
  }

  // effective_reflectivity: Fresnel (vecmath.reflectance) or the fixed value
  const float ior_from = inside ? ior : 1.0f;
  const float ior_to = inside ? 1.0f : ior;
  const float ratio = ior_from / ior_to;
  const float cos_i = -dotc(d, nrm);
  const float sin_t_sq = ratio * ratio * (-cos_i * cos_i + 1.0f);
  const float ct2 = 1.0f - sin_t_sq;
  const float cos_t = ct2 > 0.0f ? sqrtf(ct2) : 0.0f;
  const float den = ior_from * cos_i + ior_to * cos_t;
  const float r_perp = den > 0.0f ? (ior_from * cos_i - ior_to * cos_t) / den : 1.0f;
  const float fresnel = sin_t_sq > 1.0f ? 1.0f : r_perp * r_perp;
  const float refl = refl0 < 0.0f ? fresnel : refl0;

  // the stratified first-bounce uniforms (_first_bounce_uniforms)
  const float u0 = ((float)(kk / a.nv) + a.fb_u[lane]) * a.inv_nu;
  const float v0 = ((float)(kk % a.nv) + a.fb_u[n + lane]) * a.inv_nv;
  const bool spec = a.fb_u[2 * n + lane] < refl;

  V3 dir1;
  if (spec) {
    // the mirror direction (vecmath.reflect), or the cone sample around it
    const float s = dotc(d, nrm) * 2.0f;
    const V3 mirror = {-nrm.x * s + d.x, -nrm.y * s + d.y, -nrm.z * s + d.z};
    dir1 = mirror;
    if (!NO_GLOSSY && !(cone < kConeMirror)) {
      const float theta = cone * (1.0f - (acosf(fminf(fmaxf(u0, 0.0f), 1.0f)) * 2.0f) * kInvPi);
      const float radius = sinf(theta);
      const float z_scale = cosf(theta);
      const float rt = v0 * kTwoPi;
      V3 bx, by;
      onb_from_z(mirror, bx, by);
      dir1 = normalise(transform(bx, by, mirror, cosf(rt) * radius, sinf(rt) * radius, z_scale));
    }
  } else {
    // the cosine hemisphere around the normal (vecmath.hemisphere_sample)
    V3 bx, by;
    onb_from_z(nrm, bx, by);
    const float theta = u0 * kTwoPi;
    const float radius = sqrtf(v0);
    const float hz = 1.0f - v0;
    dir1 = normalise(transform(bx, by, nrm, cosf(theta) * radius, sinf(theta) * radius,
                               hz > 0.0f ? sqrtf(hz) : 0.0f));
  }

  // branch_weight (1.0 in the forward) and the throughput
  const float w = spec ? refl / clamp_lo(refl, kWeightFloor)
                       : (1.0f - refl) / clamp_lo(1.0f - refl, kWeightFloor);
  const V3 beta = {(spec ? 1.0f : di.x) * w, (spec ? 1.0f : di.y) * w, (spec ? 1.0f : di.z) * w};
  bool alive = hit;
  if (KILL_DEAD) alive = alive && (beta.x != 0.0f || beta.y != 0.0f || beta.z != 0.0f);

  float* st = a.state + lane;
  const float row[10] = {pos.x,  pos.y,  pos.z,  dir1.x, dir1.y,
                         dir1.z, beta.x, beta.y, beta.z, alive ? 1.0f : 0.0f};
#pragma unroll
  for (int j = 0; j < 10; ++j) st[(size_t)j * n] = row[j];
}

}  // namespace

// K13a. px, py: [r] int32; unif: [4, r]; the camera's fields: float32 on the
// card ([3] vectors, [] scalars); org, dir: [3, r] float32.
extern "C" int pt3_camera_rays(const void* px, const void* py, const void* unif,
                               const void* centre, const void* axis_x, const void* axis_y,
                               const void* axis_z, const void* aspect, const void* plane_dist,
                               const void* recip_w, const void* recip_h, const void* aperture,
                               const void* focal_dist, void* org, void* dir, int r,
                               void* stream) {
  if (r < 0) return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaGetLastError();
  const CameraView cam = {(const float*)centre,   (const float*)axis_x,  (const float*)axis_y,
                          (const float*)axis_z,   (const float*)aspect,  (const float*)plane_dist,
                          (const float*)recip_w,  (const float*)recip_h, (const float*)aperture,
                          (const float*)focal_dist};
  const unsigned grid = (unsigned)((r + kBlock - 1) / kBlock);
  camera_rays_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      cam, (const int*)px, (const int*)py, (const float*)unif, (float*)org, (float*)dir, r);
  return (int)cudaGetLastError();
}

// K13b. r pixels of k = nu * nv lanes each; state: [10, r*k] (a stage's
// slice of a launch's state0: rows of r*k floats); base: [3, r].
extern "C" int pt3_first_bounce(const void* tri_attr, const void* sph_attr, const void* mat9,
                                int n_tri, int n_sph, float env_r, float env_g, float env_b,
                                const void* org, const void* dir, const void* t, const void* idx,
                                const void* fb_u, int r, int k, int nv, float inv_nu,
                                float inv_nv, void* state, void* base, int accumulate,
                                int no_glossy, int kill_dead, void* stream) {
  if (r < 0 || k < 1 || nv < 1 || k % nv) return (int)cudaErrorInvalidValue;
  const long long n = (long long)r * k;
  if (n == 0) return (int)cudaGetLastError();
  const long long grid = (n + kBlock - 1) / kBlock;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  FirstBounceArgs a;
  a.tri_attr = (const float*)tri_attr;
  a.sph_attr = (const float*)sph_attr;
  a.mat9 = (const float*)mat9;
  a.n_tri = n_tri;
  a.n_sph = n_sph;
  a.env[0] = env_r;
  a.env[1] = env_g;
  a.env[2] = env_b;
  a.org = (const float*)org;
  a.dir = (const float*)dir;
  a.t = (const float*)t;
  a.idx = (const int*)idx;
  a.fb_u = (const float*)fb_u;
  a.r = r;
  a.k = k;
  a.nv = nv;
  a.inv_nu = inv_nu;
  a.inv_nv = inv_nv;
  a.state = (float*)state;
  a.base = (float*)base;
  a.accumulate = accumulate;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = (unsigned)grid;
  if (no_glossy) {
    if (kill_dead)
      first_bounce_kernel<true, true><<<g, kBlock, 0, st>>>(a);
    else
      first_bounce_kernel<true, false><<<g, kBlock, 0, st>>>(a);
  } else {
    if (kill_dead)
      first_bounce_kernel<false, true><<<g, kBlock, 0, st>>>(a);
    else
      first_bounce_kernel<false, false><<<g, kBlock, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
