// Kernel K7: nb bounces of one sample pass, with the path-replay residuals
// on request (the training path's forward).
//
// Replaces the JAX package's ops/pallas_megakernel.py _megakernel /
// _run_fused / fused_bounces. One thread per lane keeps the path state in
// registers for all nb bounces (replay.cuh: fused_bounces_lane, with
// pt3_device.cuh's winner search without culling and its shading); the
// uniforms come from the [4 * nb, N] table, the acos row precomputed
// outside. With residuals it also writes each bounce's input state
// [13 * nb, N] and winner record (t [nb, N], idx [nb, N]).
//
// Bound: FP32 operations of the winner search (every live lane tests every
// primitive). The bytes (state and uniforms in; radiance, counts and
// residuals out: 4 * (10 + 4 nb) in, 4 * (4 + 15 nb) out per lane) are
// second to it on mesh scenes.
#include "replay.cuh"

namespace {

constexpr int kBlock = 128;

template <bool NO_GLOSSY, bool EMIT>
__global__ void __launch_bounds__(kBlock)
fused_bounces_kernel(pt3::SceneView s, const float* __restrict__ org,
                     const float* __restrict__ dir, const float* __restrict__ beta,
                     const float* __restrict__ alive, const float* __restrict__ unif,
                     float* __restrict__ acc_out, int* __restrict__ cnt_out,
                     float* __restrict__ states, float* __restrict__ ts,
                     int* __restrict__ idxs, int n, int nb, float eps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float st[10];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    st[c] = org[(size_t)c * n + lane];
    st[3 + c] = dir[(size_t)c * n + lane];
    st[6 + c] = beta[(size_t)c * n + lane];
  }
  st[9] = alive[lane];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int cnt = 0;
  pt3::fused_bounces_lane<NO_GLOSSY, EMIT>(s, st, acc, cnt, unif, states, ts, idxs,
                                           lane, n, nb, eps);
  acc_out[lane] = acc[0];
  acc_out[(size_t)n + lane] = acc[1];
  acc_out[(size_t)2 * n + lane] = acc[2];
  cnt_out[lane] = cnt;
}

template <bool NO_GLOSSY>
void launch(pt3::SceneView s, const float* org, const float* dir, const float* beta,
            const float* alive, const float* unif, float* acc, int* cnt, float* states,
            float* ts, int* idxs, int n, int nb, float eps, cudaStream_t st) {
  const int grid = (n + kBlock - 1) / kBlock;
  if (states != nullptr)
    fused_bounces_kernel<NO_GLOSSY, true><<<grid, kBlock, 0, st>>>(
        s, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps);
  else
    fused_bounces_kernel<NO_GLOSSY, false><<<grid, kBlock, 0, st>>>(
        s, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps);
}

}  // namespace

extern "C" int pt3_fused_bounces(const float* tri, const float* sph,
                                 const float* tri_attr, const float* sph_attr,
                                 int n_tri, int n_sph, int t_pad, float env_r,
                                 float env_g, float env_b, const float* org,
                                 const float* dir, const float* beta,
                                 const float* alive, const float* unif, float* acc,
                                 int* cnt, float* states, float* ts, int* idxs,
                                 int n, int nb, float eps, int no_glossy,
                                 void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  if (n <= 0) return (int)cudaGetLastError();
  if (states != nullptr && (ts == nullptr || idxs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (no_glossy)
    launch<true>(s, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps, st);
  else
    launch<false>(s, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps, st);
  return (int)cudaGetLastError();
}
