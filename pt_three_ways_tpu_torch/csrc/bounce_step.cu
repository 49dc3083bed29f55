// Kernel K10: one bounce of the compacting wavefront.
//
// Replaces the JAX package's ops/pallas_megakernel.py _bounce_kernel /
// _run_bounce / bounce_step. The path state is [13, N] (org3 dir3 beta3
// alive1 acc3): the radiance accumulator rides in the state, so the
// compaction between bounces (models/integrator.trace_passes_compact, a
// stable partition of the lanes by alive) permutes it with the rest. One
// thread per lane: a live lane runs the winner search without culling and
// with the unpacked winner (as the JAX kernel's intersect_tile), the
// environment on a miss, and pt3_device.cuh's shading with this bounce's
// uniforms (u, acos u, v, p) [4, N]; a dead lane copies its column through.
// cnt [N] is 1 where the lane was alive on entry; with the winner record, t
// [N] (+inf on a miss or a dead lane) and idx [N] (0 there).
//
// Bound: FP32 operations of the winner search of the live lanes (every live
// lane tests every primitive). The bytes, 17 floats in and 14 (16 with the
// record) out per lane, bound the dead lanes, which compaction packs at the
// end.
#include "pt3_device.cuh"

namespace {

constexpr int kBlock = 128;

template <bool NO_GLOSSY, bool WITH_HIT>
__global__ void __launch_bounds__(kBlock)
bounce_step_kernel(pt3::SceneView s, const float* __restrict__ state_in,
                   const float* __restrict__ unif, float* __restrict__ state_out,
                   int* __restrict__ cnt, float* __restrict__ t_out,
                   int* __restrict__ i_out, int n, float eps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float st[10];
  float acc[3];
#pragma unroll
  for (int r = 0; r < 10; ++r) st[r] = state_in[(size_t)r * n + lane];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = state_in[(size_t)(10 + c) * n + lane];
  const bool alive = st[9] != 0.0f;
  float t_rec = pt3::kInf;
  int i_rec = 0;
  if (alive) {
    const pt3::Ray r{st[0], st[1], st[2], st[3], st[4], st[5]};
    float t;
    int idx;
    pt3::winner_search<false>(s, r, eps, t, idx);
    const bool hit = isfinite(t) && t > 0.0f;
    if (!hit) {
      acc[0] = acc[0] + st[6] * s.env[0];
      acc[1] = acc[1] + st[7] * s.env[1];
      acc[2] = acc[2] + st[8] * s.env[2];
    }
    st[9] = 0.0f;
    if (hit) {
      pt3::shade<NO_GLOSSY>(s, st, acc, t, idx, unif[lane], unif[(size_t)n + lane],
                            unif[(size_t)2 * n + lane], unif[(size_t)3 * n + lane]);
      t_rec = t;
      i_rec = idx;
    }
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) state_out[(size_t)r * n + lane] = st[r];
#pragma unroll
  for (int c = 0; c < 3; ++c) state_out[(size_t)(10 + c) * n + lane] = acc[c];
  cnt[lane] = alive ? 1 : 0;
  if (WITH_HIT) {
    t_out[lane] = t_rec;
    i_out[lane] = i_rec;
  }
}

template <bool NO_GLOSSY>
void launch(pt3::SceneView s, const float* state_in, const float* unif, float* state_out,
            int* cnt, float* t_out, int* i_out, int n, float eps, cudaStream_t st) {
  const int grid = (n + kBlock - 1) / kBlock;
  if (t_out != nullptr)
    bounce_step_kernel<NO_GLOSSY, true><<<grid, kBlock, 0, st>>>(
        s, state_in, unif, state_out, cnt, t_out, i_out, n, eps);
  else
    bounce_step_kernel<NO_GLOSSY, false><<<grid, kBlock, 0, st>>>(
        s, state_in, unif, state_out, cnt, t_out, i_out, n, eps);
}

}  // namespace

extern "C" int pt3_bounce_step(const float* tri, const float* sph, const float* tri_attr,
                               const float* sph_attr, int n_tri, int n_sph, int t_pad,
                               float env_r, float env_g, float env_b,
                               const float* state_in, const float* unif, float* state_out,
                               int* cnt, float* t_out, int* i_out, int n, float eps,
                               int no_glossy, void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  if (n <= 0) return (int)cudaGetLastError();
  if ((t_out == nullptr) != (i_out == nullptr) || state_in == state_out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (no_glossy)
    launch<true>(s, state_in, unif, state_out, cnt, t_out, i_out, n, eps, st);
  else
    launch<false>(s, state_in, unif, state_out, cnt, t_out, i_out, n, eps, st);
  return (int)cudaGetLastError();
}
