// Kernel K7: nb bounces of one sample pass, with the path-replay residuals
// on request (the training path's forward).
//
// Replaces the JAX package's ops/pallas_megakernel.py _megakernel /
// _run_fused / fused_bounces. One thread per lane keeps the path state in
// registers for all nb bounces (replay.cuh: fused_bounces_lane, with its
// shading from pt3_device.cuh); the uniforms come from the [4 * nb, N]
// table, the acos row precomputed outside. With residuals it also writes
// each bounce's input state [13 * nb, N] and winner record (t [nb, N],
// idx [nb, N]).
//
// The winner search is culled: stream_tri.cuh culled_search_warp_near, K2's,
// over the window boxes of a PackedSceneStream (level-1 boxes, then 64-row
// windows nearest entry first, each entered (ray, window) pair's tests
// spread over the warp), with the unpacked rule, so the winners are the
// unculled scan's bit for bit. The warp runs all nb bounces together; a thread past n stays in it
// as an inactive lane (the search's shuffles and ballots take the full
// warp).
//
// Bound: FP32 operations of the triangle tests in the windows each ray
// enters, or the bytes (state and uniforms in; radiance, counts and
// residuals out: 4 * (10 + 4 nb) in, 4 * (4 + 15 nb) out per lane), which
// after culling may be the larger.
#include "replay.cuh"

namespace {

constexpr int kBlock = 128;

template <bool NO_GLOSSY, bool EMIT>
__global__ void __launch_bounds__(kBlock)
fused_bounces_kernel(pt3::SceneView s, pt3::StreamView w, const float* __restrict__ org,
                     const float* __restrict__ dir, const float* __restrict__ beta,
                     const float* __restrict__ alive, const float* __restrict__ unif,
                     float* __restrict__ acc_out, int* __restrict__ cnt_out,
                     float* __restrict__ states, float* __restrict__ ts,
                     int* __restrict__ idxs, int n, int nb, float eps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < n;
  const int li = valid ? lane : 0;
  float st[10];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    st[c] = org[(size_t)c * n + li];
    st[3 + c] = dir[(size_t)c * n + li];
    st[6 + c] = beta[(size_t)c * n + li];
  }
  st[9] = alive[li];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int cnt = 0;
  pt3::fused_bounces_lane<NO_GLOSSY, EMIT>(s, w, st, acc, cnt, unif, states, ts, idxs,
                                           lane, n, nb, eps, valid);
  if (!valid) return;
  acc_out[lane] = acc[0];
  acc_out[(size_t)n + lane] = acc[1];
  acc_out[(size_t)2 * n + lane] = acc[2];
  cnt_out[lane] = cnt;
}

template <bool NO_GLOSSY>
void launch(pt3::SceneView s, const pt3::StreamView& w, const float* org, const float* dir,
            const float* beta, const float* alive, const float* unif, float* acc, int* cnt,
            float* states, float* ts, int* idxs, int n, int nb, float eps, cudaStream_t st) {
  const int grid = (n + kBlock - 1) / kBlock;
  if (states != nullptr)
    fused_bounces_kernel<NO_GLOSSY, true><<<grid, kBlock, 0, st>>>(
        s, w, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps);
  else
    fused_bounces_kernel<NO_GLOSSY, false><<<grid, kBlock, 0, st>>>(
        s, w, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps);
}

}  // namespace

extern "C" int pt3_fused_bounces(const float* tri, const float* sph,
                                 const float* tri_attr, const float* sph_attr,
                                 int n_tri, int n_sph, int t_pad, float env_r,
                                 float env_g, float env_b, const float* org,
                                 const float* dir, const float* beta,
                                 const float* alive, const float* unif, float* acc,
                                 int* cnt, float* states, float* ts, int* idxs,
                                 const float* wbox, const float* wbox1, int n_windows,
                                 int n_groups, int window, int fan, int n, int nb,
                                 float eps, int no_glossy, void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  if (n <= 0) return (int)cudaGetLastError();
  if ((states != nullptr && (ts == nullptr || idxs == nullptr)) || wbox == nullptr ||
      wbox1 == nullptr || n_windows <= 0 || window <= 0 || window % pt3::kTc != 0 ||
      fan < 1 || n_groups != (n_windows + fan - 1) / fan ||
      (size_t)n_windows * window < (size_t)n_tri)
    return (int)cudaErrorInvalidValue;
  const pt3::StreamView w{nullptr, wbox, wbox1, n_windows, n_groups, window, fan};
  cudaStream_t st = (cudaStream_t)stream;
  if (no_glossy)
    launch<true>(s, w, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps, st);
  else
    launch<false>(s, w, org, dir, beta, alive, unif, acc, cnt, states, ts, idxs, n, nb, eps,
                  st);
  return (int)cudaGetLastError();
}
