// Kernel K8: the adjoint of one replayed shading bounce (the training
// path's backward, launched once per bounce in reverse).
//
// Replaces the JAX package's ops/pallas_megakernel.py _bounce_bwd_kernel /
// _bounce_bwd_body / _run_bounce_bwd / bounce_bwd_step, whose body is
// jax.vjp taken at trace time. Here the reverse mode is written by hand
// (replay.cuh: bounce_bwd_lane), one thread per lane: it recomputes the
// bounce's forward from the saved state and winner, then walks it back.
//
// Outputs: the input-state cotangent [13, N], and the material-table
// gradient (9 rows per material: emission 3, diffuse 3, ior, reflectivity,
// cone angle) plus the environment's 3, summed over lanes. The JAX kernel
// returned per-primitive table gradients that the caller summed by
// material id; here the lane adds into its winner's material directly.
//
// Reduction, deterministic (grad_reduce.cuh): per warp, one butterfly
// shuffle sum per material present in the warp; per block, the four warps'
// sums in warp order into a [cols, blocks] partial table; then one block
// per column sums its partials in a fixed order. No float atomics: the
// same inputs give bit-identical gradients on every run.
//
// Traffic: every lane reads its whole input (state, cotangents, winner and
// uniforms: 4 * (13 + 1 + 1 + 4 + 13) B) and writes its cotangent
// (4 * 13 B), though a dead lane needs only row 9 and the cotangents and a
// live miss adds t and beta.
#include "grad_reduce.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

// partial: [n_col, gridDim.x], n_col = 9 * n_mat + 3 (materials, then env)
__global__ void __launch_bounds__(kBlock)
bounce_bwd_kernel(pt3::SceneView s, const int* __restrict__ tri_mat,
                  const int* __restrict__ sph_mat, const float* __restrict__ state,
                  const float* __restrict__ ts, const int* __restrict__ idxs,
                  const float* __restrict__ unif, const float* __restrict__ cot_out,
                  float* __restrict__ cot_in, float* __restrict__ partial, int n,
                  int n_mat) {
  extern __shared__ float smem[];  // [kWarps, n_col]
  const int n_col = 9 * n_mat + 3;
  for (int i = threadIdx.x; i < kWarps * n_col; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt3::BwdOut o{};
  o.mat = -1;
  if (lane < n) {
    float st[13], C[13];
#pragma unroll
    for (int r = 0; r < 13; ++r) {
      st[r] = state[(size_t)r * n + lane];
      C[r] = cot_out[(size_t)r * n + lane];
    }
    pt3::bounce_bwd_lane(s, tri_mat, sph_mat, st, ts[lane], idxs[lane], unif[lane],
                         unif[(size_t)n + lane], unif[(size_t)2 * n + lane],
                         unif[(size_t)3 * n + lane], C, o);
#pragma unroll
    for (int r = 0; r < 13; ++r) cot_in[(size_t)r * n + lane] = o.cot_in[r];
  }

  // every thread of the block takes part in the shuffles
  pt3::warp_add_grads(o, smem + (threadIdx.x >> 5) * n_col, n_mat);
  __syncthreads();
  pt3::block_partials(smem, kWarps, n_col, partial);
}

}  // namespace

// partial: [9 * n_mat + 3, ceil(n / 128)] scratch; d_out:
// [9 * n_mat + 3] (materials row-major [n_mat, 9], then the environment).
extern "C" int pt3_bounce_bwd(const float* tri, const float* sph,
                              const float* tri_attr, const float* sph_attr,
                              int n_tri, int n_sph, int t_pad, float env_r,
                              float env_g, float env_b, const int* tri_mat,
                              const int* sph_mat, int n_mat, const float* state,
                              const float* ts, const int* idxs, const float* unif,
                              const float* cot_out, float* cot_in, float* partial,
                              float* d_out, int n, void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  const int n_col = 9 * n_mat + 3;
  const size_t smem = sizeof(float) * kWarps * n_col;
  if (n <= 0 || n_mat <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = (n + kBlock - 1) / kBlock;
  bounce_bwd_kernel<<<grid, kBlock, smem, st>>>(s, tri_mat, sph_mat, state, ts, idxs,
                                               unif, cot_out, cot_in, partial, n,
                                               n_mat);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_columns_kernel<<<n_col, pt3::kReduceBlock, 0, st>>>(partial, grid, d_out);
  return (int)cudaGetLastError();
}
