// Deterministic sums of material and environment gradients over lanes,
// shared by kernels K8 (bounce_bwd.cu), K9 (regen_replay_bwd.cu) and K12
// (material_grad.cu, in float or double). No float atomics: the same inputs
// give bit-identical gradients on every run.
//
//   * warp_add_mat and warp_add_env (K8 each step; K9 at the end of its
//     walk, and for a material that finds no accumulator of its thread;
//     K12 where a thread's material changes, and at the end): per warp,
//     one butterfly shuffle sum per material present in the warp
//     (materials visited in lane order) and one per environment channel,
//     which lane 0 adds into the warp's row of shared memory ([9 * n_mat +
//     3] words: materials row-major, then the environment; K12's rows have
//     no environment). Every lane of the warp must call them.
//   * block_partials (K9, K12): a block's warp rows summed in warp order
//     into column blockIdx.x of a [9 * n_mat (+ 3), blocks] partial table.
//   * reduce_columns_kernel (K9's and K12's second launch): one block per
//     column sums its partials in a fixed thread-strided order and a fixed
//     shared-memory tree. K8 sums its partials in its own last block
//     (bounce_bwd.cu).
#pragma once

#include "replay.cuh"

namespace pt3 {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kReduceBlock = 256;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The warp's environment gradient g3 added into its row (lane 0).
__device__ __forceinline__ void warp_add_env(const float* g3, float* ws, int n_mat) {
  const int wl = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = warp_sum(g3[c]);
    if (wl == 0) ws[9 * n_mat + c] = ws[9 * n_mat + c] + v;
  }
}

// Each lane's material gradient g9 of material `mat` (-1: none) added into
// the warp's row: one sum per material present, in order of the lowest lane
// that holds it.
template <typename T>
__device__ __forceinline__ void warp_add_mat(int mat, const T* g9, T* ws, int n_mat) {
  const int wl = threadIdx.x & 31;
  unsigned todo = __ballot_sync(kFullMask, mat >= 0);
  while (todo) {
    const int m = __shfl_sync(kFullMask, mat, __ffs(todo) - 1);
    const bool mine = mat == m;
    todo &= ~__ballot_sync(kFullMask, mine);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T v = warp_sum(mine ? g9[k] : T(0));
      if (wl == 0) ws[9 * m + k] = ws[9 * m + k] + v;
    }
  }
}

template <typename T>
__device__ __forceinline__ void block_partials(const T* smem, int n_warps, int n_col,
                                               T* __restrict__ partial) {
  for (int c = threadIdx.x; c < n_col; c += blockDim.x) {
    T sum = smem[c];
    for (int w = 1; w < n_warps; ++w) sum = sum + smem[w * n_col + c];
    partial[(size_t)c * gridDim.x + blockIdx.x] = sum;
  }
}

}  // namespace pt3

namespace {

// out[c] = sum of partial[c, 0:rows] in a fixed order (one block per column)
template <typename T>
__global__ void __launch_bounds__(pt3::kReduceBlock)
reduce_columns_kernel(const T* __restrict__ partial, int rows, T* __restrict__ out) {
  __shared__ T sm[pt3::kReduceBlock];
  const T* col = partial + (size_t)blockIdx.x * rows;
  T sum = T(0);
  for (int r = threadIdx.x; r < rows; r += pt3::kReduceBlock) sum = sum + col[r];
  sm[threadIdx.x] = sum;
  __syncthreads();
  for (int w = pt3::kReduceBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sm[threadIdx.x] = sm[threadIdx.x] + sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sm[0];
}

}  // namespace
