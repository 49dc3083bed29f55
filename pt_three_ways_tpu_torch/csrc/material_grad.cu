// Kernel K12: the VJP of the material gather (models/integrator.py
// gather_materials): the material table's gradient, each lane's cotangent
// summed into the row of its material id.
//
// Replaces no Pallas kernel: its counterpart in the JAX package is XLA's
// transpose of the gather in pt_three_ways_tpu/models/integrator.py
// gather_materials, a scatter-add. PyTorch's autograd made each of the
// five indexed loads an accumulating index_put_, which on the card sorts
// the lanes by index and then walks each run of equal indices serially in
// one warp: a handful of materials over 262,144 camera lanes took ~109 ms
// of a training pass on the H100 (PERF.md).
//
// In: ids [N] int32 (the gather's material ids) and cot [9, N] (the five
// cotangents as rows: emission 3, diffuse 3, ior, reflectivity, cone
// angle), float or double. Out: [n_mat, 9], material-major.
//
// Bound: bytes, 40 a lane in float (the id and nine cotangents, read once):
// 10.5 MB for a 512^2 camera stage, 3.1 us at 3.35 TB/s. Design:
//
//   * a warp takes tiles of 32 consecutive lanes, grid-strided, so the id
//     row and every cotangent row load coalesced, 128 B a warp and row;
//   * a thread keeps a running sum of its lanes' rows in registers while
//     their material stays the same. Where it changes, the warp adds the
//     finished sums of the lanes that changed into its row of shared
//     memory (grad_reduce.cuh warp_add_mat: one butterfly sum per material
//     present), and once more at the end: a warp whose lanes keep their
//     material shuffles once;
//   * each block sums its warps' rows in warp order into its column of a
//     [9 * n_mat, blocks] partial table (block_partials), and a second
//     launch sums each row in a fixed order (reduce_columns_kernel). No
//     float atomics: the same inputs give bit-identical gradients on every
//     run. The wrapper sets the grid from N alone, so every card sums in
//     the same order;
//   * the warps' rows take kWarps * 9 * n_mat words of shared memory. Where
//     they pass kSmemBudget, the materials are taken in slices over
//     gridDim.y: each slice reads every id and only its own lanes'
//     cotangents. An id outside [0, n_mat) adds nothing.
#include "grad_reduce.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// the warps' rows of one slice: two blocks an SM
constexpr size_t kSmemBudget = 96 * 1024;

template <typename T>
__global__ void __launch_bounds__(kBlock)
material_grad_kernel(const int* __restrict__ ids, const T* __restrict__ cot, int n, int n_mat,
                     int slice, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.y * slice;
  const int ms = min(slice, n_mat - m0);  // the slice's materials
  const int n_col = 9 * ms;
  for (int c = threadIdx.x; c < kWarps * n_col; c += kBlock) smem[c] = T(0);
  __syncthreads();
  T* ws = smem + (threadIdx.x >> 5) * n_col;
  const int wl = threadIdx.x & 31;
  const int n_tiles = (int)(((long long)n + 31) >> 5);
  int cur = -1;  // the material of acc (-1: none yet)
  T acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = T(0);
  for (int tile = blockIdx.x * kWarps + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * kWarps) {
    const long long i = (long long)tile * 32 + wl;
    int m = -1;
    if (i < n) {
      const int id = ids[i] - m0;
      if (id >= 0 && id < ms) m = id;
    }
    T g[9];
    if (m >= 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) g[k] = cot[(size_t)k * n + i];
    }
    const bool flush = m >= 0 && cur >= 0 && m != cur;
    if (__any_sync(pt3::kFullMask, flush)) pt3::warp_add_mat(flush ? cur : -1, acc, ws, ms);
    if (m >= 0) {
      const bool same = m == cur;
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = same ? acc[k] + g[k] : g[k];
      cur = m;
    }
  }
  pt3::warp_add_mat(cur, acc, ws, ms);
  __syncthreads();
  pt3::block_partials(smem, kWarps, n_col, partial + (size_t)9 * m0 * gridDim.x);
}

template <typename T>
int launch(const int* ids, const T* cot, int n, int n_mat, int blocks, T* partial, T* out,
           cudaStream_t st) {
  const int slice = (int)(kSmemBudget / (sizeof(T) * kWarps * 9));
  const int slices = (n_mat + slice - 1) / slice;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * kWarps * 9 * min(n_mat, slice);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        material_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  material_grad_kernel<T><<<dim3(blocks, slices), kBlock, smem, st>>>(ids, cot, n, n_mat, slice,
                                                                       partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_columns_kernel<<<9 * n_mat, pt3::kReduceBlock, 0, st>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ids: [n] int32; cot: [9, n]; partial: [9 * n_mat, blocks] scratch; out:
// [n_mat, 9]; dtype 0 float, 1 double (cot, partial and out alike).
// Returns cudaErrorInvalidValue for n < 0, n_mat < 1, blocks < 1 or
// another dtype.
extern "C" int pt3_material_grad(const int* ids, const void* cot, int n, int n_mat, int blocks,
                                 void* partial, void* out, int dtype, void* stream) {
  if (n < 0 || n_mat < 1 || n_mat > 0x7FFFFFFF / 9 || blocks < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(ids, (const float*)cot, n, n_mat, blocks, (float*)partial, (float*)out, st);
  return launch(ids, (const double*)cot, n, n_mat, blocks, (double*)partial, (double*)out, st);
}
