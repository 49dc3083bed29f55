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
// Bound: bytes. Past the first bounce most lanes are dead (87-98 % on
// suzanne's train step), and a dead lane needs only its alive row and its
// cotangents. Design on the H100:
//
//   * loads by lane class: every lane reads row 9 of the state, its winner
//     t, its beta rows and the 13 cotangent rows (72 B); a dead lane writes
//     cot_in = C with row 9 zeroed and reads nothing more, and only a hit
//     reads the rest (state rows 0..5, winner index, uniforms). A warp of
//     dead lanes touches none of the other rows' sectors. The per-lane
//     arithmetic is bounce_bwd_lane's, unchanged;
//   * a persistent grid (as many blocks as fit the card at once) walks the
//     lanes block by block. A thread copies the heads of its next lanes
//     into shared memory with cp.async, kStages - 1 steps ahead, so a warp
//     has several lanes' reads in flight while it works: a dead lane's work
//     is a copy, and the bytes in flight set its time;
//   * the registers are capped at 128 (two blocks of 256 an SM): capped
//     lower, the hit adjoint spills on every step and the kernel takes
//     longer (chip_smoke.py times the caps, ALT_BUILDS);
//   * one launch, no float atomics: per warp one butterfly sum per material
//     present and per environment channel each step (grad_reduce.cuh) into
//     the warp's row of shared memory; at the end each block sums its warps'
//     rows in warp order into its row of a [blocks, 9 * n_mat + 3] partial
//     table, and the last block to finish (a ticket counter, which it resets
//     to 0) sums the partials, a warp per column in a fixed order. The same
//     inputs give bit-identical gradients on every run.
//
// What holds it above its bound: a dead lane moves 72 B read and 52 B
// written, and this mix of 31 row streams a warp runs at ~2.2 TB/s on the
// H100; reading a lane at a time, or two lanes a thread in blocks that are
// not persistent, was slower (PERF.md).
#include "grad_reduce.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// blocks of kBlock an SM the registers must allow (128 registers at 2: no
// spills); chip_smoke.py times the tighter caps (ALT_BUILDS)
#ifndef PT3_K8_MIN_BLOCKS
#define PT3_K8_MIN_BLOCKS 2
#endif
constexpr int kMinBlocks = PT3_K8_MIN_BLOCKS;

struct BwdArgs {
  const int* __restrict__ tri_mat;
  const int* __restrict__ sph_mat;
  const float* __restrict__ state;    // [13, N]
  const float* __restrict__ ts;       // [N]
  const int* __restrict__ idxs;       // [N]
  const float* __restrict__ unif;     // [4, N]
  const float* __restrict__ cot_out;  // [13, N]
  float* __restrict__ cot_in;         // [13, N]
  float* __restrict__ partial;        // [gridDim.x, n_col]
  float* __restrict__ d_out;          // [n_col]
  unsigned* ticket;                   // [1], 0 between launches
  int n, n_mat;
};

// What every lane reads, staged in shared memory kStages lanes ahead: its
// alive row, winner t, beta rows and cotangents (kHead rows; a dead lane's
// t and beta are four words beside the 14 it needs, and spare a live lane
// a round trip).
constexpr int kStages = 4;
constexpr int kHead = 18;  // alive, t, beta 3, C 13

// Shared memory, in floats: the warps' rows [kWarps][n_col], then the
// stages [kStages][kHead][kBlock] (a thread's column in each).
__host__ __device__ inline int stage_offset(int n_col) { return kWarps * n_col; }
__host__ __device__ inline size_t smem_bytes(int n_col) {
  return sizeof(float) * ((size_t)stage_offset(n_col) + (size_t)kStages * kHead * kBlock);
}

// Start copying lane's head into this thread's column of a stage.
__device__ __forceinline__ void stage_head(float* stage, const BwdArgs& a, int lane) {
  const size_t n = (size_t)a.n;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(stage + threadIdx.x));
  const float* src[kHead] = {a.state + 9 * n + lane, a.ts + lane, a.state + 6 * n + lane,
                             a.state + 7 * n + lane, a.state + 8 * n + lane};
#pragma unroll
  for (int r = 0; r < 13; ++r) src[5 + r] = a.cot_out + r * n + lane;
#pragma unroll
  for (int r = 0; r < kHead; ++r)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst + 4u * r * kBlock),
                 "l"(src[r])
                 : "memory");
}

__device__ __forceinline__ void commit_stage() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One lane's adjoint from its staged head (h: this thread's column of the
// stage), reading the rest of a hit (state rows 0..5, the winner index and
// the uniforms) from global memory.
__device__ __forceinline__ void lane_bwd(const pt3::SceneView& s, const BwdArgs& a, int lane,
                                         const float* h, pt3::BwdOut& o) {
  const size_t n = (size_t)a.n;
  float st[13], C[13];
#pragma unroll
  for (int r = 0; r < 13; ++r) {
    st[r] = 0.0f;  // the adjoint never reads the acc rows
    C[r] = h[(5 + r) * kBlock];
  }
  st[9] = h[0];
  const float t = h[kBlock];
  int idx = 0;
  float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (st[9] != 0.0f) {
#pragma unroll
    for (int r = 0; r < 3; ++r) st[6 + r] = h[(2 + r) * kBlock];
    if (isfinite(t) && t > 0.0f) {
#pragma unroll
      for (int r = 0; r < 6; ++r) st[r] = a.state[r * n + lane];
      idx = a.idxs[lane];
#pragma unroll
      for (int k = 0; k < 4; ++k) u[k] = a.unif[k * n + lane];
    }
  }
  pt3::bounce_bwd_lane(s, a.tri_mat, a.sph_mat, st, t, idx, u[0], u[1], u[2], u[3], C, o);
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
bounce_bwd_kernel(pt3::SceneView s, BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  const int n_col = 9 * a.n_mat + 3;
  for (int i = threadIdx.x; i < kWarps * n_col; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  float* ws = smem + (threadIdx.x >> 5) * n_col;
  float* stages = smem + stage_offset(n_col);

  // every thread of the block runs every step (the warp sums take the
  // warp); each step first starts the copy of the lane kStages - 1 steps
  // ahead, then waits for its own lane's (one commit group a step, empty
  // past the end)
  const int stride = gridDim.x * kBlock;
  int lane = blockIdx.x * kBlock + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (lane + k * stride < a.n) stage_head(stages + k * kHead * kBlock, a, lane + k * stride);
    commit_stage();
  }
  for (int step = 0, base = blockIdx.x * kBlock; base < a.n;
       ++step, base += stride, lane += stride) {
    const int ahead = lane + (kStages - 1) * stride;
    if (ahead < a.n)
      stage_head(stages + ((step + kStages - 1) % kStages) * kHead * kBlock, a, ahead);
    commit_stage();
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    pt3::BwdOut o;
#pragma unroll
    for (int k = 0; k < 9; ++k) o.g_mat[k] = 0.0f;
    o.g_env[0] = o.g_env[1] = o.g_env[2] = 0.0f;
    o.mat = -1;
    bool miss = false;
    if (lane < a.n) {
      lane_bwd(s, a, lane, stages + (step % kStages) * kHead * kBlock + threadIdx.x, o);
#pragma unroll
      for (int r = 0; r < 13; ++r) a.cot_in[(size_t)r * a.n + lane] = o.cot_in[r];
      miss = o.g_env[0] != 0.0f || o.g_env[1] != 0.0f || o.g_env[2] != 0.0f;
    }
    // a warp whose g_env are all zero (no live miss) would add zeros to the
    // environment: skipping its sums leaves the row as it was
    if (__any_sync(pt3::kFullMask, miss)) pt3::warp_add_env(o.g_env, ws, a.n_mat);
    pt3::warp_add_mat(o.mat, o.g_mat, ws, a.n_mat);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // the block's row of the partials: its warps' rows in warp order
  for (int c = threadIdx.x; c < n_col; c += blockDim.x) {
    float sum = smem[c];
    for (int w = 1; w < kWarps; ++w) sum = sum + smem[w * n_col + c];
    a.partial[(size_t)blockIdx.x * n_col + c] = sum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: column c is summed by warp c % kWarps, lane l taking the
  // blocks l, l + 32, ... in order, then one butterfly sum
  __threadfence();
  const int wl = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < n_col; c += kWarps) {
    float sum = 0.0f;
#pragma unroll 4
    for (int b = wl; b < (int)gridDim.x; b += 32)
      sum = sum + __ldcg(a.partial + (size_t)b * n_col + c);
    sum = pt3::warp_sum(sum);
    if (wl == 0) a.d_out[c] = sum;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

}  // namespace

// partial: [ceil(n / 256), 9 * n_mat + 3] scratch (the grid never exceeds
// it); ticket: [1], 0 at the first launch (each launch leaves it 0); d_out:
// [9 * n_mat + 3] (materials row-major [n_mat, 9], then the environment).
extern "C" int pt3_bounce_bwd(const float* tri, const float* sph,
                              const float* tri_attr, const float* sph_attr,
                              int n_tri, int n_sph, int t_pad, float env_r,
                              float env_g, float env_b, const int* tri_mat,
                              const int* sph_mat, int n_mat, const float* state,
                              const float* ts, const int* idxs, const float* unif,
                              const float* cot_out, float* cot_in, float* partial,
                              float* d_out, unsigned* ticket, int n, void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  const int n_col = 9 * n_mat + 3;
  const size_t smem = smem_bytes(n_col);
  if (n <= 0 || n_mat <= 0 || ticket == nullptr || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bounce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bounce_bwd_kernel, kBlock, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = min((n + kBlock - 1) / kBlock, max(sms * per_sm, 1));
  BwdArgs a{tri_mat, sph_mat, state, ts, idxs, unif, cot_out, cot_in, partial, d_out,
            ticket, n, n_mat};
  bounce_bwd_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(s, a);
  return (int)cudaGetLastError();
}
