// Kernel K9: the reverse walk of the regenerating training path, the
// backward of K4's replay mode (megakernel.cu, REPLAY).
//
// Replaces the JAX package's ops/pallas_megakernel.py
// _regen_replay_bwd_kernel / _run_regen_replay_bwd / regen_replay_bwd. One
// thread per lane walks its residual slots j = cnt - 1 ... 0 ([S*nb, 13, N]:
// input org3 dir3 beta3, winner t and packed index, sample s, depth d):
//
//   * a slot whose sample differs from the one walked just before it (a
//     sample boundary, seen in reverse) zeroes the running state cotangent
//     rows 0..9; the acc rows stay acc_bar, the same for every sample of a
//     lane (the chain's radiance is the sum over its samples);
//   * the bounce uniforms (u, acos u, v, p) are recomputed from (lane id,
//     sample0 + s, d) with K1 (kernel_rng.cuh), the draws K4 made; acos01
//     even where K4 ran NO_GLOSSY, where the cone branch that reads it is
//     never taken;
//   * the bounce's adjoint is K8's (replay.cuh: bounce_bwd_lane) at the
//     saved input state and winner;
//   * at d == 1 the input-state cotangent rows 0..8 are d(state0) of sample
//     s: d_state0[(s * 10 + r) * N + lane]; the kernel writes every other
//     row of d_state0 as zero itself (no memset before it).
//
// Design on the H100 (bound: bytes, each realized slot read once):
//
//   * the walk is aligned on the warp's longest lane: in iteration k every
//     lane of the warp whose walk has begun is at slot most - 1 - k (a lane
//     walks its own slots in the same order; it starts later instead of
//     stopping sooner), so a row of a slot is one coalesced 128-B read for
//     the warp. Lane L at slot cnt_L - 1 - k, each lane from its own last
//     slot, reads 8.09 sectors of 32 B a request on suzanne's regen step,
//     the aligned walk 3.04;
//   * each lane copies its next slot into shared memory with cp.async while
//     it computes the current one (two 13-row stages a thread);
//   * thread t walks lane t: schedules that sort the lanes by count even
//     out a warp's walks but scatter its reads, and lost on the H100;
//   * the material and environment gradients accumulate per thread over its
//     walk: the environment in registers, the materials in kAccSlots
//     accumulators of 9 floats in shared memory, one column a thread, taken
//     by the first materials the thread hits. A material that finds no free
//     accumulator is summed over the warp at once (grad_reduce.cuh). After
//     the walk, one warp sum per accumulator and material, and per
//     environment channel, goes into the warp's row; the rows go through
//     K8's block partials and column reduce. Every order is fixed by the
//     data and no float atomic is used: bit-identical gradients on every
//     run.
//
// The TPU kernel walked a tile's iterations in lockstep and needed the
// forward tile to be a multiple of its own (RT % RTB); per-lane counts
// remove that coupling.
#include "grad_reduce.cuh"
#include "kernel_rng.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kRows = 13;      // rows of a residual slot
constexpr int kAccSlots = 6;   // material accumulators a thread keeps

struct WalkArgs {
  uint32_t seed[3];
  int sample0;
  const int* __restrict__ lane_ids;   // [N]
  const float* __restrict__ resid;    // [S*nb, 13, N]
  const int* __restrict__ cnt;        // [N]
  const float* __restrict__ acc_bar;  // [3, N]
  float* __restrict__ d_state0;       // [S*10, N], written whole
  float* __restrict__ partial;        // [9 * n_mat + 3, blocks]
  int n, n_mat, s_count;
};

// Shared memory, in floats: the two slot stages [2][13][kBlock], the
// threads' material accumulators [kAccSlots * 9][kBlock], the warps' rows
// [kWarps][9 * n_mat + 3].
struct WalkLayout {
  int stage, acc, ws, total;
};

__host__ __device__ inline WalkLayout walk_layout(int n_col) {
  WalkLayout L;
  L.stage = 0;
  L.acc = L.stage + 2 * kRows * kBlock;
  L.ws = L.acc + kAccSlots * 9 * kBlock;
  L.total = L.ws + kWarps * n_col;
  return L;
}

// Start copying slot j of this thread's lane into its column of a stage.
__device__ __forceinline__ void stage_slot(float* stage, const float* resid, int j, int n,
                                           int lane) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(stage + threadIdx.x));
  const float* src = resid + (size_t)j * kRows * n + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst + 4u * r * kBlock),
                 "l"(src + (size_t)r * n)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kBlock)
regen_replay_bwd_kernel(pt3::SceneView s, const int* __restrict__ tri_mat,
                        const int* __restrict__ sph_mat, WalkArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n_col = 9 * a.n_mat + 3;
  const WalkLayout L = walk_layout(n_col);
  float* stage = smem + L.stage;
  float* macc = smem + L.acc + threadIdx.x;  // this thread's column
  for (int i = threadIdx.x; i < kWarps * n_col; i += blockDim.x) smem[L.ws + i] = 0.0f;
#pragma unroll
  for (int q = 0; q < kAccSlots * 9; ++q) macc[q * kBlock] = 0.0f;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < a.n;
  const int count = valid ? a.cnt[lane] : 0;
  const int most = __reduce_max_sync(pt3::kFullMask, count);
  float* ws = smem + L.ws + (threadIdx.x >> 5) * n_col;
  float C[13];  // the running cotangent of the walked bounce's output state
#pragma unroll
  for (int r = 0; r < 10; ++r) C[r] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) C[10 + c] = valid ? a.acc_bar[(size_t)c * a.n + lane] : 0.0f;
  const uint32_t hlane = valid ? (uint32_t)a.lane_ids[lane] * pt3::kInP1 : 0u;
  int acc_mat[kAccSlots];
#pragma unroll
  for (int q = 0; q < kAccSlots; ++q) acc_mat[q] = -1;
  float env[3] = {0.0f, 0.0f, 0.0f};
  uint64_t written = 0;  // samples whose d_state0 rows the walk wrote
  int prev = -1;
  if (count > 0) stage_slot(stage, a.resid, count - 1, a.n, lane);
  for (int k = 0; k < most; ++k) {
    const int j = most - 1 - k;
    int over_mat = -1;  // a material without an accumulator: summed now
    float over_g[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) over_g[q] = 0.0f;
    if (j < count) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      const float* cur = stage + ((count - 1 - j) & 1) * kRows * kBlock + threadIdx.x;
      if (j > 0)
        stage_slot(stage + ((count - j) & 1) * kRows * kBlock, a.resid, j - 1, a.n, lane);
      float st[13];
#pragma unroll
      for (int r = 0; r < 9; ++r) st[r] = cur[r * kBlock];
      st[9] = 1.0f;
      st[10] = st[11] = st[12] = 0.0f;
      const float t = cur[9 * kBlock];
      const int idx = (int)cur[10 * kBlock];
      const int smp = (int)cur[11 * kBlock];
      const int d = (int)cur[12 * kBlock];
      if (smp != prev) {
#pragma unroll
        for (int r = 0; r < 10; ++r) C[r] = 0.0f;
      }
      const uint32_t base = hlane + pt3::sd_term(a.sample0, smp, d);
      const float u = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[0]));
      const float v = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[1]));
      const float p = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[2]));
      pt3::BwdOut o;
      pt3::bounce_bwd_lane(s, tri_mat, sph_mat, st, t, idx, u, pt3::acos01(u), v, p, C, o);
      if (d == 1) {
#pragma unroll
        for (int r = 0; r < 9; ++r)
          a.d_state0[(size_t)(smp * 10 + r) * a.n + lane] = o.cot_in[r];
        written |= 1ull << smp;
      }
#pragma unroll
      for (int r = 0; r < 13; ++r) C[r] = o.cot_in[r];
      prev = smp;
#pragma unroll
      for (int c = 0; c < 3; ++c) env[c] = env[c] + o.g_env[c];
      if (o.mat >= 0) {
        int q_at = -1;
#pragma unroll
        for (int q = 0; q < kAccSlots; ++q)
          if (acc_mat[q] == o.mat) q_at = q;
#pragma unroll
        for (int q = 0; q < kAccSlots; ++q)
          if (q_at < 0 && acc_mat[q] < 0) {
            q_at = q;
            acc_mat[q] = o.mat;
          }
        if (q_at >= 0) {
#pragma unroll
          for (int q = 0; q < 9; ++q)
            macc[(q_at * 9 + q) * kBlock] = macc[(q_at * 9 + q) * kBlock] + o.g_mat[q];
        } else {
          over_mat = o.mat;
#pragma unroll
          for (int q = 0; q < 9; ++q) over_g[q] = o.g_mat[q];
        }
      }
    }
    if (__any_sync(pt3::kFullMask, over_mat >= 0))
      pt3::warp_add_mat(over_mat, over_g, ws, a.n_mat);
  }
  // the rows of d_state0 the walk did not write: the alive row, and whole
  // samples the lane had no slot of (dead at the sample's start)
  if (valid) {
    for (int smp = 0; smp < a.s_count; ++smp) {
      float* row = a.d_state0 + (size_t)smp * 10 * a.n + lane;
      if (!((written >> smp) & 1ull)) {
#pragma unroll
        for (int r = 0; r < 9; ++r) row[(size_t)r * a.n] = 0.0f;
      }
      row[(size_t)9 * a.n] = 0.0f;
    }
  }
  // the thread's sums into the warp's row, accumulator by accumulator
#pragma unroll
  for (int q = 0; q < kAccSlots; ++q) {
    float g[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = macc[(q * 9 + k) * kBlock];
    pt3::warp_add_mat(acc_mat[q], g, ws, a.n_mat);
  }
  pt3::warp_add_env(env, ws, a.n_mat);
  __syncthreads();
  pt3::block_partials(smem + L.ws, kWarps, n_col, a.partial);
}

}  // namespace

// d_state0: [S*10, N], written whole (S = s_count <= 64); partial:
// [9 * n_mat + 3, ceil(n / 128)] scratch; d_out: [9 * n_mat + 3]
// (materials row-major [n_mat, 9], then the environment).
extern "C" int pt3_regen_replay_bwd(const float* tri, const float* sph,
                                    const float* tri_attr, const float* sph_attr,
                                    int n_tri, int n_sph, int t_pad, float env_r,
                                    float env_g, float env_b, const int* tri_mat,
                                    const int* sph_mat, int n_mat, unsigned seed0,
                                    unsigned seed1, unsigned seed2, int sample0,
                                    const int* lane_ids, const float* resid,
                                    const int* cnt, const float* acc_bar,
                                    float* d_state0, float* partial, float* d_out,
                                    int n, int s_count, void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  const int n_col = 9 * n_mat + 3;
  const size_t smem = sizeof(float) * walk_layout(n_col).total;
  if (n <= 0 || n_mat <= 0 || s_count <= 0 || s_count > 64 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        regen_replay_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  WalkArgs a{{seed0, seed1, seed2}, sample0, lane_ids, resid, cnt, acc_bar,
             d_state0, partial, n, n_mat, s_count};
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = (n + kBlock - 1) / kBlock;
  regen_replay_bwd_kernel<<<grid, kBlock, smem, st>>>(s, tri_mat, sph_mat, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_columns_kernel<<<n_col, pt3::kReduceBlock, 0, st>>>(partial, grid, d_out);
  return (int)cudaGetLastError();
}
