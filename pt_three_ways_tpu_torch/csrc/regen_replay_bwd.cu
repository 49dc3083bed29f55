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
//     s: d_state0[(s * 10 + r) * N + lane] (every other row stays zero).
//
// The TPU kernel walked a tile's iterations in lockstep and needed the
// forward tile to be a multiple of its own (RT % RTB); per-lane counts
// remove that coupling.
//
// Material and environment gradients accumulate over lanes and slots in a
// fixed order (grad_reduce.cuh): a warp loops to its largest count, since
// the shuffles need all 32 lanes, and a lane past its own count adds zero;
// lane 0 adds each iteration's warp sums into the warp's shared-memory row,
// and the rows then go through K8's block partials and column reduce. No
// float atomics: bit-identical gradients on every run.
//
// Bound: bytes. Each realized slot is read once (52 B), plus each lane's
// count, id and acc_bar; d_state0 (S * 40 B per lane) is written. The
// adjoint is ~500 FP32 operations per hit slot, which stays below the bytes.
#include "grad_reduce.cuh"
#include "kernel_rng.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

struct WalkArgs {
  uint32_t seed[3];
  int sample0;
  const int* __restrict__ lane_ids;   // [N]
  const float* __restrict__ resid;    // [S*nb, 13, N]
  const int* __restrict__ cnt;        // [N]
  const float* __restrict__ acc_bar;  // [3, N]
  float* __restrict__ d_state0;       // [S*10, N], zero on entry
  float* __restrict__ partial;        // [9 * n_mat + 3, blocks]
  int n, n_mat;
};

__global__ void __launch_bounds__(kBlock)
regen_replay_bwd_kernel(pt3::SceneView s, const int* __restrict__ tri_mat,
                        const int* __restrict__ sph_mat, WalkArgs a) {
  extern __shared__ float smem[];  // [kWarps, n_col]
  const int n_col = 9 * a.n_mat + 3;
  for (int i = threadIdx.x; i < kWarps * n_col; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < a.n;
  const int count = valid ? a.cnt[lane] : 0;
  const int most = __reduce_max_sync(pt3::kFullMask, count);
  float* ws = smem + (threadIdx.x >> 5) * n_col;
  float C[13];  // the running cotangent of the walked bounce's output state
#pragma unroll
  for (int r = 0; r < 10; ++r) C[r] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) C[10 + c] = valid ? a.acc_bar[(size_t)c * a.n + lane] : 0.0f;
  const uint32_t hlane = valid ? (uint32_t)a.lane_ids[lane] * pt3::kInP1 : 0u;
  int prev = -1;
  for (int jj = 0; jj < most; ++jj) {
    pt3::BwdOut o{};
    o.mat = -1;
    const int j = count - 1 - jj;
    if (j >= 0) {
      const float* slot = a.resid + (size_t)j * 13 * a.n + lane;
      float st[13];
#pragma unroll
      for (int r = 0; r < 9; ++r) st[r] = slot[(size_t)r * a.n];
      st[9] = 1.0f;
      st[10] = st[11] = st[12] = 0.0f;
      const float t = slot[(size_t)9 * a.n];
      const int idx = (int)slot[(size_t)10 * a.n];
      const int smp = (int)slot[(size_t)11 * a.n];
      const int d = (int)slot[(size_t)12 * a.n];
      if (smp != prev) {
#pragma unroll
        for (int r = 0; r < 10; ++r) C[r] = 0.0f;
      }
      const uint32_t base = hlane + pt3::sd_term(a.sample0, smp, d);
      const float u = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[0]));
      const float v = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[1]));
      const float p = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[2]));
      pt3::bounce_bwd_lane(s, tri_mat, sph_mat, st, t, idx, u, pt3::acos01(u), v, p, C, o);
      if (d == 1) {
#pragma unroll
        for (int r = 0; r < 9; ++r)
          a.d_state0[(size_t)(smp * 10 + r) * a.n + lane] = o.cot_in[r];
      }
#pragma unroll
      for (int r = 0; r < 13; ++r) C[r] = o.cot_in[r];
      prev = smp;
    }
    pt3::warp_add_grads(o, ws, a.n_mat);
  }
  __syncthreads();
  pt3::block_partials(smem, kWarps, n_col, a.partial);
}

}  // namespace

// d_state0: [S*10, N], zeroed by the caller; partial: [9 * n_mat + 3,
// ceil(n / 128)] scratch; d_out: [9 * n_mat + 3] (materials row-major
// [n_mat, 9], then the environment).
extern "C" int pt3_regen_replay_bwd(const float* tri, const float* sph,
                                    const float* tri_attr, const float* sph_attr,
                                    int n_tri, int n_sph, int t_pad, float env_r,
                                    float env_g, float env_b, const int* tri_mat,
                                    const int* sph_mat, int n_mat, unsigned seed0,
                                    unsigned seed1, unsigned seed2, int sample0,
                                    const int* lane_ids, const float* resid,
                                    const int* cnt, const float* acc_bar,
                                    float* d_state0, float* partial, float* d_out,
                                    int n, void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  const int n_col = 9 * n_mat + 3;
  const size_t smem = sizeof(float) * kWarps * n_col;
  if (n <= 0 || n_mat <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  WalkArgs a{{seed0, seed1, seed2}, sample0, lane_ids, resid, cnt, acc_bar,
             d_state0, partial, n, n_mat};
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = (n + kBlock - 1) / kBlock;
  regen_replay_bwd_kernel<<<grid, kBlock, smem, st>>>(s, tri_mat, sph_mat, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_columns_kernel<<<n_col, pt3::kReduceBlock, 0, st>>>(partial, grid, d_out);
  return (int)cudaGetLastError();
}
