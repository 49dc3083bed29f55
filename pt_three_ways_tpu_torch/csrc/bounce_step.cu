// Kernel K10: one bounce of the compacting wavefront.
//
// Replaces the JAX package's ops/pallas_megakernel.py _bounce_kernel /
// _run_bounce / bounce_step. The path state is [13, N] (org3 dir3 beta3
// alive1 acc3): the radiance accumulator rides in the state, so the
// compaction between bounces (models/integrator.trace_passes_compact, a
// stable partition of the lanes by alive) permutes it with the rest. One
// thread per lane: a live lane finds the unpacked winner, adds the
// environment on a miss and runs pt3_device.cuh's shading with this
// bounce's uniforms (u, acos u, v, p) [4, N]; a dead lane copies its column
// through. cnt [N] is 1 where the lane was alive on entry; with the winner
// record, t [N] (+inf on a miss or a dead lane) and idx [N] (0 there).
//
// The search is K2's (intersect.cu), chosen by the launch as K2 chooses it
// (flat_scene.cuh: flat_fits): a scene of at most one 64-row chunk
// (cornell) is staged in shared memory once per block, its attribute rows
// too, and every live thread scans it (winner_search<false, true>); any
// other scene takes the culled warp search over the pack's window boxes
// (stream_tri.cuh: culled_search_warp_near). Both give winner_search<false>'s
// winner bit for bit (the lowest index at the least t), so the state, cnt
// and the record equal the unculled scan's. A thread past n stays in its
// warp as an inactive lane (the search's shuffles and ballots take the full
// warp).
//
// Compaction packs the live lanes first, so past the live prefix every warp
// is wholly dead. Such a warp ballots alive, skips the search and the
// shading, and copies its 32 columns, one float a thread and row. On the
// one-chunk route a block with no live lane also skips the staging. Built
// with -DPT3_K4_ONE_CHUNK_CULLED (flat_scene.cuh), a one-chunk scene takes
// the culled warp search instead (chip_smoke.py times both on cornell).
//
// Bound: FP32 operations of the live lanes' searches (the windows each ray
// enters before its winner; every primitive on one-chunk scenes) and their
// shading, or the bytes: a live lane reads 17 floats (state, uniforms) and
// a dead one 13, and each writes 14 (16 with the record). After the first
// bounce the dead tail's bytes set it.
#include "flat_scene.cuh"
#include "stream_tri.cuh"

namespace {

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the culled instance's registers are capped so that 8 blocks fit an SM,
// as K2's (intersect.cu)
constexpr int kCulledMinBlocks = 8;

struct BounceArgs {
  const float* __restrict__ state_in;  // [13, n]
  const float* __restrict__ unif;      // [4, n]
  float* __restrict__ state_out;       // [13, n]
  int* __restrict__ cnt;               // [n]
  float* __restrict__ t_out;           // [n] (WITH_HIT)
  int* __restrict__ i_out;             // [n] (WITH_HIT)
  int n;
  float eps;
};

// A thread of a wholly dead warp copies its lane's column through.
template <bool WITH_HIT>
__device__ __forceinline__ void dead_warp_copy(const BounceArgs& a, int lane, bool valid) {
  if (!valid) return;
  float v[13];
#pragma unroll
  for (int r = 0; r < 13; ++r) v[r] = a.state_in[(size_t)r * a.n + lane];
#pragma unroll
  for (int r = 0; r < 13; ++r) a.state_out[(size_t)r * a.n + lane] = v[r];
  a.cnt[lane] = 0;
  if (WITH_HIT) {
    a.t_out[lane] = pt3::kInf;
    a.i_out[lane] = 0;
  }
}

template <bool NO_GLOSSY, bool WITH_HIT, bool FLAT>
__global__ void __launch_bounds__(kBlock, FLAT ? 1 : kCulledMinBlocks)
bounce_step_kernel(pt3::SceneView s, pt3::StreamView w, BounceArgs a) {
  extern __shared__ __align__(16) float smem[];  // FLAT: flat_layout's tables
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = lane < a.n;
  const int li = valid ? lane : 0;
  const bool alive = valid && a.state_in[(size_t)9 * a.n + li] != 0.0f;
  pt3::SceneView v = s;
  if constexpr (FLAT) {
    // block-uniform: a block with no live lane stages nothing
    if (!__syncthreads_or(alive)) {
      dead_warp_copy<WITH_HIT>(a, lane, valid);
      return;
    }
    v = pt3::flat_stage<true>(s, smem);
  }
  if (!__any_sync(kFull, alive)) {
    dead_warp_copy<WITH_HIT>(a, lane, valid);
    return;
  }
  float st[10];
  float acc[3];
#pragma unroll
  for (int r = 0; r < 10; ++r) st[r] = a.state_in[(size_t)r * a.n + li];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = a.state_in[(size_t)(10 + c) * a.n + li];
  const pt3::Ray r{st[0], st[1], st[2], st[3], st[4], st[5]};
  float t = pt3::kInf;
  int idx = 0;
  if constexpr (FLAT) {
    if (alive) pt3::winner_search<false, true>(v, r, a.eps, t, idx);
  } else {
    pt3::culled_search_warp_near(v, w, r, alive, a.eps, t, idx);
  }
  if (!valid) return;
  float t_rec = pt3::kInf;
  int i_rec = 0;
  if (alive) {
    const bool hit = isfinite(t) && t > 0.0f;
    if (!hit) {
      acc[0] = acc[0] + st[6] * v.env[0];
      acc[1] = acc[1] + st[7] * v.env[1];
      acc[2] = acc[2] + st[8] * v.env[2];
    }
    st[9] = 0.0f;
    if (hit) {
      pt3::shade<NO_GLOSSY, FLAT>(v, st, acc, t, idx, a.unif[lane],
                                  a.unif[(size_t)a.n + lane],
                                  a.unif[(size_t)2 * a.n + lane],
                                  a.unif[(size_t)3 * a.n + lane]);
      t_rec = t;
      i_rec = idx;
    }
  }
#pragma unroll
  for (int q = 0; q < 10; ++q) a.state_out[(size_t)q * a.n + lane] = st[q];
#pragma unroll
  for (int c = 0; c < 3; ++c) a.state_out[(size_t)(10 + c) * a.n + lane] = acc[c];
  a.cnt[lane] = alive ? 1 : 0;
  if (WITH_HIT) {
    a.t_out[lane] = t_rec;
    a.i_out[lane] = i_rec;
  }
}

template <bool NO_GLOSSY, bool WITH_HIT>
void launch(const pt3::SceneView& s, const pt3::StreamView& w, const BounceArgs& a, bool flat,
            cudaStream_t st) {
  const int grid = (a.n + kBlock - 1) / kBlock;
  if (flat)
    bounce_step_kernel<NO_GLOSSY, WITH_HIT, true>
        <<<grid, kBlock, pt3::flat_layout(s.n_tri, s.n_sph).total * sizeof(float), st>>>(
            s, w, a);
  else
    bounce_step_kernel<NO_GLOSSY, WITH_HIT, false><<<grid, kBlock, 0, st>>>(s, w, a);
}

}  // namespace

// The window tables are needed unless the scene fits flat_fits.
extern "C" int pt3_bounce_step(const float* tri, const float* sph, const float* tri_attr,
                               const float* sph_attr, int n_tri, int n_sph, int t_pad,
                               float env_r, float env_g, float env_b, const float* wbox,
                               const float* wbox1, int n_windows, int n_groups, int window,
                               int fan, const float* state_in, const float* unif,
                               float* state_out, int* cnt, float* t_out, int* i_out, int n,
                               float eps, int no_glossy, void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  if (n <= 0) return (int)cudaGetLastError();
  const bool flat = pt3::flat_fits(n_tri, n_sph);
  if ((t_out == nullptr) != (i_out == nullptr) || state_in == state_out ||
      (!flat && (wbox == nullptr || wbox1 == nullptr || n_windows <= 0 || window <= 0 ||
                 window % pt3::kTc != 0 || fan < 1 || fan > 32 ||
                 n_groups != (n_windows + fan - 1) / fan ||
                 (size_t)n_windows * window < (size_t)n_tri)))
    return (int)cudaErrorInvalidValue;
  const pt3::StreamView w{nullptr, wbox, wbox1, n_windows, n_groups, window, fan};
  const BounceArgs a{state_in, unif, state_out, cnt, t_out, i_out, n, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (no_glossy) {
    if (t_out != nullptr) launch<true, true>(s, w, a, flat, st);
    else launch<true, false>(s, w, a, flat, st);
  } else {
    if (t_out != nullptr) launch<false, true>(s, w, a, flat, st);
    else launch<false, false>(s, w, a, flat, st);
  }
  return (int)cudaGetLastError();
}
