// Kernels K4 (in-kernel RNG) and K5 (table uniforms): the regenerating
// path-tracing megakernels.
//
// K4 replaces the JAX package's ops/pallas_megakernel.py
// _megakernel_regen_krng / _run_regen_krng (plain, thresh, resume and replay
// modes; replay, as there, runs neither with tail compaction nor streamed);
// K5 replaces _megakernel_regen / _run_regen. One thread per lane:
// the path state lives in registers, a dead lane reloads the next alive
// sample's first-bounce state from state0 [(s * 10 + r) * N + lane] and keeps
// tracing until its samples are exhausted. The shading is pt3_device.cuh's.
//
// K5 is a case of K4's loop (template TABLE): a bounce's (u, acos u, v, p)
// come from the threefry table, lane-major ([S*nb, N] float4, built so by
// the camera stage), instead of K1's hash; the refill from the next-alive
// table nexta [S+1, N] instead of the alive-mask words (so S is not capped
// at 64); and the winner is the unpacked one (the exact minimum t, the
// lowest index on ties), not K4's packed minimum. A bounce's
// draws are one 16-byte load, issued before its winner search, whose
// ~2,000 operations hide its latency. Its searches are K2's: a one-chunk
// scene staged in shared memory and scanned per thread
// (winner_search<false, true>), any other the culled warp search with the
// unpacked winner over a PackedSceneStream's window boxes
// (stream_tri.cuh culled_search_warp_near). It takes the lane queue
// (below), and equals its plain version (every primitive scanned, one lane
// a thread) bit for bit.
//
// K4's resident mode has one design per kind of scene, chosen by the
// launch from the scene (flat_scene.cuh: flat_fits): FLAT, for a scene of at most one 64-row
// chunk (cornell: 38 triangles and a sphere), stages the Woop, sphere and
// attribute rows in shared memory once per block and scans them per thread
// as warp-uniform broadcasts (three float4 a Woop row): every ray tests every
// primitive and nothing is culled. CULLED, for every other scene, is
// REPLAY's search without the slots (below): the window boxes of a
// PackedSceneStream cull it and the warp spreads each entered (ray, window)
// pair's tests over its lanes. Both find the unculled
// scan's packed winners bit for bit, so acc and cnt equal it. Without tail
// compaction FLAT, CULLED and REPLAY take their lanes from a queue
// (krng_lane_queue): persistent blocks, and a thread whose lane is exhausted
// takes the next one, so a warp does not wait for its longest lane with its
// other threads idle.
//
// Bound: FP32 operations of the per-bounce winner search (FLAT: every
// primitive for every live lane; CULLED: the triangles of the windows each
// ray enters before its winner). The bytes (state tables in, radiance and
// counts out) are small next to it. With -fmad=false every product and sum
// is its own instruction and the reciprocal is the IEEE sequence, so the
// card's FP32 issue rate, not its 67 TFLOP/s of fused multiply-adds, bounds
// FLAT. With tail compaction (THRESH) the loop is block-synchronous: it
// stops once fewer than `thresh` lanes of the block are alive and writes
// the in-flight state [12, N] (state rows 0..9, sample, depth) for a
// compacted continuation launch (RESUME).
//
// REPLAY (the regenerating training path's forward) also writes one
// residual slot per live iteration of a lane, [S*nb, 13, rres_n]: slot j of
// a lane holds the input org3 dir3 beta3 of its j-th bounce, the winner t
// (+inf on a miss), the winner's packed index (0 on a miss), the sample and
// the depth (exact small integers in float32). A lane is live from
// iteration 0 until its samples are exhausted (the refill runs in the same
// iteration), so its slots are exactly j < cnt and its count is the slot
// index; a sample takes at most nb iterations, so S*nb slots suffice. The
// TPU kernel's 16-row padding and per-tile iteration count are not needed:
// cnt says which slots are real. Residual bytes: 52 per live bounce.
// REPLAY's search (CULLED's, one bounce function with a SLOTS flag) is
// culled by the launch's window boxes
// (stream_tri.cuh culled_search_warp: level-1 boxes then 64-row window
// boxes with K6's exact test, per lane, no block barrier), and each entered
// (ray, window) pair is tested by the whole warp. The winners are the
// resident scan's bit for bit.
// Bound: the triangle tests of the windows each ray enters, charged per
// lane; the residual writes are small next to them. It runs without tail
// compaction (the lane queue, below, keeps a warp from idling behind its
// longest lane), so slot j of lane i is row (j * 13 + r) * rres_n + i.
//
// STREAM (scenes above the resident mode's measured range,
// ops/megakernel.RESIDENT_MAX_TRIANGLES): the triangle search is K6
// (stream_tri.cuh), which stages windows of the table in shared memory
// block by block. Its votes and loads need every
// thread of the block, so the loop is block-synchronous
// (__syncthreads_or / __syncthreads_count over the live lanes): a dead,
// exhausted or out-of-range thread stays in the loop, takes part in the
// barriers and does no math. A lane's sequence of bounces is unchanged, so
// acc and cnt equal the resident launch bit for bit. STREAM composes with
// THRESH and RESUME (tail compaction), not with REPLAY. Its dynamic shared
// memory (stream_layout: two windows, the rays, slots and lists; 120 KB at
// 1024-row windows, fan 16) is opted into above 48 KB. Its registers, and
// CULLED's and REPLAY's, are capped so that 8 blocks of 128 fit an SM (64
// registers: occupancy, not arithmetic, set K6's time on the H100).
#include "kernel_rng.cuh"
#include "flat_scene.cuh"
#include "stream_tri.cuh"

namespace {

struct Lane {
  float st[10];
  float acc[3];
  int cnt;
  int s_cur;
  int d_cur;
};

__device__ __forceinline__ void load_state(float* st, const float* __restrict__ state0,
                                           int s, int lane, int n) {
#pragma unroll
  for (int r = 0; r < 10; ++r) st[r] = state0[(size_t)(s * 10 + r) * n + lane];
}

// Environment on miss after the winner search; returns hit (t, idx valid).
// The lane dies unless the shading that follows revives it.
__device__ __forceinline__ bool finish_search(const pt3::SceneView& s, Lane& L, float t) {
  const bool hit = isfinite(t) && t > 0.0f;
  if (!hit) {
    L.acc[0] = L.acc[0] + L.st[6] * s.env[0];
    L.acc[1] = L.acc[1] + L.st[7] * s.env[1];
    L.acc[2] = L.acc[2] + L.st[8] * s.env[2];
  }
  L.st[9] = 0.0f;
  return hit;
}

// ---------------------------------------------------------------- K4 ----

struct KrngArgs {
  uint32_t seed[3];
  int sample0;
  const int* __restrict__ lane_ids;  // [N]
  const int* __restrict__ amask;     // [2, N] uint32 words
  const float* __restrict__ state0;  // [S*10, N]
  const float* __restrict__ resid_in;  // [12, N] (RESUME)
  float* __restrict__ acc_out;       // [3, N]
  int* __restrict__ cnt_out;         // [N]
  float* __restrict__ resid_out;     // [12, N] (THRESH)
  float* __restrict__ rresid;        // [S*nb, 13, rres_n] (REPLAY)
  int* next_lane;                    // [1] the lane queue's head, 0 at launch (LANE_QUEUE)
  int rres_n;
  int n, S, nb, thresh;
  float eps;
  pt3::StreamView w;  // window tables (STREAM), or the boxes of the culled searches
  const int* __restrict__ nexta;     // [S+1, N] next alive sample (TABLE)
  const float4* __restrict__ unif;   // [S*nb, N] (u, acos u, v, p) (TABLE)
};

// First alive sample strictly after s_cur (>= 0 when first) over the two
// mask words; S when none.
__device__ __forceinline__ int next_alive(uint32_t lo, uint32_t hi, int s_cur,
                                          int S, bool first) {
  uint32_t rem_lo, rem_hi;
  int base_lo, base_hi;
  if (first) {
    rem_lo = lo;
    rem_hi = hi;
    base_lo = 0;
    base_hi = 32;
  } else {
    const bool in_lo = s_cur < 32;
    const uint32_t sh_lo = (uint32_t)min(s_cur, 31);
    rem_lo = in_lo ? ((lo >> sh_lo) >> 1) : 0u;
    const uint32_t sh_hi = (uint32_t)max(0, min(s_cur - 32, 31));
    rem_hi = in_lo ? hi : ((hi >> sh_hi) >> 1);
    base_lo = s_cur + 1;
    base_hi = in_lo ? 32 : s_cur + 1;
  }
  if (rem_lo != 0u) return base_lo + __ffs(rem_lo) - 1;
  if (rem_hi != 0u) return base_hi + __ffs(rem_hi) - 1;
  return S;
}

struct KrngLane {
  Lane L;
  uint32_t hlane, am_lo, am_hi, sdt;
};

// The lane's next alive sample (its first when `first`), from the mask
// words or (TABLE) the next-alive table, and its first-bounce state.
template <bool TABLE>
__device__ __forceinline__ void krng_refill(KrngLane& K, const KrngArgs& a,
                                            int lane, bool first) {
  const int s_next =
      TABLE ? a.nexta[(size_t)(first ? 0 : K.L.s_cur + 1) * a.n + lane]
            : next_alive(K.am_lo, K.am_hi, K.L.s_cur, a.S, first);
  K.L.s_cur = s_next;
  if (s_next < a.S) {
    load_state(K.L.st, a.state0, s_next, lane, a.n);
    K.L.d_cur = 1;
    if (!TABLE) K.sdt = pt3::sd_term(a.sample0, s_next, 1);
  }
}

// TABLE: the (u, acos u, v, p) of the lane's current sample and depth, one
// 16-byte load from the lane-major table ((s * nb + d - 1) * N + lane),
// issued before the winner search so that it hides its latency. The
// threads of a warp hold lanes scattered over the launch (the lane queue),
// so each touches its own sector: one load a bounce, not four.
__device__ __forceinline__ float4 table_draws(const KrngLane& K, const KrngArgs& a, int lane) {
  return __ldg(a.unif + (size_t)(K.L.s_cur * a.nb + K.L.d_cur - 1) * a.n + lane);
}

// Shading on a hit with the lane's draws (K1's hash, or TABLE's `tab`),
// then the refill of a lane whose path ended.
template <bool NO_GLOSSY, bool SMEM, bool TABLE>
__device__ __forceinline__ void krng_shade_refill(const pt3::SceneView& s, KrngLane& K,
                                                  const KrngArgs& a, int lane, bool hit,
                                                  float t, int idx, float4 tab) {
  if (hit) {
    float u, au, v, p;
    if constexpr (TABLE) {
      u = tab.x;
      au = tab.y;
      v = tab.z;
      p = tab.w;
    } else {
      const uint32_t base = K.hlane + K.sdt;
      u = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[0]));
      v = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[1]));
      p = pt3::uniform_from_bits(pt3::fmix32(base + a.seed[2]));
      au = NO_GLOSSY ? u : pt3::acos01(u);
    }
    pt3::shade<NO_GLOSSY, SMEM>(s, K.L.st, K.L.acc, t, idx, u, au, v, p);
    K.L.d_cur += 1;
    if (!TABLE) K.sdt += pt3::kInP2;
    if (K.L.d_cur > a.nb) K.L.st[9] = 0.0f;
  }
  if (K.L.st[9] == 0.0f && K.L.s_cur < a.S) krng_refill<TABLE>(K, a, lane, false);
}

// K4's search modes (template MODE): CULLED, the culled warp search;
// REPLAY, the same with a residual slot per bounce; STREAM, K6; FLAT, a
// scene of at most one 64-row chunk staged in shared memory and scanned per
// thread (every ray tests every primitive: nothing to cull).
constexpr int kCulled = 0;
constexpr int kReplay = 1;
constexpr int kStream = 2;
constexpr int kFlat = 3;

// K4 launches blocks of at most kMaxBlock lanes. The culled and stream
// instances' registers are capped so that 8 blocks fit an SM (64
// registers; __launch_bounds__): measured on the H100, 2-7 % faster than
// uncapped for the culled search, and what set K6's time. The one-chunk scan
// holds 62 registers uncapped, and caps of 2 to 8 blocks moved it < 1 %.
constexpr int kMaxBlock = 128;
constexpr int kCappedMinBlocks = 8;

// REPLAY: the lane's slot for this iteration (slot cnt), rows (j * 13 + r)
// * rres_n + lane; writes the input state rows.
__device__ __forceinline__ float* replay_slot_open(const KrngLane& K, const KrngArgs& a,
                                                   int lane) {
  float* slot = a.rresid + (size_t)K.L.cnt * 13 * a.rres_n + lane;
#pragma unroll
  for (int r = 0; r < 9; ++r) slot[(size_t)r * a.rres_n] = K.L.st[r];
  return slot;
}

__device__ __forceinline__ void replay_slot_close(float* slot, const KrngLane& K,
                                                  const KrngArgs& a, bool hit, float t,
                                                  int idx) {
  slot[(size_t)9 * a.rres_n] = hit ? t : pt3::kInf;
  slot[(size_t)10 * a.rres_n] = hit ? (float)idx : 0.0f;
  slot[(size_t)11 * a.rres_n] = (float)K.L.s_cur;
  slot[(size_t)12 * a.rres_n] = (float)K.L.d_cur;
}

// One bounce of one lane with the per-thread scan of the scene in shared
// memory (FLAT: s reads the staged tables; K4's packed winner, TABLE's
// unpacked one).
template <bool NO_GLOSSY, bool TABLE>
__device__ __forceinline__ void krng_bounce_flat(const pt3::SceneView& s, KrngLane& K,
                                                 const KrngArgs& a, int lane) {
  const float4 tab = TABLE ? table_draws(K, a, lane) : make_float4(0.f, 0.f, 0.f, 0.f);
  float t;
  int idx;
  K.L.cnt += 1;
  const pt3::Ray r{K.L.st[0], K.L.st[1], K.L.st[2], K.L.st[3], K.L.st[4], K.L.st[5]};
  pt3::winner_search<!TABLE, true>(s, r, a.eps, t, idx);
  const bool hit = finish_search(s, K.L, t);
  krng_shade_refill<NO_GLOSSY, true, TABLE>(s, K, a, lane, hit, t, idx, tab);
}

// One bounce with the culled warp search (CULLED: K4's packed winner,
// TABLE's unpacked one, culled_search_warp_near; SLOTS: REPLAY's residual
// slot). Every lane of the warp calls it; only `active` ones write slots,
// shade and refill.
template <bool NO_GLOSSY, bool SLOTS, bool TABLE>
__device__ __forceinline__ void krng_bounce_culled(const pt3::SceneView& s, KrngLane& K,
                                                   const KrngArgs& a, int lane, bool active) {
  float4 tab = make_float4(0.f, 0.f, 0.f, 0.f);
  if (TABLE && active) tab = table_draws(K, a, lane);
  float* slot = (SLOTS && active) ? replay_slot_open(K, a, lane) : nullptr;
  if (active) K.L.cnt += 1;
  const pt3::Ray r{K.L.st[0], K.L.st[1], K.L.st[2], K.L.st[3], K.L.st[4], K.L.st[5]};
  float t;
  int idx;
  if constexpr (TABLE)
    pt3::culled_search_warp_near(s, a.w, r, active, a.eps, t, idx);
  else
    pt3::culled_search_warp(s, a.w, r, active, a.eps, t, idx);
  if (!active) return;
  const bool hit = finish_search(s, K.L, t);
  if (SLOTS) replay_slot_close(slot, K, a, hit, t, idx);
  krng_shade_refill<NO_GLOSSY, false, TABLE>(s, K, a, lane, hit, t, idx, tab);
}

// One bounce with the streamed triangle search (K6). Every thread of the
// block calls it; only `active` ones search, shade and refill.
template <bool NO_GLOSSY>
__device__ __forceinline__ void krng_bounce_stream(const pt3::SceneView& s, KrngLane& K,
                                                   const KrngArgs& a, int lane, bool active,
                                                   unsigned char* smem, uint32_t& phase) {
  const pt3::Ray r{K.L.st[0], K.L.st[1], K.L.st[2], K.L.st[3], K.L.st[4], K.L.st[5]};
  float t = pt3::kInf;
  int idx = 0;
  if (active) {
    K.L.cnt += 1;
    pt3::sphere_search(s, r, a.eps, t, idx);
  }
  pt3::stream_search(s, a.w, smem, phase, r, active, a.eps, t, idx);
  if (!active) return;
  const bool hit = finish_search(s, K.L, t);
  krng_shade_refill<NO_GLOSSY, false, false>(s, K, a, lane, hit, t, idx,
                                             make_float4(0.f, 0.f, 0.f, 0.f));
}

// One bounce of every thread's lane in a loop that every thread of the
// block runs (STREAM, THRESH); `active` lanes trace.
template <bool NO_GLOSSY, int MODE, bool TABLE>
__device__ __forceinline__ void krng_bounce_all(const pt3::SceneView& s, KrngLane& K,
                                                const KrngArgs& a, int lane, bool active,
                                                unsigned char* smem, uint32_t& phase) {
  if constexpr (MODE == kStream)
    krng_bounce_stream<NO_GLOSSY>(s, K, a, lane, active, smem, phase);
  else if constexpr (MODE == kFlat) {
    if (active) krng_bounce_flat<NO_GLOSSY, TABLE>(s, K, a, lane);
  } else
    krng_bounce_culled<NO_GLOSSY, false, TABLE>(s, K, a, lane, active);
}

// A lane's state at the start of the launch: its first alive sample, or
// (RESUME) the in-flight state of a compacted continuation.
template <bool RESUME, bool TABLE>
__device__ __forceinline__ void krng_lane_init(KrngLane& K, const KrngArgs& a, int lane) {
#pragma unroll
  for (int r = 0; r < 10; ++r) K.L.st[r] = 0.0f;
  K.L.acc[0] = K.L.acc[1] = K.L.acc[2] = 0.0f;
  K.L.cnt = 0;
  K.L.s_cur = 0;
  K.L.d_cur = 0;
  K.sdt = 0u;
  K.hlane = TABLE ? 0u : (uint32_t)a.lane_ids[lane] * pt3::kInP1;
  K.am_lo = TABLE ? 0u : (uint32_t)a.amask[lane];
  K.am_hi = TABLE ? 0u : (uint32_t)a.amask[a.n + lane];
  if (RESUME) {
#pragma unroll
    for (int r = 0; r < 10; ++r) K.L.st[r] = a.resid_in[(size_t)r * a.n + lane];
    K.L.s_cur = (int)a.resid_in[(size_t)10 * a.n + lane];
    K.L.d_cur = (int)a.resid_in[(size_t)11 * a.n + lane];
    K.sdt = pt3::sd_term(a.sample0, K.L.s_cur, K.L.d_cur);
  } else {
    krng_refill<TABLE>(K, a, lane, true);
  }
}

__device__ __forceinline__ void krng_lane_store(const KrngLane& K, const KrngArgs& a, int lane) {
  a.acc_out[lane] = K.L.acc[0];
  a.acc_out[a.n + lane] = K.L.acc[1];
  a.acc_out[2 * a.n + lane] = K.L.acc[2];
  a.cnt_out[lane] = K.L.cnt;
}

// FLAT, CULLED and REPLAY without tail compaction: the lane queue. The
// blocks are persistent, and a thread whose lane is exhausted writes it out
// and takes the next lane of the launch from a queue (a.next_lane; one
// atomicAdd for the threads of a warp that need one), so a warp no longer
// idles its finished threads until its longest lane ends. A lane's
// sequence of bounces and its arithmetic are unchanged (its iteration count
// is its own), so acc, cnt and the slots equal the one-lane-a-thread launch
// bit for bit. Every thread of the warp runs the loop (CULLED's search and
// the ballots take the full warp).
template <bool NO_GLOSSY, bool RESUME, int MODE, bool TABLE>
__device__ __forceinline__ void krng_lane_queue(const pt3::SceneView& s, const KrngArgs& a) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int wl = threadIdx.x & 31;
  const int max_iter = MODE == kReplay ? a.S * a.nb : a.S * (a.nb + 1);
  KrngLane K;
  int lane = -1;  // the thread's lane (-1: none)
  int it = 0;     // the lane's iterations
  bool more = true;  // the queue may hold lanes (the same in every thread of the warp)
  while (true) {
    if (lane >= 0 && !(K.L.st[9] != 0.0f && it < max_iter)) {
      krng_lane_store(K, a, lane);
      lane = -1;
    }
    const unsigned need = __ballot_sync(kFull, lane < 0 && more);
    if (need) {
      const int leader = __ffs(need) - 1;
      int base = 0;
      if (wl == leader) base = atomicAdd(a.next_lane, __popc(need));
      base = __shfl_sync(kFull, base, leader);
      const int got = base + __popc(need & ((1u << wl) - 1u));
      if (((need >> wl) & 1u) && got < a.n) {
        lane = got;
        it = 0;
        krng_lane_init<RESUME, TABLE>(K, a, lane);
      }
      more = base + __popc(need) < a.n;
    }
    if (!__any_sync(kFull, lane >= 0)) break;
    const bool active = lane >= 0 && K.L.st[9] != 0.0f && it < max_iter;
    if constexpr (MODE == kFlat) {
      if (active) krng_bounce_flat<NO_GLOSSY, TABLE>(s, K, a, lane);
    } else {
      krng_bounce_culled<NO_GLOSSY, MODE == kReplay, TABLE>(s, K, a, lane, active);
    }
    if (active) ++it;
  }
}

// STREAM, and FLAT and CULLED with tail compaction (THRESH): one lane a
// thread, in a loop that every thread of the block runs (K6's votes and
// loads, and THRESH's live count, take the whole block).
template <bool NO_GLOSSY, bool THRESH, bool RESUME, int MODE, bool TABLE>
__device__ __forceinline__ void krng_lane_block(const pt3::SceneView& s, const KrngArgs& a,
                                                unsigned char* smem) {
  static_assert(MODE != kReplay, "REPLAY takes the lane queue");
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < a.n;
  const int li = valid ? lane : 0;
  uint32_t phase = 0u;  // STREAM: the two window buffers' mbarrier parities
  if constexpr (MODE == kStream) {
    if (threadIdx.x == 0) {
      uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // stream_layout's mbar at 0
      pt3::mbar_init(bar);
      pt3::mbar_init(bar + 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  KrngLane K;
  krng_lane_init<RESUME, TABLE>(K, a, li);
  if (!valid) K.L.st[9] = 0.0f;  // a thread past n stays in the loop, never live
  const int max_iter = a.S * (a.nb + 1);
  if constexpr (!THRESH) {
    // a dead lane stays dead (the refill runs in the bounce that ends a
    // path), so the block runs while any of its lanes is alive
    for (int it = 0; it < max_iter && __syncthreads_or(valid && K.L.st[9] != 0.0f); ++it)
      krng_bounce_all<NO_GLOSSY, MODE, TABLE>(s, K, a, lane, valid && K.L.st[9] != 0.0f, smem,
                                       phase);
  } else {
    const int th = max(a.thresh, 1);
    int live = __syncthreads_count(valid && K.L.st[9] != 0.0f);
    for (int it = 0; live >= th && it < max_iter; ++it) {
      krng_bounce_all<NO_GLOSSY, MODE, TABLE>(s, K, a, lane, valid && K.L.st[9] != 0.0f, smem,
                                       phase);
      live = __syncthreads_count(valid && K.L.st[9] != 0.0f);
    }
    if (valid) {
#pragma unroll
      for (int r = 0; r < 10; ++r) a.resid_out[(size_t)r * a.n + lane] = K.L.st[r];
      a.resid_out[(size_t)10 * a.n + lane] = (float)K.L.s_cur;
      a.resid_out[(size_t)11 * a.n + lane] = (float)K.L.d_cur;
    }
  }
  if (valid) krng_lane_store(K, a, lane);
}

// Does this instance take the lane queue? Without tail compaction and
// outside the stream mode.
template <bool THRESH, int MODE>
__host__ __device__ constexpr bool uses_queue() {
  return !THRESH && MODE != kStream;
}

template <bool NO_GLOSSY, bool THRESH, bool RESUME, int MODE, bool TABLE>
__device__ __forceinline__ void regen_krng_body(const pt3::SceneView& s_in, const KrngArgs& a) {
  // STREAM: stream_layout; FLAT: pt3::flat_layout
  extern __shared__ __align__(16) unsigned char smem[];
  const pt3::SceneView s =
      MODE == kFlat ? pt3::flat_stage<true>(s_in, reinterpret_cast<float*>(smem)) : s_in;
  if constexpr (uses_queue<THRESH, MODE>())
    krng_lane_queue<NO_GLOSSY, RESUME, MODE, TABLE>(s, a);
  else
    krng_lane_block<NO_GLOSSY, THRESH, RESUME, MODE, TABLE>(s, a, smem);
}

template <bool NO_GLOSSY, bool THRESH, bool RESUME, int MODE, bool TABLE>
__global__ void __launch_bounds__(kMaxBlock, MODE == kFlat ? 1 : kCappedMinBlocks)
    regen_krng_kernel(pt3::SceneView s, KrngArgs a) {
  regen_krng_body<NO_GLOSSY, THRESH, RESUME, MODE, TABLE>(s, a);
}

// One launch of a K4 or K5 instance; shared memory above the 48 KB default
// is opted into first.
template <bool NO_GLOSSY, bool THRESH, bool RESUME, int MODE, bool TABLE = false>
cudaError_t launch_one(pt3::SceneView s, const KrngArgs& a, int grid, int block,
                       size_t smem, cudaStream_t st) {
  void (*kern)(pt3::SceneView, KrngArgs) =
      regen_krng_kernel<NO_GLOSSY, THRESH, RESUME, MODE, TABLE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (uses_queue<THRESH, MODE>()) {
    // the lane queue's persistent blocks: as many as fit the card at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, smem);
    if (e != cudaSuccess) return e;
    grid = min(grid, max(sms * per_sm, 1));
  }
  kern<<<grid, block, smem, st>>>(s, a);
  return cudaSuccess;
}

template <bool NO_GLOSSY, int MODE>
cudaError_t launch_krng_mode(pt3::SceneView s, const KrngArgs& a, bool thresh, bool resume,
                             int grid, int block, size_t smem, cudaStream_t st) {
  if (thresh && resume)
    return launch_one<NO_GLOSSY, true, true, MODE>(s, a, grid, block, smem, st);
  if (thresh)
    return launch_one<NO_GLOSSY, true, false, MODE>(s, a, grid, block, smem, st);
  if (resume)
    return launch_one<NO_GLOSSY, false, true, MODE>(s, a, grid, block, smem, st);
  return launch_one<NO_GLOSSY, false, false, MODE>(s, a, grid, block, smem, st);
}

template <bool NO_GLOSSY>
cudaError_t launch_krng(pt3::SceneView s, const KrngArgs& a, int mode, bool thresh,
                        bool resume, int grid, int block, cudaStream_t st) {
  switch (mode) {
    case kReplay:  // neither thresh nor resume (the entry point's check)
      return launch_one<NO_GLOSSY, false, false, kReplay>(s, a, grid, block, 0, st);
    case kStream:
      return launch_krng_mode<NO_GLOSSY, kStream>(
          s, a, thresh, resume, grid, block,
          pt3::stream_layout(a.w.window, a.w.fan, block).total, st);
    case kFlat:
      return launch_krng_mode<NO_GLOSSY, kFlat>(
          s, a, thresh, resume, grid, block,
          pt3::flat_layout(s.n_tri, s.n_sph).total * sizeof(float), st);
    default:
      return launch_krng_mode<NO_GLOSSY, kCulled>(s, a, thresh, resume, grid, block, 0, st);
  }
}

}  // namespace

// K5: the lane queue (next_lane: its head, 0 at launch) with the one-chunk
// scan on a scene that flat_fits, else the culled warp search over the
// window boxes (wbox, wbox1: a PackedSceneStream's); unif: [S*nb, N, 4]
// floats, 16-byte aligned.
extern "C" int pt3_regen_table(const float* tri, const float* sph,
                               const float* tri_attr, const float* sph_attr,
                               int n_tri, int n_sph, int t_pad, float env_r,
                               float env_g, float env_b, const float* state0,
                               const int* nexta, const float* unif, float* acc,
                               int* cnt, int* next_lane, const float* wbox,
                               const float* wbox1, int n_windows, int n_groups, int window,
                               int fan, int n, int S, int nb, float eps, int no_glossy,
                               void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  if (n <= 0) return (int)cudaGetLastError();
  const bool flat = pt3::flat_fits(n_tri, n_sph);
  if (next_lane == nullptr || S <= 0 || nb <= 0 || reinterpret_cast<uintptr_t>(unif) % 16 ||
      (!flat && (wbox == nullptr || wbox1 == nullptr || n_windows <= 0 || window <= 0 ||
                 window % pt3::kTc != 0 || fan < 1 || fan > 32 ||
                 n_groups != (n_windows + fan - 1) / fan ||
                 (size_t)n_windows * window < (size_t)n_tri)))
    return (int)cudaErrorInvalidValue;
  KrngArgs a{{0u, 0u, 0u}, 0, nullptr, nullptr, state0, nullptr, acc, cnt, nullptr, nullptr,
             next_lane, 0, n, S, nb, 0, eps,
             {nullptr, wbox, wbox1, n_windows, n_groups, window, fan}, nexta,
             reinterpret_cast<const float4*>(unif)};
  const int block = kMaxBlock;
  const int grid = (n + block - 1) / block;
  const size_t smem = flat ? pt3::flat_layout(n_tri, n_sph).total * sizeof(float) : 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (flat)
    e = no_glossy ? launch_one<true, false, false, kFlat, true>(s, a, grid, block, smem, st)
                  : launch_one<false, false, false, kFlat, true>(s, a, grid, block, smem, st);
  else
    e = no_glossy ? launch_one<true, false, false, kCulled, true>(s, a, grid, block, smem, st)
                  : launch_one<false, false, false, kCulled, true>(s, a, grid, block, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int pt3_regen_krng(const float* tri, const float* sph,
                              const float* tri_attr, const float* sph_attr,
                              int n_tri, int n_sph, int t_pad, float env_r,
                              float env_g, float env_b, unsigned seed0,
                              unsigned seed1, unsigned seed2, int sample0,
                              const int* lane_ids, const int* amask,
                              const float* state0, const float* resid_in,
                              float* acc, int* cnt, float* resid_out,
                              float* rresid, int* next_lane, int rres_n,
                              const float* tri_win,
                              const float* wbox, const float* wbox1, int n_windows,
                              int n_groups, int window, int fan, int n,
                              int S, int nb, float eps, int thresh, int no_glossy, int block,
                              void* stream) {
  pt3::SceneView s{tri, sph, tri_attr, sph_attr, n_tri, n_sph, t_pad,
                   {env_r, env_g, env_b}};
  if (n <= 0) return (int)cudaGetLastError();
  const bool th = thresh > 0;
  const bool resume = resid_in != nullptr;
  const bool replay = rresid != nullptr;
  const bool stream_mode = tri_win != nullptr;
  const bool boxed = wbox != nullptr;  // STREAM, or the culled search's boxes
  const int mode = replay ? kReplay
                   : stream_mode ? kStream
                   : pt3::flat_fits(n_tri, n_sph) ? kFlat
                   : kCulled;
  // a window and its second buffer live in dynamic shared memory (opted in
  // above 48 KB; 1024 rows double-buffered take 96 KB)
  if (block <= 0 || block > kMaxBlock || block % 32 != 0 || (th && resid_out == nullptr) ||
      next_lane == nullptr ||
      (mode != kFlat && !boxed) ||
      (replay && (stream_mode || th || resume || rres_n <= 0)) ||
      (boxed && (wbox1 == nullptr || n_windows <= 0 || window <= 0 ||
                 window % pt3::kTc != 0 || window > 1024 || fan < 1 || fan > 32 ||
                 n_groups != (n_windows + fan - 1) / fan ||
                 (size_t)n_windows * window < (size_t)n_tri)))
    return (int)cudaErrorInvalidValue;
  KrngArgs a{{seed0, seed1, seed2}, sample0, lane_ids, amask, state0, resid_in,
             acc, cnt, resid_out, rresid, next_lane, rres_n, n, S, nb,
             thresh, eps,
             {reinterpret_cast<const float4*>(tri_win), wbox, wbox1, n_windows, n_groups,
              window, fan},
             nullptr, nullptr};
  const int grid = (n + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      no_glossy ? launch_krng<true>(s, a, mode, th, resume, grid, block, st)
                : launch_krng<false>(s, a, mode, th, resume, grid, block, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
