// Kernel K6: the streamed triangle search of K4's stream mode, and the
// culled warp search of K4's replay mode (the same boxes).
//
// Replaces the JAX package's ops/pallas_megakernel.py _stream_tri (run
// inside _megakernel_regen_krng when stream=True). The Morton-ordered Woop
// rows are cut into windows of `window` triangles (a multiple of 64) with
// one AABB each, and every `fan` consecutive windows into a group with one
// level-1 box (ops/megakernel.PackedSceneStream: tri_win [n_win * window,
// 12], wbox [n_win, 8], wbox1 [n_groups, 8] = lo3 hi3 pad2). Per bounce,
// after the sphere search, the block walks the groups in order:
//
//   1. every thread whose ray can still improve its winner inside the
//      group's box (window_enter) tests the group's window boxes, one bit
//      each; one block barrier (__syncthreads_or) tells whether any ray
//      entered any window of the group: a group nobody enters costs one
//      barrier, not `fan`;
//   2. per entered group, each warp ballots its rays per window; the rays
//      that voted for a window are listed in shared memory (ballot and
//      popc prefix over the block's warps);
//   3. the entered windows are scanned in order. The listed rays' (ray,
//      chunk) pairs are spread over the block's warps: a warp tests one ray
//      against the chunk's 64 rows, two rows a lane, and reduces the packed
//      winners (t_bits & ~63) | row with one warp minimum into a shared
//      slot of the ray; after the next barrier the ray's own thread applies
//      the chunk minima in chunk order with the resident rule (strict ct <
//      best_t). A warp pays for the (ray, chunk) pairs the rays need, not
//      64 rows a lane whenever one of its rays votes. The next entered
//      window is copied into a second buffer (one TMA bulk copy issued by
//      one thread, completed on the buffer's mbarrier) while the block
//      scans the current one: one barrier a window.
//
// Exactness. A lane's winner equals the resident scan's bit for bit: the
// sphere search runs first (the strict-< triangle rule), chunk boundaries,
// row order and rounding are the resident kernel's (one woop_hit_t), an
// integer minimum does not depend on the order the block's warps take, and
// the chunk minima are applied in chunk order. A window is skipped only when
// no triangle in its box can win: the packed winner lowers a chunk's t by
// up to 63 ulp, so a triangle whose t lies just above a sphere's best_t can
// still win the resident scan, and the window test therefore compares the
// box entry against the top of best_t's packing bucket (best_t | 63). The
// boxes are widened by a margin of hundreds of ulps of the scene's scale
// (PackedSceneStream.wbox_margin), so the rounding of the slab times and of
// the triangle's t cannot skip a hit on a box face or on an edge shared
// between windows; a level-1 box contains its windows' boxes and the slab
// test rounds monotonically in the faces, so a group is skipped only when
// each of its windows would be. A group's window votes use best_t from
// before the group's scans: best_t only falls, so the votes are a superset
// and a superset never changes a minimum. Padding rows past n_tri are
// all-zero Woop rows, which the parallel test rejects.
//
// Bound: FP32 operations of the triangle tests in the windows each ray
// enters; the window loads come from L2 (a 2.9 MB table fits the 50 MB L2).
// Every thread of a block takes part in every vote and load, so the loop
// around it (megakernel.cu, STREAM) is block-synchronous: a dead or
// exhausted lane votes no and does no math. A block's phases between
// barriers are short (a window holds few of its rays), so the kernel is
// bound by latency and the number of warps in flight: megakernel.cu caps
// the stream kernel's registers so that 8 blocks fit an SM. The winner's
// attribute row is one indexed load after the search, as in the resident
// kernel (the TPU kernel's in-loop attribute capture is not carried over).
//
// culled_search_warp (K4's resident and replay modes, packed) and
// culled_search_warp_near (K2 and K7, unpacked): each lane walks the same
// hierarchy for its own ray, box by box with __ldg and no block barrier,
// and the warp spreads each entered (ray, window) pair's tests over its 32
// lanes, as the stream search does over the block.
#pragma once

#include "pt3_device.cuh"

namespace pt3 {

struct StreamView {
  const float4* __restrict__ tri_win;  // [n_windows * window * 3] (12 floats a row)
  const float* __restrict__ wbox;      // [n_windows, 8] lo3 hi3 pad2
  const float* __restrict__ wbox1;     // [n_groups, 8] lo3 hi3 pad2
  int n_windows;
  int n_groups;
  int window;                          // rows per window, a multiple of kTc
  int fan;                             // windows per group, <= 32
};

// Byte offsets of K6's dynamic shared memory (host and device agree).
struct StreamLayout {
  int mbar, win, rays, slot, ballot, wor, list, total;
};

__host__ __device__ inline StreamLayout stream_layout(int window, int fan, int block) {
  StreamLayout L;
  const int nwarps = block / 32;
  int off = 0;
  L.mbar = off;
  off += 16;  // one mbarrier a buffer
  L.win = off;
  off += 2 * window * 48;
  L.rays = off;
  off += block * 32;  // org, dir as two float4 per thread
  L.slot = off;
  off += 2 * (window / kTc) * block * 4;  // two sets, by window parity
  L.ballot = off;
  off += fan * nwarps * 4;
  L.wor = off;
  off += nwarps * 4;
  L.list = off;
  off += fan * block * 2;
  L.total = (off + 15) & ~15;
  return L;
}

// The top of a finite positive t's packing bucket (its bits | 63); other
// values unchanged.
__device__ __forceinline__ float bucket_top(float t) {
  return (t > 0.0f && isfinite(t)) ? __int_as_float(__float_as_int(t) | 63) : t;
}

// Can this ray's winner still come from inside the box? PACKED: a packed
// chunk minimum lowers t by up to 63 ulp, so the entry is compared with the
// top of best_t's bucket; unpacked, a triangle must be strictly nearer than
// best_t, so an entry at or beyond it is skipped.
template <bool PACKED>
__device__ __forceinline__ bool window_enter(const float* box, const Ray& r, float idx_,
                                             float idy, float idz, float best_t,
                                             float eps) {
  float tmin, tmax;
  slab_range(box, r, idx_, idy, idz, tmin, tmax);
  return tmax >= fmaxf(tmin, eps) && (PACKED ? tmin <= bucket_top(best_t) : tmin < best_t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Start the copy of window wi into buffer dst: one bulk copy issued by
// thread 0, completed on the buffer's mbarrier.
__device__ __forceinline__ void window_copy_start(const StreamView& w, int wi, float4* dst,
                                                  uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const uint32_t bytes = (uint32_t)w.window * 48u;
  const float4* src = w.tri_win + (size_t)wi * w.window * 3;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2,"
      " [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the copy into buffer b (its mbarrier's parity is bit b of phase).
__device__ __forceinline__ void window_copy_wait(uint64_t* bar, int b, uint32_t& phase) {
  mbar_wait(bar, (phase >> b) & 1u);
  phase ^= 1u << b;
}

// The block's warps test the listed rays' (ray, chunk) pairs; the packed
// chunk minimum of ray rt goes to slot[c * blockDim + rt].
__device__ __forceinline__ void window_scan_block(const float4* win, const float4* rays,
                                                  const unsigned short* list, int m, int rows,
                                                  int tc, float eps, int* slot) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nc = (rows + tc - 1) / tc;
  for (int q = threadIdx.x >> 5; q < m * nc; q += nwarps) {
    const int li = q / nc;
    const int c = q - li * nc;
    const int rt = list[li];
    const float4 o = rays[2 * rt], d = rays[2 * rt + 1];
    const Ray r{o.x, o.y, o.z, d.x, d.y, d.z};
    const int n = min(tc, rows - c * tc);
    const float4* chunk = win + 3 * c * tc;
    int cp = 0x7FFFFFFF;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < n) {
        const float4 a = chunk[3 * j], b = chunk[3 * j + 1], e = chunk[3 * j + 2];
        const float t = woop_hit_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, e.y, e.z,
                                   e.w, r, eps);
        cp = min(cp, (__float_as_int(t) & ~63) | j);
      }
    }
    cp = __reduce_min_sync(0xFFFFFFFFu, cp);
    if (lane == 0) slot[c * blockDim.x + rt] = cp;
  }
}

// The ray's own thread applies a window's chunk minima in chunk order.
__device__ __forceinline__ void window_apply(const int* slot, int base, int rows, int tc,
                                             float& best_t, int& best_i) {
  const int nc = (rows + tc - 1) / tc;
  for (int c = 0; c < nc; ++c) {
    const int cp = slot[c * blockDim.x + threadIdx.x];
    const float ct = __int_as_float(cp & ~63);
    if (ct < best_t) {
      best_t = ct;
      best_i = base + c * tc + (cp & 63);
    }
  }
}

// The streamed triangle search. Every thread of the block must call it
// (the votes and loads are block-wide); `active` threads search, seeded
// with their sphere winner. smem: the dynamic shared memory laid out by
// stream_layout; phase: the buffers' mbarrier parities (kept across calls).
__device__ __forceinline__ void stream_search(const SceneView& s, const StreamView& w,
                                              unsigned char* smem, uint32_t& phase,
                                              const Ray& r, bool active, float eps,
                                              float& best_t, int& best_i) {
  if (s.n_tri <= 0) return;  // uniform over the block
  const StreamLayout L = stream_layout(w.window, w.fan, blockDim.x);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.mbar);
  float4* win = reinterpret_cast<float4*>(smem + L.win);
  float4* rays = reinterpret_cast<float4*>(smem + L.rays);
  int* slots = reinterpret_cast<int*>(smem + L.slot);
  unsigned* ballot = reinterpret_cast<unsigned*>(smem + L.ballot);
  unsigned* wor = reinterpret_cast<unsigned*>(smem + L.wor);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + L.list);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n4 = w.window * 3;
  const int slot_set = (w.window / kTc) * blockDim.x;
  const float idx_ = 1.0f / safe_dir(r.dx);
  const float idy = 1.0f / safe_dir(r.dy);
  const float idz = 1.0f / safe_dir(r.dz);
  const int tc = min(s.t_pad, kTc);
  // visible after the first group's barrier
  rays[2 * tid] = make_float4(r.ox, r.oy, r.oz, 0.0f);
  rays[2 * tid + 1] = make_float4(r.dx, r.dy, r.dz, 0.0f);
  int k = 0;  // windows entered so far: the buffer and slot set parity
  for (int g = 0; g < w.n_groups; ++g) {
    const int w0 = g * w.fan;
    const int nw = min(w.fan, w.n_windows - w0);
    unsigned wm = 0;  // this ray's windows in the group
    if (active && (w.fan == 1 ||
                   window_enter<true>(w.wbox1 + 8 * g, r, idx_, idy, idz, best_t, eps))) {
      for (int j = 0; j < nw; ++j)
        if (window_enter<true>(w.wbox + 8 * (w0 + j), r, idx_, idy, idz, best_t, eps))
          wm |= 1u << j;
    }
    for (int j = 0; j < nw; ++j) {
      const unsigned b = __ballot_sync(0xFFFFFFFFu, (wm >> j) & 1u);
      if (lane == 0) ballot[j * nwarps + warp] = b;
    }
    const unsigned wor_w = __reduce_or_sync(0xFFFFFFFFu, wm);
    if (lane == 0) wor[warp] = wor_w;
    if (!__syncthreads_or(wm != 0u)) continue;
    unsigned any = 0;
    for (int v = 0; v < nwarps; ++v) any |= wor[v];
    // list the voting rays of each window (visible after the next barrier)
    for (unsigned mm = wm; mm; mm &= mm - 1) {
      const int j = __ffs(mm) - 1;
      const unsigned* bj = ballot + j * nwarps;
      int pos = __popc(bj[warp] & ((1u << lane) - 1u));
      for (int v = 0; v < warp; ++v) pos += __popc(bj[v]);
      list[j * blockDim.x + pos] = (unsigned short)tid;
    }
    // the entered windows, in order, each copied while the previous is scanned
    int prev_j = -1;
    window_copy_start(w, w0 + __ffs(any) - 1, win + (k & 1) * n4, bar + (k & 1));
    for (unsigned mm = any; mm; mm &= mm - 1) {
      const int j = __ffs(mm) - 1;
      const int b = k & 1;
      window_copy_wait(bar + b, b, phase);
      __syncthreads();  // the window, the lists and the previous window's slots visible
      if (prev_j >= 0 && ((wm >> prev_j) & 1u)) {
        const int base = (w0 + prev_j) * w.window;
        window_apply(slots + ((k - 1) & 1) * slot_set, base,
                     min(w.window, s.n_tri - base), tc, best_t, best_i);
      }
      const unsigned rest = mm & (mm - 1);
      if (rest) {
        const int b2 = (k + 1) & 1;
        window_copy_start(w, w0 + __ffs(rest) - 1, win + b2 * n4, bar + b2);
      }
      const int base = (w0 + j) * w.window;
      int m = 0;
      for (int v = 0; v < nwarps; ++v) m += __popc(ballot[j * nwarps + v]);
      window_scan_block(win + b * n4, rays, list + j * blockDim.x, m,
                        min(w.window, s.n_tri - base), tc, eps, slots + b * slot_set);
      prev_j = j;
      ++k;
    }
    __syncthreads();  // the last window's slots visible; buffers, lists free
    if ((wm >> prev_j) & 1u) {
      const int base = (w0 + prev_j) * w.window;
      window_apply(slots + ((k - 1) & 1) * slot_set, base, min(w.window, s.n_tri - base), tc,
                   best_t, best_i);
    }
  }
}

// The warp tests the n <= 64 rows from c0 against ray q, two rows a lane
// as three float4 __ldg each, and returns on every lane the chunk's winner
// (ct: +inf on no hit; ci: its triangle): one warp minimum of the packed
// (t_bits & ~63) | row (PACKED), or two: the minimum of t's bits (a valid t
// is > eps > 0 or +inf, so its bits order as integers), then the lowest
// row among the lanes that hold it (unpacked: the exact minimum, the lowest
// row on ties).
template <bool PACKED>
__device__ __forceinline__ void warp_chunk_min(const float4* rows, int c0, int n,
                                               const Ray& q, float eps, int lane, float& ct,
                                               int& ci) {
  const unsigned full = 0xFFFFFFFFu;
  unsigned cp = 0x7FFFFFFFu;  // PACKED: (t_bits & ~63) | row; else t's bits
  int row = kTc;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j < n) {
      const float4* p = rows + 3 * (c0 + j);
      const float4 a = __ldg(p), b = __ldg(p + 1), d = __ldg(p + 2);
      const unsigned tb = __float_as_uint(
          woop_hit_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y, d.z, d.w, q, eps));
      if (PACKED) {
        cp = min(cp, (tb & ~63u) | (unsigned)j);
      } else if (tb < cp) {  // the lower row (h = 0) keeps a tie
        cp = tb;
        row = j;
      }
    }
  }
  const unsigned m = __reduce_min_sync(full, cp);
  if (!PACKED) row = (int)__reduce_min_sync(full, cp == m ? (unsigned)row : kTc);
  ct = __uint_as_float(PACKED ? m & ~63u : m);
  ci = c0 + (PACKED ? (int)(m & 63u) : row);
}

// The culled search of K4's resident and replay modes, with the packed
// winner, its triangle tests compacted over the warp. Every lane of the
// warp must call it. Each `active` lane runs the sphere search, then walks
// the level-1 boxes and, inside each one it enters, the window boxes in
// order (window_enter<true> against its own best_t, boxes read with
// __ldg); per window the warp ballots the lanes that entered it and, for
// each of them in turn, finds the window's chunk minima for that lane's ray
// (shuffled to the warp; warp_chunk_min). The lane applies its chunk minima
// in chunk order with the resident rule (strict ct < best_t). Returns
// (best_t, best_i) as winner_search<true> does, bit for bit. A warp pays
// for the (ray, window) pairs its rays need, not 64 rows a lane for every
// window any of its rays enters.
__device__ __forceinline__ void culled_search_warp(const SceneView& s, const StreamView& w,
                                                   const Ray& r, bool active, float eps,
                                                   float& best_t, int& best_i) {
  best_t = kInf;
  best_i = 0;
  if (active) sphere_search(s, r, eps, best_t, best_i);
  if (s.n_tri <= 0) return;
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const float idx_ = 1.0f / safe_dir(r.dx);
  const float idy = 1.0f / safe_dir(r.dy);
  const float idz = 1.0f / safe_dir(r.dz);
  const int tc = min(s.t_pad, kTc);
  const float4* rows = reinterpret_cast<const float4*>(s.tri);
  for (int g = 0; g < w.n_groups; ++g) {
    const bool eg =
        active && window_enter<true>(w.wbox1 + 8 * g, r, idx_, idy, idz, best_t, eps);
    if (!__any_sync(full, eg)) continue;
    const int w1 = min((g + 1) * w.fan, w.n_windows);
    for (int wi = g * w.fan; wi < w1; ++wi) {
      unsigned voters = __ballot_sync(
          full, eg && window_enter<true>(w.wbox + 8 * wi, r, idx_, idy, idz, best_t, eps));
      const int base = wi * w.window;
      const int end = min(base + w.window, s.n_tri);
      for (; voters; voters &= voters - 1) {
        const int src = __ffs(voters) - 1;
        const Ray q{__shfl_sync(full, r.ox, src), __shfl_sync(full, r.oy, src),
                    __shfl_sync(full, r.oz, src), __shfl_sync(full, r.dx, src),
                    __shfl_sync(full, r.dy, src), __shfl_sync(full, r.dz, src)};
        for (int c0 = base; c0 < end; c0 += tc) {
          float ct;
          int ci;
          warp_chunk_min<true>(rows, c0, min(tc, end - c0), q, eps, lane, ct, ci);
          if (lane == src && ct < best_t) {
            best_t = ct;
            best_i = ci;
          }
        }
      }
    }
  }
}

// The culled search of K2 and K7, with the unpacked winner:
// culled_search_warp's walk (the level-1 boxes in order, each entered
// (ray, window) pair's 64 tests spread over the warp), but inside a
// level-1 box each lane scans its windows nearest entry first, dropping
// those whose entry is no longer before its best_t: rays through a mesh
// leave the windows behind their hit unscanned. In each round every lane
// with a window left picks its nearest one; when at least
// kThreadScanVoters lanes picked the first voter's window (coherent camera
// rays mostly do), each of them scans that window for its own ray, one row
// a step, and the warp spreads the remaining picked (ray, window) pairs one
// by one. A chunk's minimum is taken when strictly nearer, or at the same t
// with a lower triangle index while best_i is a triangle (spheres keep
// their ties): the winner is the lowest index at the least t in any order,
// that of winner_search<false>, bit for bit. A window is dropped only when
// its widened box's entry is at or beyond best_t, and every hit inside
// lies beyond the entry (the margin), so no window that holds a triangle
// at t <= best_t is dropped. chip_smoke.py builds intersect.cu again with
// other values of -DPT3_THREAD_SCAN_VOTERS (33: no per-lane scan) and
// times them against this one on K2's launches.
#ifndef PT3_THREAD_SCAN_VOTERS
#define PT3_THREAD_SCAN_VOTERS 24
#endif
constexpr int kThreadScanVoters = PT3_THREAD_SCAN_VOTERS;

__device__ __forceinline__ void culled_search_warp_near(const SceneView& s,
                                                        const StreamView& w, const Ray& r,
                                                        bool active, float eps, float& best_t,
                                                        int& best_i) {
  best_t = kInf;
  best_i = 0;
  if (active) sphere_search(s, r, eps, best_t, best_i);
  if (s.n_tri <= 0) return;
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const float idx_ = 1.0f / safe_dir(r.dx);
  const float idy = 1.0f / safe_dir(r.dy);
  const float idz = 1.0f / safe_dir(r.dz);
  const int tc = min(s.t_pad, kTc);
  const float4* rows = reinterpret_cast<const float4*>(s.tri);
  for (int g = 0; g < w.n_groups; ++g) {
    const bool eg =
        active && window_enter<false>(w.wbox1 + 8 * g, r, idx_, idy, idz, best_t, eps);
    if (!__any_sync(full, eg)) continue;
    const int w0 = g * w.fan;
    const int nw = min(w.fan, w.n_windows - w0);
    unsigned todo = 0;  // this lane's windows of the group left to scan
    if (eg)
      for (int j = 0; j < nw; ++j)
        if (window_enter<false>(w.wbox + 8 * (w0 + j), r, idx_, idy, idz, best_t, eps))
          todo |= 1u << j;
    for (;;) {
      int pick = -1;
      float nearest = kInf;
      for (unsigned mm = todo; mm; mm &= mm - 1) {
        const int j = __ffs(mm) - 1;
        float tmin, tmax;
        slab_range(w.wbox + 8 * (w0 + j), r, idx_, idy, idz, tmin, tmax);
        if (!(tmin < best_t)) todo &= ~(1u << j);
        else if (tmin < nearest) {
          nearest = tmin;
          pick = j;
        }
      }
      unsigned voters = __ballot_sync(full, pick >= 0);
      if (!voters) break;
      if (pick >= 0) todo &= ~(1u << pick);
      // a window picked by most of the warp is scanned by each of those
      // lanes for its own ray (the rows are warp-uniform loads): 64 tests a
      // lane, against about 2.8 a lane per ray spread over the warp
      const int first = __shfl_sync(full, pick, __ffs(voters) - 1);
      const unsigned same = __ballot_sync(full, pick == first);
      if (__popc(same) >= kThreadScanVoters) {
        voters &= ~same;
        if ((same >> lane) & 1u) {
          const int base = (w0 + first) * w.window;
          const int end = min(base + w.window, s.n_tri);
          for (int c0 = base; c0 < end; c0 += tc) {
            const int c1 = min(c0 + tc, end);
            float ct = kInf;
            int ci = 0;
            for (int j = c0; j < c1; ++j) {
              const float4* p = rows + 3 * j;
              const float4 a = __ldg(p), b = __ldg(p + 1), d = __ldg(p + 2);
              const float t = woop_hit_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y,
                                         d.z, d.w, r, eps);
              if (t < ct) {  // the lowest row keeps a tie
                ct = t;
                ci = j;
              }
            }
            if (ct < best_t || (ct == best_t && best_i < s.n_tri && ci < best_i)) {
              best_t = ct;
              best_i = ci;
            }
          }
        }
      }
      for (; voters; voters &= voters - 1) {
        const int src = __ffs(voters) - 1;
        const Ray q{__shfl_sync(full, r.ox, src), __shfl_sync(full, r.oy, src),
                    __shfl_sync(full, r.oz, src), __shfl_sync(full, r.dx, src),
                    __shfl_sync(full, r.dy, src), __shfl_sync(full, r.dz, src)};
        const int base = (w0 + __shfl_sync(full, pick, src)) * w.window;
        const int end = min(base + w.window, s.n_tri);
        for (int c0 = base; c0 < end; c0 += tc) {
          float ct;
          int ci;
          warp_chunk_min<false>(rows, c0, min(tc, end - c0), q, eps, lane, ct, ci);
          if (lane == src &&
              (ct < best_t || (ct == best_t && best_i < s.n_tri && ci < best_i))) {
            best_t = ct;
            best_i = ci;
          }
        }
      }
    }
  }
}

}  // namespace pt3
