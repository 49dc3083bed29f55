// Kernel K6: the streamed triangle search of K4's stream mode.
//
// Replaces the JAX package's ops/pallas_megakernel.py _stream_tri (run
// inside _megakernel_regen_krng when stream=True). The Morton-ordered Woop
// rows are cut into windows of `window` triangles (a multiple of 64) with
// one AABB each (ops/megakernel.PackedSceneStream: tri_win [n_win * window,
// 12], wbox [n_win, 8] = lo3 hi3 pad2). Per bounce, after the sphere search,
// the block walks the windows in order:
//
//   1. every thread votes whether its ray can still improve its winner
//      inside the window's box (window_enter); the vote is a block barrier
//      (__syncthreads_or), and a window nobody enters is never loaded;
//   2. the block copies the window's window * 48 bytes into shared memory
//      with coalesced 16-byte loads, then __syncthreads();
//   3. each thread that voted scans the window's 64-row chunks with the
//      resident kernel's triangle test (woop_hit_t) and packed winner, at
//      the resident chunk boundaries (tc = min(t_pad, 64)). The chunk loop
//      is its own, over rows relative to the chunk: sharing one loop with
//      the resident scan cost one of the two scans 2-8 % on the H100.
//
// The next window's vote barrier is the barrier that keeps its load from
// overwriting rows a slower thread still scans.
//
// Exactness. A lane's winner equals the resident scan's bit for bit: the
// sphere search runs first (the strict-< triangle rule), chunk boundaries,
// row order and rounding are the resident kernel's, and a window is skipped
// only when no triangle in its box can win. The packed winner lowers a
// chunk's t by up to 63 ulp, so a triangle whose t lies just above a
// sphere's best_t can still win the resident scan; the window test
// therefore compares the box entry against the top of best_t's packing
// bucket (best_t | 63), not best_t itself. The boxes are widened by a margin
// of hundreds of ulps of the scene's scale (PackedSceneStream.wbox_margin),
// so the rounding of the slab times and of the triangle's t cannot skip a
// hit on a box face or on an edge shared between windows. Padding rows past n_tri are never
// scanned (they are all-zero Woop rows, which the parallel test rejects).
//
// Bound: FP32 operations of the triangle tests, as the resident K4; the
// window loads come from L2 (a 2.9 MB table fits the 50 MB L2). Every
// thread of a block takes part in every vote and load, so the loop around
// it (megakernel.cu, STREAM) is block-synchronous: a dead or exhausted lane
// votes no and does no math. The TPU kernel's ping/pong double buffer and
// its in-loop attribute capture are not carried over: the copy is
// synchronous, and the winner's attribute row is one indexed load after the
// search, as in the resident kernel.
#pragma once

#include "pt3_device.cuh"

namespace pt3 {

struct StreamView {
  const float4* __restrict__ tri_win;  // [n_windows * window * 3] (12 floats a row)
  const float* __restrict__ wbox;      // [n_windows, 8] lo3 hi3 pad2
  int n_windows;
  int window;                          // rows per window, a multiple of kTc
};

// The top of a finite positive t's packing bucket (its bits | 63); other
// values unchanged.
__device__ __forceinline__ float bucket_top(float t) {
  return (t > 0.0f && isfinite(t)) ? __int_as_float(__float_as_int(t) | 63) : t;
}

// Can this ray's winner still come from inside the window's box?
__device__ __forceinline__ bool window_enter(const float* box, const Ray& r, float idx_,
                                             float idy, float idz, float best_t,
                                             float eps) {
  float tmin, tmax;
  slab_range(box, r, idx_, idy, idz, tmin, tmax);
  return tmax >= fmaxf(tmin, eps) && tmin <= bucket_top(best_t);
}

// The streamed triangle search. Every thread of the block must call it
// (the votes and loads are block-wide); `active` threads search, seeded
// with their sphere winner. win: window * 3 float4 of dynamic shared memory.
__device__ __forceinline__ void stream_search(const SceneView& s, const StreamView& w,
                                              float4* win, const Ray& r, bool active,
                                              float eps, float& best_t, int& best_i) {
  if (s.n_tri <= 0) return;  // uniform over the block
  const float idx_ = 1.0f / safe_dir(r.dx);
  const float idy = 1.0f / safe_dir(r.dy);
  const float idz = 1.0f / safe_dir(r.dz);
  const int tc = min(s.t_pad, kTc);
  const int n4 = w.window * 3;
  for (int wi = 0; wi < w.n_windows; ++wi) {
    const bool want =
        active && window_enter(w.wbox + 8 * wi, r, idx_, idy, idz, best_t, eps);
    if (!__syncthreads_or(want)) continue;
    const float4* src = w.tri_win + (size_t)wi * n4;
    for (int k = threadIdx.x; k < n4; k += blockDim.x) win[k] = __ldg(src + k);
    __syncthreads();
    if (want) {
      const int base = wi * w.window;
      const int rows = min(w.window, s.n_tri - base);
      for (int c = 0; c < rows; c += tc) {
        const float4* chunk = win + 3 * c;
        const int n = min(tc, rows - c);
        int cp = 0x7FFFFFFF;
        for (int j = 0; j < n; ++j) {
          const float4 a = chunk[3 * j], b = chunk[3 * j + 1], d = chunk[3 * j + 2];
          const float t = woop_hit_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y, d.z,
                                     d.w, r, eps);
          cp = min(cp, (__float_as_int(t) & ~63) | j);
        }
        const float ct = __int_as_float(cp & ~63);
        if (ct < best_t) {
          best_t = ct;
          best_i = base + c + (cp & 63);
        }
      }
    }
  }
}

}  // namespace pt3
