// A scene of at most one 64-row triangle chunk, staged in shared memory once
// per block: the one-chunk design of K4's resident mode (megakernel.cu,
// FLAT) and of K2 (intersect.cu). Each thread then scans every primitive as
// warp-uniform broadcasts (winner_search<..., SMEM = true>): nothing is
// culled, and no table is read from global memory in the loop.
#pragma once

#include "pt3_device.cuh"

namespace pt3 {

// Shared-memory layout: Woop rows, sphere rows, sphere attributes, then
// triangle attributes (each table's offset 16-byte aligned but the last).
// K2 stages the first two tables only.
struct FlatLayout {
  int tri, sph, sph_attr, tri_attr, total;  // floats
};

__host__ __device__ inline FlatLayout flat_layout(int n_tri, int n_sph) {
  FlatLayout L;
  L.tri = 0;
  L.sph = 12 * n_tri;
  L.sph_attr = L.sph + 8 * n_sph;
  L.tri_attr = L.sph_attr + kSphAttr * n_sph;
  L.total = L.tri_attr + kTriAttr * n_tri;
  return L;
}

// The one-chunk design takes a scene of at most one chunk whose tables fit
// the default 48 KB of shared memory; K2 and K4 decide alike. Built with
// -DPT3_K4_ONE_CHUNK_CULLED (chip_smoke.py's second builds of
// megakernel.cu and bounce_step.cu), such a scene takes the culled warp
// search instead, so that the two designs are timed on the same launches.
inline bool flat_fits(int n_tri, int n_sph) {
#ifdef PT3_K4_ONE_CHUNK_CULLED
  (void)n_tri;
  (void)n_sph;
  return false;
#else
  return n_tri <= kTc && flat_layout(n_tri, n_sph).total * sizeof(float) <= 48 * 1024;
#endif
}

// The block copies the scene tables into shared memory (the attribute rows
// too when ATTR) and returns the view that reads them there. Every thread
// of the block must call it.
template <bool ATTR>
__device__ __forceinline__ SceneView flat_stage(const SceneView& s, float* sm) {
  const FlatLayout L = flat_layout(s.n_tri, s.n_sph);
  const int end = ATTR ? L.total : L.sph_attr;
  for (int i = threadIdx.x; i < end; i += blockDim.x) {
    float v;
    if (i < L.sph) v = __ldg(s.tri + i);
    else if (i < L.sph_attr) v = __ldg(s.sph + (i - L.sph));
    else if (i < L.tri_attr) v = __ldg(s.sph_attr + (i - L.sph_attr));
    else v = __ldg(s.tri_attr + (i - L.tri_attr));
    sm[i] = v;
  }
  __syncthreads();
  SceneView v = s;
  v.tri = sm + L.tri;
  v.sph = sm + L.sph;
  if (ATTR) {
    v.sph_attr = sm + L.sph_attr;
    v.tri_attr = sm + L.tri_attr;
  }
  return v;
}

}  // namespace pt3
