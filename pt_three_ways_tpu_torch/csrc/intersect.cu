// Kernel K2: nearest sphere+triangle hit per ray (the camera stage).
//
// Replaces the JAX package's Pallas kernel ops/pallas_intersect.py
// (_intersect_kernel / _run, body intersect_tile). One thread per ray, with
// one of two searches, picked by the launch from the scene as K4 picks its
// resident design (flat_scene.cuh: flat_fits):
//
//   * a scene of at most one 64-row chunk (cornell) is staged in shared
//     memory once per block (Woop and sphere rows) and every thread scans it
//     as warp-uniform float4 broadcasts: every ray tests every primitive,
//     nothing to cull;
//   * any other scene takes the culled warp search with the unpacked winner
//     (stream_tri.cuh: culled_search_warp_near): each lane walks the window
//     boxes of its own ray (64-row windows widened by WBOX_MARGIN, fan-16
//     level-1 boxes, held by the pack), inside a level-1 box nearest entry
//     first, and the warp spreads each (ray, window) pair's 64 tests over
//     its 32 lanes, except that a window most of the warp picked at once is
//     scanned by each of those lanes for its own ray. Camera rays are
//     coherent (a per-thread culled scan keeps 0.92 of its lanes busy on
//     suzanne's): spreading the tests alone saves little there and pays two
//     warp minimums a pair; scanning the windows nearest first skips those
//     behind the hit.
//
// Both give winner_search<false>'s winner bit for bit (the lowest index at
// the least t; spheres first and winning a tie). A thread past n stays in
// the warp as an inactive lane (the search's shuffles and ballots take the
// full warp); dead and inactive lanes report a miss (+inf, index 0).
//
// Bound: FP32 operations of the tests (every primitive on one-chunk scenes;
// the windows each ray enters before its winner otherwise). Bytes are 25 a
// ray in (origin, direction, live) and 8 out.
#include "flat_scene.cuh"
#include "stream_tri.cuh"

namespace {

constexpr int kBlock = 128;
// the culled instance's registers are capped so that 8 blocks fit an SM,
// as K4's culled search (megakernel.cu kCappedMinBlocks)
constexpr int kCulledMinBlocks = 8;

template <bool FLAT>
__global__ void __launch_bounds__(kBlock, FLAT ? 1 : kCulledMinBlocks)
intersect_kernel(pt3::SceneView s, pt3::StreamView w, const float* __restrict__ org,
                 const float* __restrict__ dir, const unsigned char* __restrict__ live,
                 float* __restrict__ t_out, int* __restrict__ idx_out, int n, float eps) {
  extern __shared__ __align__(16) float smem[];  // FLAT: flat_layout's first two tables
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  const int li = valid ? i : 0;
  const bool active = valid && live[li] != 0;
  const pt3::Ray r{org[li], org[n + li], org[2 * n + li],
                   dir[li], dir[n + li], dir[2 * n + li]};
  float best_t = pt3::kInf;
  int best_i = 0;
  if constexpr (FLAT) {
    const pt3::SceneView v = pt3::flat_stage<false>(s, smem);
    if (active) pt3::winner_search<false, true>(v, r, eps, best_t, best_i);
  } else {
    pt3::culled_search_warp_near(s, w, r, active, eps, best_t, best_i);
  }
  if (!valid) return;
  t_out[i] = best_t;
  idx_out[i] = best_i;
}

}  // namespace

// live: [n] bytes (a bool tensor); the window tables are needed unless the
// scene fits flat_fits.
extern "C" int pt3_intersect(const float* tri, const float* sph, int n_tri, int n_sph,
                             int t_pad, const float* wbox, const float* wbox1, int n_windows,
                             int n_groups, int window, int fan, const float* org,
                             const float* dir, const unsigned char* live, float* t_out,
                             int* idx_out, int n, float eps, void* stream) {
  pt3::SceneView s{tri, sph, nullptr, nullptr, n_tri, n_sph, t_pad, {0.f, 0.f, 0.f}};
  if (n <= 0) return (int)cudaGetLastError();
  const bool flat = pt3::flat_fits(n_tri, n_sph);
  if (!flat && (wbox == nullptr || wbox1 == nullptr || n_windows <= 0 || window <= 0 ||
                window % pt3::kTc != 0 || fan < 1 || fan > 32 ||
                n_groups != (n_windows + fan - 1) / fan ||
                (size_t)n_windows * window < (size_t)n_tri))
    return (int)cudaErrorInvalidValue;
  const pt3::StreamView w{nullptr, wbox, wbox1, n_windows, n_groups, window, fan};
  const int grid = (n + kBlock - 1) / kBlock;
  cudaStream_t st = (cudaStream_t)stream;
  if (flat)
    intersect_kernel<true><<<grid, kBlock,
                             pt3::flat_layout(n_tri, n_sph).sph_attr * sizeof(float), st>>>(
        s, w, org, dir, live, t_out, idx_out, n, eps);
  else
    intersect_kernel<false><<<grid, kBlock, 0, st>>>(s, w, org, dir, live, t_out, idx_out, n,
                                                     eps);
  return (int)cudaGetLastError();
}
