// Kernel K11: jax.random.uniform's bits for a whole ops/rng.uniforms call.
//
// Replaces no Pallas kernel: its counterpart in the JAX package is XLA's
// lowering of jax.random.uniform (pt_three_ways_tpu/ops/rng.py: uniforms),
// which the port first wrote as eager int64 PyTorch (ops/rng.py: uniform,
// ~150 elementwise kernels a call, uint32 emulated with masks). It is the
// camera stage's generator: the camera rays', the first bounce's and the
// bounce tables' uniforms (K5's and K7's) all come from it on the card.
//
// For each flat index i the counter pair is (i >> 32, i & 0xFFFFFFFF) (the
// jax_threefry_partitionable layout); threefry2x32 with 20 rounds gives
// (o1, o2). float32 takes the top 23 bits of o1 ^ o2 as the mantissa of a
// float in [1, 2), minus 1; float64 the top 52 bits of (o1 << 32 | o2).
// The result equals ops/rng.uniform bit for bit.
//
// Bound: integer issue. The kernel reads nothing; each element costs ~80
// 32-bit integer instructions (20 rounds of add, rotate and xor, 5 key
// injections, the float's assembly) against 4 or 8 bytes stored. Design on
// the H100:
//
//   * every word lives in registers; a rotation is one funnel shift
//     (__funnelshift_l), not two shifts and an or;
//   * a thread makes kPer consecutive elements, four independent hash
//     chains for the schedulers to interleave, and stores them as 16-byte
//     vectors (one float4, or two double2); a ragged tail past the last
//     whole vector is stored element by element;
//   * the wrapper allocates the output (torch.empty) and launches on
//     PyTorch's current stream; the kernel allocates nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPer = 4;  // consecutive elements a thread

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// four rounds of threefry2x32's mix
#define PT3_MIX4(a, b, c, d) \
  x0 += x1; x1 = rotl(x1, a) ^ x0; \
  x0 += x1; x1 = rotl(x1, b) ^ x0; \
  x0 += x1; x1 = rotl(x1, c) ^ x0; \
  x0 += x1; x1 = rotl(x1, d) ^ x0;

// threefry2x32 (20 rounds) of the counter (hi, lo): the schedule of jax's
// _threefry2x32_lowering and of ops/rng.threefry2x32; k2 = k0 ^ k1 ^ C
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t k2, uint32_t hi,
                                         uint32_t lo, uint32_t& o1, uint32_t& o2) {
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
  PT3_MIX4(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  PT3_MIX4(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  PT3_MIX4(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  PT3_MIX4(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  PT3_MIX4(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
  o1 = x0;
  o2 = x1;
}

#undef PT3_MIX4

__device__ __forceinline__ float to_float(uint32_t o1, uint32_t o2) {
  return __uint_as_float(((o1 ^ o2) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double to_double(uint32_t o1, uint32_t o2) {
  const uint64_t bits = (((uint64_t)o1 << 32) | o2) >> 12;
  return __longlong_as_double((long long)(bits | 0x3FF0000000000000ull)) - 1.0;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
threefry_uniform_kernel(uint32_t k0, uint32_t k1, long long n, T* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const long long base = ((long long)blockIdx.x * kBlock + threadIdx.x) * kPer;
  if (base >= n) return;
  T v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned long long i = (unsigned long long)(base + j);
    uint32_t o1, o2;
    threefry(k0, k1, k2, (uint32_t)(i >> 32), (uint32_t)i, o1, o2);
    if constexpr (sizeof(T) == 4)
      v[j] = to_float(o1, o2);
    else
      v[j] = to_double(o1, o2);
  }
  if (base + kPer <= n) {
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(out)[base / kPer] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      double2* o = reinterpret_cast<double2*>(out + base);
      o[0] = make_double2(v[0], v[1]);
      o[1] = make_double2(v[2], v[3]);
    }
  } else {
    for (int j = 0; base + j < n; ++j) out[base + j] = v[j];
  }
}

}  // namespace

// out: n elements, 16-byte aligned (a fresh torch.empty); dtype 0 float32,
// 1 float64. Returns cudaErrorInvalidValue for another dtype or n < 0.
extern "C" int pt3_threefry_uniform(unsigned k0, unsigned k1, long long n, void* out, int dtype,
                                    void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const long long grid = (n + (long long)kBlock * kPer - 1) / ((long long)kBlock * kPer);
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    threefry_uniform_kernel<float><<<(unsigned)grid, kBlock, 0, st>>>(k0, k1, n, (float*)out);
  else
    threefry_uniform_kernel<double><<<(unsigned)grid, kBlock, 0, st>>>(k0, k1, n, (double*)out);
  return (int)cudaGetLastError();
}
