// Device helpers shared by the probe kernels G-J (probe_*.cu): JAX's
// integer semantics, block reductions, and an opaque value the compiler
// cannot fold.
#pragma once

#include <cuda_runtime.h>

namespace gsjax {
namespace probe {

constexpr unsigned kFull = 0xffffffffu;

// jnp's // and % on int32: floor division and a remainder with the
// divisor's sign (C's / and % truncate toward zero). d > 0.
__device__ __forceinline__ int floor_div(int a, int d) {
  const int q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int d) {
  const int r = a % d;
  return r < 0 ? r + d : r;
}

// int32 arithmetic that wraps, as jnp's does (signed overflow is
// undefined in C++, so it goes through uint32)
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// A value the compiler must treat as unknown. The probes make loop
// bounds data-dependent with `x % 1` (always 0), which nvcc folds to a
// constant; passing the result through an empty asm statement keeps the
// bound dynamic, as it is on the TPU.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;  // lane 0 holds the warp's sum
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// Sum P rows of K values over the warp's 32 lanes in one reduce-scatter:
// v[q·K + k] is row q's value k (P a power of two, at most 32). log2 P
// halving steps (lanes across offset 16, 8, …, 32/P swap halves, each
// keeps one half and adds the other's: K(P−1) shuffles) leave lane l the K
// values of row l / (32/P), summed over the lanes that share its top
// bits; a butterfly over the remaining log2(32/P) bits finishes the sums
// (K·log2(32/P) shuffles), so every lane of row q's group holds q's K sums
// in v[0..K−1]. One warp_sum per value costs 5PK. This is the scheme of
// the blend backward's warp_reduce_scatter (gsjax_torch/csrc/blend.cuh:416,
// K = 9 gradients), with K a parameter: kernel J's bwdsums prices it.
template <int P, int K>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[P * K], int lane) {
  static_assert(P >= 1 && P <= 32 && (P & (P - 1)) == 0, "P: a power of two <= 32");
  // constant trip counts, fully unrolled: every index of v is a constant
  // and v stays in registers
  constexpr int kHalvings = log2i(P);
#pragma unroll
  for (int lvl = 0; lvl < kHalvings; ++lvl) {
    const int off = 16 >> lvl;
    const int half = (P * K) >> (lvl + 1);
    const bool hi = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < (P * K) / 2; ++j) {
      if (j < half) {
        const float send = hi ? v[j] : v[j + half];
        const float keep = hi ? v[j + half] : v[j];
        v[j] = keep + __shfl_xor_sync(kFull, send, off);
      }
    }
  }
#pragma unroll
  for (int b = kHalvings; b < 5; ++b) {
    const int off = 16 >> b;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
}

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024):
// each warp's shuffle sum, then the warps' sums added in warp order by
// thread 0 — the same order in every launch. red holds 32 floats. The
// result is valid in thread 0; every thread must call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();  // red may be reused after the call
  return s;
}

// int32 sum over the block, wrapping (valid in thread 0)
__device__ __forceinline__ int block_sum_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s = wadd(s, red[w]);
  __syncthreads();
  return s;
}

}  // namespace probe
}  // namespace gsjax
