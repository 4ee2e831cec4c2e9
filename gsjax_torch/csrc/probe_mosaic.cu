// Kernel G: the Mosaic-primitives probe on Hopper.
//
// Replaces the TPU kernel tools/probe_mosaic.py::kernel. On x [8, 2048]
// int32, in order: y = roll(x, x[0,0] mod 1024) along the lanes (np.roll's
// direction: y[r, i] = x[r, (i − amt) mod 2048]); col = y[3, k·128 ..
// k·128 + 127] with k = x[0,2] mod 16; acc = col, then acc += col while
// fewer than 4 adds were made and max(acc) < 1e9; z = one bitonic
// compare-exchange substage at distance 16 (z[r, i] = y[r, i^16] where
// y[r, i] > y[r, i^16], else y[r, i]; the probe's tie rule picks between
// equal values, so it does not change z). Writes o[l] = z[0, l] + acc[0]
// + Σ z[1, :] for l < 128 (the probe's row 3 of o) and s = Σ z, every
// sum wrapping in int32.
//
// Hopper's forms: one block of 1024 threads stages x in shared memory
// (64 KB, dynamic) by one bulk asynchronous copy (the TMA's
// cp.async.bulk, x 16-byte aligned) that thread 0 issues and the block
// waits for on one mbarrier (expect_tx of the 64 KB); the roll is a
// rotated index into it; the dynamic
// slice and its transpose are one thread per element reading
// y[3, k·128 + l]; the data-dependent loop stays a loop whose exit test
// is reduced over the block (__syncthreads_or); the substage's partner
// lane i^16 is lane (i mod 32)^16 of the same warp, so the exchange is
// one __shfl_xor_sync; the sums are warp reductions (redux.sync) and one
// pass over the warps' partials, in uint32.
//
// Bound on the card: none that matters — 64 KB in, 516 bytes out and
// ~100k integer operations take well under a microsecond at the card's
// rates; one launch of one block measures the launch (the empty launch
// at this shape, csrc/probe_empty.cu), a 64 KB stage, one SM's issue of
// the 16k elements' substage and one block's barriers.
#include "probe.cuh"

namespace {

using namespace gsjax::probe;

constexpr int kRowsG = 8;
constexpr int kCap = 2048;
constexpr int kThreadsG = 1024;
constexpr int kLoopMax = 1000000000;  // the probe's 10**9
constexpr int kStageBytes = static_cast<int>(sizeof(int)) * kRowsG * kCap;  // 64 KB

__global__ void mosaic_kernel(const int* __restrict__ x, int* __restrict__ o,
                              int* __restrict__ s) {
  extern __shared__ __align__(128) int xs[];  // [8][2048]
  __shared__ int red[2][32];
  __shared__ int acc0, row1;
  __shared__ __align__(8) unsigned long long stage_bar;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the stage: one bulk copy of x into xs by the TMA, which completes the
  // barrier's transaction count when its 64 KB have landed
  const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(&stage_bar));
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(kStageBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(xs))), "l"(x),
           "r"(kStageBytes), "r"(bar) : "memory");
  }
  __syncthreads();  // the barrier is initialised before any thread waits on it
  unsigned staged = 0;
  while (!staged) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(staged) : "r"(bar) : "memory");
  }
  const int amt = floor_mod(xs[0], 1024);
  const int k = floor_mod(xs[2], kCap / 128);
  // y[r, i]: the roll as a rotated index (kCap is a power of two)
  auto y = [&](int r, int i) { return xs[r * kCap + ((i - amt) & (kCap - 1))]; };

  // the dynamic slice of row 3, one lane per thread, and the loop
  const int col = tid < 128 ? y(3, k * 128 + tid) : 0;
  int acc = col;
  for (int it = 0; it < 4; ++it) {
    if (__syncthreads_or(tid < 128 && acc >= kLoopMax)) break;
    acc = wadd(acc, col);
  }
  if (tid == 0) acc0 = acc;

  // the substage at distance 16; thread tid holds elements tid + 1024·m
  int sum_all = 0, sum_row1 = 0, z0 = 0;
#pragma unroll 4
  for (int m = 0; m < kRowsG * kCap / kThreadsG; ++m) {
    const int e = tid + m * kThreadsG;
    const int r = e / kCap, i = e % kCap;
    const int v = y(r, i);
    const int p = __shfl_xor_sync(kFull, v, 16);
    const bool gt = v > p || (v == p && i > ((i + 16) & (kCap - 1)));
    const int z = gt ? p : v;
    sum_all = wadd(sum_all, z);
    if (r == 1) sum_row1 = wadd(sum_row1, z);
    if (m == 0) z0 = z;  // z[0, tid]
  }
  sum_all = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(sum_all)));
  sum_row1 = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(sum_row1)));
  if (lane == 0) {
    red[0][warp] = sum_all;
    red[1][warp] = sum_row1;
  }
  __syncthreads();
  if (tid < 32) {
    const int a = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(red[0][tid])));
    const int b = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(red[1][tid])));
    if (tid == 0) {
      s[0] = a;
      row1 = b;
    }
  }
  __syncthreads();
  if (tid < 128) o[tid] = wadd(wadd(z0, acc0), row1);
}

}  // namespace

// x [8, 2048] int32 → o [128] int32 (the probe's o[3]), s [1] int32
extern "C" int gsjax_probe_mosaic(const int* x, int* o, int* s, void* stream) {
  if (reinterpret_cast<unsigned long long>(x) % 16 != 0)  // the bulk copy's alignment
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kStageBytes;
  static bool smem_set = false;  // once: the call may be captured in a graph
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mosaic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  mosaic_kernel<<<1, kThreadsG, smem, static_cast<cudaStream_t>(stream)>>>(x, o, s);
  return static_cast<int>(cudaGetLastError());
}
