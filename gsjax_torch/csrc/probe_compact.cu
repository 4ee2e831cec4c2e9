// Kernel H: stream compaction of a class-masked pair stream, on Hopper.
//
// Replaces the TPU kernel tools/probe_compact.py::_kernel. Lanes come in
// 128-lane subgroups; within subgroup g, for each class c < classes, the
// lanes whose bit c is set in mask go, in lane order, to stream position
// fill + prefix − 1, where fill counts every (subgroup, class) before
// (g, c): the output order is subgroup, then class, then lane. Each entry
// is the lane's 8 values (a column of vals [8, nh]). The TPU built the
// positions with a roll-based lane prefix, moved the values with a one-
// hot MXU product into a staging ring and flushed the ring by DMA (its
// flush address is a stand-in and the ring is never zeroed, so its output
// is undefined); here the compaction the position arithmetic defines is
// computed in three launches, with no host sync:
//   1. count: each block of 1024 lanes (8 subgroups, 32 warps) sums
//      popcount(mask & class bits) over its lanes → block_tot[b];
//   2. scan: one block scans block_tot → block_off[b] (exclusive) and
//      count[0], the number of entries;
//   3. write: each warp ballots each class bit; a subgroup's class counts
//      are the popcounts of its four warps' ballots; thread 0 lays out the
//      (subgroup, class) offsets of the block in order; a lane's position
//      is block_off + the (subgroup, class) offset + the counts of the
//      warps before it in the subgroup + popc(ballot & lanes below it).
// Stream columns at or past count are not written.
//
// Bound on the card: the bytes — 36 bytes read per lane, 32 written per
// entry (at the probe's mask, 6 of 9 classes alive, ~1.1 GB a call at
// nh = 2.4M and 9 classes); the integer work is a few operations per
// lane and class. Consecutive alive lanes of a warp write consecutive
// columns, so each row's writes coalesce.
#include "probe.cuh"

namespace {

using namespace gsjax::probe;

constexpr int kLanesH = 1024;  // lanes (threads) per block: 8 subgroups
constexpr int kSub = 128;
constexpr int kSubs = kLanesH / kSub;
constexpr int kWarpsH = kLanesH / 32;
constexpr int kValRows = 8;
constexpr int kMaxClasses = 32;

__device__ __forceinline__ unsigned class_bits(int classes) {
  return classes >= 32 ? kFull : (1u << classes) - 1u;
}

__global__ void __launch_bounds__(kLanesH)
count_kernel(const int* __restrict__ mask, int nh, int classes,
             int* __restrict__ block_tot) {
  __shared__ int red[32];
  const int l = blockIdx.x * kLanesH + threadIdx.x;
  const unsigned m = l < nh ? static_cast<unsigned>(__ldg(mask + l)) : 0u;
  const int t = block_sum_int(__popc(m & class_bits(classes)), red);
  if (threadIdx.x == 0) block_tot[blockIdx.x] = t;
}

__global__ void __launch_bounds__(kLanesH)
scan_kernel(const int* __restrict__ block_tot, int nb, int* __restrict__ block_off,
            int* __restrict__ count) {
  __shared__ int wsum[32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int b0 = 0; b0 < nb; b0 += kLanesH) {
    const int x = b0 + tid < nb ? block_tot[b0 + tid] : 0;
    int incl = x;  // inclusive scan within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // scan the warps' totals
      int w = wsum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? wsum[warp - 1] : 0);
    if (b0 + tid < nb) block_off[b0 + tid] = before + incl - x;
    __syncthreads();
    if (tid == 0) carry += wsum[31];
    __syncthreads();
  }
  if (tid == 0) count[0] = carry;
}

__global__ void __launch_bounds__(kLanesH)
write_kernel(const int* __restrict__ mask, const float* __restrict__ vals,
             int nh, int classes, const int* __restrict__ block_off,
             float* __restrict__ out, long long cap) {
  __shared__ unsigned bal[kWarpsH][kMaxClasses];
  __shared__ int off[kSubs][kMaxClasses];  // (subgroup, class) offsets
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sg = warp / 4, ww = warp % 4;  // subgroup, warp within it
  const int l = blockIdx.x * kLanesH + tid;
  const unsigned m = l < nh ? static_cast<unsigned>(__ldg(mask + l)) : 0u;
  for (int c = 0; c < classes; ++c) {
    const unsigned b = __ballot_sync(kFull, (m >> c) & 1u);
    if (lane == 0) bal[warp][c] = b;
  }
  __syncthreads();
  if (tid == 0) {
    int run = block_off[blockIdx.x];
    for (int s = 0; s < kSubs; ++s)
      for (int c = 0; c < classes; ++c) {
        off[s][c] = run;
#pragma unroll
        for (int w = 0; w < 4; ++w) run += __popc(bal[4 * s + w][c]);
      }
  }
  __syncthreads();
  if (l >= nh) return;
  const unsigned below = (1u << lane) - 1u;
  float v[kValRows];
#pragma unroll
  for (int r = 0; r < kValRows; ++r) v[r] = __ldg(vals + static_cast<size_t>(r) * nh + l);
  for (int c = 0; c < classes; ++c) {
    if (!((m >> c) & 1u)) continue;
    int pos = off[sg][c] + __popc(bal[warp][c] & below);
    for (int w = 0; w < ww; ++w) pos += __popc(bal[4 * sg + w][c]);
#pragma unroll
    for (int r = 0; r < kValRows; ++r) out[r * cap + pos] = v[r];
  }
}

}  // namespace

// mask [nh] int32, vals [8, nh] f32 (nh a multiple of 128), 1 ≤ classes
// ≤ 32; block_tot, block_off [ceil(nh / 1024)] int32 scratch → out
// [8, cap] f32 (cap ≥ nh·classes), count [1] int32
extern "C" int gsjax_probe_compact(const int* mask, const float* vals, int nh,
                                   int classes, int* block_tot, int* block_off,
                                   float* out, long long cap, int* count,
                                   void* stream) {
  if (classes < 1 || classes > kMaxClasses || nh % kSub != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (nh + kLanesH - 1) / kLanesH;
  if (nb == 0) {
    return static_cast<int>(cudaMemsetAsync(count, 0, sizeof(int), st));
  }
  count_kernel<<<nb, kLanesH, 0, st>>>(mask, nh, classes, block_tot);
  scan_kernel<<<1, kLanesH, 0, st>>>(block_tot, nb, block_off, count);
  write_kernel<<<nb, kLanesH, 0, st>>>(mask, vals, nh, classes, block_off, out, cap);
  return static_cast<int>(cudaGetLastError());
}
