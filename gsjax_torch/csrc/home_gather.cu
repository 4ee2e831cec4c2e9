// Q and Q': the home gather and its transpose (render/homesort.py::
// home_gather), the differentiable re-layout of the projected splats'
// 12-float rows into (home tile, depth) order.
//
// Replaces no TPU kernel: gsjax's gather and its VJP
// (gsjax/render/homesort.py::_home_gather_bwd) are XLA. Here they take
// the place of a chain of PyTorch launches: the forward's concatenation
// of the splat rows and the copy rows and the row gather from it; the
// backward's padded concatenation, two row gathers, the block-bounded
// cumsum, its concatenation with the block totals, a third gather and
// the where / clamp / subtract passes.
//
// Bound on the card: device memory traffic. Both kernels move 48-byte
// rows by an index; the backward adds each row it reads once.
//  * Q (home_gather_fwd_kernel): out[r] = perm[r] < N ? x[perm[r]] :
//    tail_x[perm[r] - N], a copy, so bit-equal to cat([x, tail_x])[perm].
//    One thread a 16-byte third of an output row: the three threads of a
//    row read its source row's 48 contiguous bytes and write the output
//    coalesced. ~104 bytes a home row (perm 8, the row read and written).
//  * Q' (home_gather_bwd_kernel): dx[i] = d[inv[i]] + the sum of
//    d[inv_tail[j]] over j in [seg_base[i], seg_base[i+1]), an index
//    >= NH (a truncated row) giving zero, seg_base clipped at F. ~112
//    bytes a splat (inv, seg_base, its primary row, its output row) and
//    ~56 a copy row (inv_tail and the row). No float atomics and no
//    cumsum: every sum is taken in a fixed order, so two launches agree
//    bit for bit, and a segment is summed from its own rows alone (the
//    plain version differences two block prefixes, whose rounding grows
//    with the rows before the segment in its block).
// The segments are skewed: most splats have no copy row, a fat one up to
// fat_max_blocks - 1 (1,022). A thread a splat with a serial loop would
// hold its warp for the longest segment. Instead a warp owns 32
// consecutive splats, a lane each; their copy rows are one contiguous
// run of slots [seg_base[i0], seg_base[i0 + 32]) (the segments ascend),
// which the warp walks 32 slots at a time: a lane loads one slot's row,
// a segmented inclusive scan over the lanes (five shuffle steps, the
// segment heads found by one warp-wide OR) sums each segment's part of
// the chunk, and the lane that owns the segment adds that part to its
// accumulator, chunk after chunk in ascending order. A warp's time
// follows its run's length in chunks, not its longest segment, and a
// warp whose splats have no copy row skips the walk.
#include "common.cuh"

namespace {

constexpr int kCols = 12;
constexpr int kParts = kCols / 4;  // 16-byte parts a row
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_up4(float4 v, int off) {
  return make_float4(__shfl_up_sync(kFull, v.x, off), __shfl_up_sync(kFull, v.y, off),
                     __shfl_up_sync(kFull, v.z, off), __shfl_up_sync(kFull, v.w, off));
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

// rows [n + f, kParts] as float4; a perm entry outside it traps
__global__ void __launch_bounds__(kThreads)
    home_gather_fwd_kernel(const float4* __restrict__ x, const float4* __restrict__ tail_x,
                           const long long* __restrict__ perm, long long n, long long f,
                           long long nh, float4* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= nh * kParts) return;
  const long long r = t / kParts;
  const int q = static_cast<int>(t - r * kParts);
  const long long s = perm[r];
  if (s < 0 || s >= n + f) __trap();
  out[t] = s < n ? x[s * kParts + q] : tail_x[(s - n) * kParts + q];
}

// the row d[r] as kParts float4s, zero where r is no row of d (r >= nh)
__device__ __forceinline__ void load_row(const float4* __restrict__ d, long long r,
                                         long long nh, float4 (&v)[kParts]) {
  const bool in = static_cast<unsigned long long>(r) < static_cast<unsigned long long>(nh);
#pragma unroll
  for (int q = 0; q < kParts; ++q) v[q] = in ? d[r * kParts + q] : make_float4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads)
    home_gather_bwd_kernel(const float4* __restrict__ d, const long long* __restrict__ inv,
                           const long long* __restrict__ inv_tail,
                           const long long* __restrict__ seg_base, long long n, long long f,
                           long long nh, float4* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i - lane >= n) return;  // the whole warp: its first splat is past the last
  const bool mine = i < n;
  // my segment [a, b), clipped at f; a lane past the last splat has an
  // empty one at the end of the last splat's
  const long long a = min(seg_base[mine ? i : n], f);
  const long long b = mine ? min(seg_base[i + 1], f) : a;
  const long long run_start = __shfl_sync(kFull, a, 0);
  const long long run_end = __shfl_sync(kFull, b, 31);

  float4 prim[kParts], acc[kParts];
  load_row(d, mine ? inv[i] : nh, nh, prim);
#pragma unroll
  for (int q = 0; q < kParts; ++q) acc[q] = make_float4(0, 0, 0, 0);

  for (long long cs = run_start; cs < run_end; cs += 32) {
    float4 v[kParts];
    load_row(d, cs + lane < run_end ? inv_tail[cs + lane] : nh, nh, v);
    // lane k of the chunk starts a segment where some non-empty segment
    // begins at slot cs + k; lane 0 always (the run that goes on from the
    // chunk before)
    const unsigned bit = (b > a && a >= cs && a < cs + 32) ? 1u << (a - cs) : 0u;
    const unsigned heads = __reduce_or_sync(kFull, bit) | 1u;
    const int head = 31 - __clz(heads & (kFull >> (31 - lane)));  // the last head <= lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const float4 u = shfl_up4(v[q], off);
        if (lane - off >= head) v[q] = add4(u, v[q]);
      }
    }
    // my segment's part of the chunk, [lo, hi), ends at lane hi - 1 - cs
    const long long lo = max(a, cs), hi = min(b, cs + 32);
    const int src = static_cast<int>((hi - 1 - cs) & 31);
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      const float4 w = shfl4(v[q], src);
      if (lo < hi) acc[q] = add4(acc[q], w);
    }
  }
  if (mine) {
#pragma unroll
    for (int q = 0; q < kParts; ++q) dx[i * kParts + q] = add4(prim[q], acc[q]);
  }
}

}  // namespace

// x [n, 12], tail_x [f, 12], perm [nh] i64 -> out [nh, 12]; 16-byte
// aligned float32 rows
extern "C" int gsjax_home_gather_forward(const float* x, const float* tail_x,
                                         const long long* perm, long long n, long long f,
                                         long long nh, float* out, void* stream) {
  if (nh > 0) {
    const long long blocks = (nh * kParts + kThreads - 1) / kThreads;
    home_gather_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(tail_x), perm, n,
        f, nh, reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// d [nh, 12], inv [n], inv_tail [f], seg_base [n + 1] (ascending) i64 ->
// dx [n, 12]
extern "C" int gsjax_home_gather_backward(const float* d, const long long* inv,
                                          const long long* inv_tail,
                                          const long long* seg_base, long long n, long long f,
                                          long long nh, float* dx, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    home_gather_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(d), inv, inv_tail, seg_base, n, f, nh,
        reinterpret_cast<float4*>(dx));
  }
  return static_cast<int>(cudaGetLastError());
}
