// Kernel J: the per-op cost of one blend chunk, on Hopper.
//
// Replaces the TPU kernel tools/probe_chunk.py::kernel (made by
// _mk(variant)). The probe runs each sub-op of a stream-kernel chunk
// alone in a G-step grid on the blend's shapes — a chunk of CHUNK = 128
// pair rows against N_PX = 256 pixels — and reads the op's cost as its
// time over `base`. Inputs: rows [8, 256] int32 (the chunk's ids in row
// 0), band [128, 512] bf16 (attribute / band values). Each variant
// computes the value the probe writes (the value column of out) and, so
// that nvcc keeps every element of its work, a checksum of those elements
// (the second column): out [G, 2] f32, one row per block, every row the
// same but `base`'s (row j holds j).
//
// Every variant, `base` too, runs one block shape: G blocks of 128
// threads, two pixels a thread, as kernels C-F run a tile
// (blend.cuh's kFwdPixels, kBwdPixels), so a variant's time over `base`
// is its op's own cost. Ids are decoded with the probe's integer
// semantics (floor division and modulo, int32 wrap-around). Each variant
// runs the op the way kernels C-F do it on this card, not the TPU's
// one-hot and MXU form:
//   * roll, swapaxes, decode: index arithmetic and a stage into shared
//     memory (a rotated index, two lanes a thread; a column staged one id
//     per thread);
//   * alpha, hs_prod, dots (the forward's per-pixel work): two pixels a
//     thread, pixels 2t and 2t+1, so one 32-bit load brings a row's two
//     bf16 values and a staged attribute row (one float4) serves both —
//     the quadratic, common.cuh::fexp op for op and α; the transmittance
//     product down the chunk; the rgb accumulate;
//   * bwdsums (the backward's six sums over the tile's 256 pixels of each
//     row): each thread adds its two pixels, then a warp sums kBwdRows
//     rows' six values over its 64 pixels in one reduce-scatter
//     (probe.cuh::warp_reduce_scatter, the scheme of blend.cuh:416): 36
//     shuffles per 4 rows where one 5-shuffle warp_sum per value took
//     120; then the 4 warps' partials are added from shared memory in
//     warp order. The three repeats pass through probe::opaque, so they
//     stay six reductions;
//   * banddyn (the all-ones one-hot selects every lane, so acc is the 96
//     (window, column) sums, each added to every row): each of the 96
//     runs of 128 bf16 is one warp load of 8 bytes a lane along the run
//     (one sector per 16 values), summed in the lane and then over the
//     warp by one reduce-scatter of a warp's 24 runs;
//   * onehot3, gatherreal, flatgather, maskwalk: the band loads their
//     one-hot matrices select, with the probe's window arithmetic, masks
//     and (data-dependent) loop counts; acc [128, 32], element (i, c) the
//     band column that pair i's sid selects in the window its class row
//     names, each element's adds in the probe's order. Lanes over pair
//     rows, band read in place: thread t owns row t (elements e = (t,
//     c = e)), tests it once a round and makes its 32 loads or none, so
//     a warp load of band row c falls in that row's 256-byte windows. On
//     the H100 this beats a staged, transposed window (lanes over
//     columns, each element a shared load and a test) for all four
//     gathers: 1-2.5 ns a block over base against 16-26, the copy and the
//     per-element tests costing more than the in-place loads' sectors
//     (chunk_variants' layout-* edits build the staged form);
//   * scatter3: a count of (class, lane) hits accumulated with shared-
//     memory integer atomics into a window zeroed first (the probe reads
//     scratch it never zeroed);
//   * fori0, when_f, dynread: a loop that runs zero times, a branch never
//     taken, ten scalar reads; their bounds data-dependent.
// The probe makes loop bounds data-dependent with `x % 1`; nvcc folds
// that to 0, so such bounds pass through probe::opaque (an empty asm
// statement), as do bwdsums' three repeats, which would otherwise merge.
//
// Bound on the card: every variant reads at most 128 KB of L2-resident
// input and writes 8 bytes a block; the pixel variants do 128·256 pair-
// pixels of 3-26 fp32 operations a block, the others a few thousand
// integer operations. At G = 4096 blocks of one chunk each, the launch,
// each block's stage and barriers, and the per-pixel arithmetic of the
// pixel variants set the times: alpha's fexp without FMA contraction
// (-fmad=false) issues about twice its counted operations, and the
// reduce-scatter's shuffles and selects set bwdsums'
// (gsjax_torch/tools/chunk_variants.py times the layouts and groupings).
#include "common.cuh"
#include "probe.cuh"

namespace {

using namespace gsjax::probe;

constexpr int kChunkJ = 128;              // pair rows of the chunk
constexpr int kPx = 256;                  // pixels of the chunk
constexpr int kPixels = 2;                // pixels a thread
constexpr int kThreads = kPx / kPixels;   // 128: every variant's block
constexpr int kWarps = kThreads / 32;
constexpr int kLanesJ = 256;  // ints in a row of `rows`
constexpr int kBandW = 512;   // bf16 values in a row of `band`
constexpr int kWinW = 128;
constexpr int kCols = 32;  // the band rows a gather reads: acc's columns
constexpr int kPerThread = kChunkJ * kCols / kThreads;  // acc elements a thread
// bwdsums: rows summed by one reduce-scatter (a power of two, at most 32).
// 4, the pairs kernel D's reduce-scatter sums at once, so the probe
// prices D's scheme; on the H100 8 and 16 rows take ~20% less, 2 and 1
// (one warp_sum per value) 1.4x and 2.6x more (chunk_variants)
constexpr int kBwdRows = 4;

enum Variant {
  kBase, kRoll, kSwapaxes, kDecode, kOnehot3, kScatter3, kAlpha, kHsProd,
  kDots, kBwdsums, kFori0, kWhenF, kBanddyn, kGatherreal, kDynread,
  kFlatgather, kMaskwalk, kNumVariants
};

// bf16 (raw bits) → f32, exact
__device__ __forceinline__ float bf(const unsigned short* band, int idx) {
  return __uint_as_float(static_cast<unsigned>(__ldg(band + idx)) << 16);
}
// the two bf16 of a 32-bit word: the lower address first
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// jnp.minimum: NaN-propagating (fminf would drop a NaN); one instruction
__device__ __forceinline__ float jmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// whether s lies in the 128-lane window from b, with int32 wrap-around
// (the probe's `sid == b + lane` for some lane < 128); off = s − b
__device__ __forceinline__ bool in_window(int s, int b, unsigned& off) {
  off = static_cast<unsigned>(s) - static_cast<unsigned>(b);
  return off < static_cast<unsigned>(kWinW);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;  // in every thread
}

// One round of a gather: for the thread's pair row i = tid, if hit(i,
// off) selects it (off its offset in the round's window), acc[c] +=
// band[c, start + off] for its 32 columns c: one test, then 32 loads or
// none.
template <class Hit>
__device__ __forceinline__ void gather_round(float (&acc)[kPerThread],
                                             const unsigned short* __restrict__ band, int start,
                                             Hit hit) {
  unsigned off;
  if (hit(static_cast<int>(threadIdx.x), off)) {
    const unsigned short* p = band + start + static_cast<int>(off);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) acc[e] = acc[e] + bf(p, e * kBandW);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const int* __restrict__ rows, const unsigned short* __restrict__ band,
             float* __restrict__ out) {
  constexpr bool kGather = V == kOnehot3 || V == kGatherreal || V == kFlatgather ||
                           V == kMaskwalk;
  constexpr bool kDecoded = kGather || V == kScatter3;
  __shared__ int r0[kLanesJ];  // rows[0, :]
  __shared__ int sid[kChunkJ], crow[kChunkJ];
  __shared__ float red[32];
  __shared__ int ired[32];
  const int j = blockIdx.x, tid = threadIdx.x;
  float v = 0.0f, cs = 0.0f;  // the value and the checksum, in thread 0

  if constexpr (kDecoded) {
    r0[tid] = __ldg(rows + tid);
    r0[tid + kThreads] = __ldg(rows + tid + kThreads);
    const int id = __ldg(rows + tid);  // pair tid of the chunk
    const int s = floor_div(id, 9);
    sid[tid] = s;
    crow[tid] = floor_div(wadd(id, wmul(s, -9)), 3);
    __syncthreads();
  }
  float acc[kGather ? kPerThread : 1];  // the gathers' elements
#pragma unroll
  for (int e = 0; e < (kGather ? kPerThread : 1); ++e) acc[e] = 0.0f;

  if constexpr (V == kBase) {
    v = cs = static_cast<float>(j);
  } else if constexpr (V == kRoll) {
    const int sh = floor_mod(__ldg(rows), 64);
    const int a = __ldg(rows + ((tid + sh) & (kLanesJ - 1)));             // raw[0, tid]
    const int b = __ldg(rows + ((tid + kThreads + sh) & (kLanesJ - 1)));  // raw[0, tid + 128]
    const int s = block_sum_int(wadd(a, b), ired);
    v = static_cast<float>(a);
    cs = static_cast<float>(s);
  } else if constexpr (V == kSwapaxes) {
    sid[tid] = __ldg(rows + tid);  // the column [CHUNK, 1]
    __syncthreads();
    const int s = block_sum_int(sid[tid], ired);
    v = static_cast<float>(sid[0]);
    cs = static_cast<float>(s);
  } else if constexpr (V == kDecode) {
    const int sh = floor_mod(__ldg(rows), 64);
    const int raw = __ldg(rows + ((tid + sh) & (kLanesJ - 1)));
    const int s = floor_div(raw, 9);
    const int cls = wadd(raw, wmul(s, -9));
    const int cr = tid < 100 ? floor_div(cls, 3) : -1;
    sid[tid] = s;
    crow[tid] = cr;
    __syncthreads();
    const int sum = block_sum_int(wadd(s, cr), ired);
    v = static_cast<float>(wadd(sid[0], crow[5]));
    cs = static_cast<float>(sum);
  } else if constexpr (V == kOnehot3) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int base = wmul(floor_div(sid[r], kWinW), kWinW);
      gather_round(acc, band, r * kWinW, [&](int i, unsigned& off) {
        return crow[i] == r && in_window(sid[i], base, off);
      });
    }
  } else if constexpr (V == kScatter3) {
    __shared__ int cnt[3 * kWinW];
    for (int e = tid; e < 3 * kWinW; e += kThreads) cnt[e] = 0;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int b = wmul(floor_div(sid[r], kWinW), kWinW);
      unsigned off;
      if (crow[tid] == r && in_window(sid[tid], b, off))
        atomicAdd(&cnt[r * kWinW + static_cast<int>(off)], 1);
    }
    __syncthreads();
    // scr[0:16, window] = 0 + (u2[0:16] + u2[16:32]), u2's rows all the count
    float part = 0.0f;
    for (int e = tid; e < 16 * 3 * kWinW; e += kThreads) {
      const float u = static_cast<float>(cnt[e % (3 * kWinW)]);
      const float w = 0.0f + (u + u);
      part += w;
      if (e == 0) v = w;
    }
    cs = block_sum(part, red);
  } else if constexpr (V == kAlpha) {
    __shared__ float4 att[kChunkJ];  // (mean, x² coefficient, x coefficient, opacity)
    att[tid] = make_float4(bf(band, tid * kBandW), bf(band, tid * kBandW + 1),
                           bf(band, tid * kBandW + 2), bf(band, tid * kBandW + 3));
    __syncthreads();
    const float px0 = static_cast<float>(kPixels * tid), px1 = px0 + 1.0f;
    float part0 = 0.0f, part1 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < kChunkJ; ++i) {
      const float4 a = att[i];
      const float dx0 = px0 - a.x, dx1 = px1 - a.x;
      const float power0 = -0.5f * (a.y * dx0 * dx0 + a.z * dx0) - dx0;
      const float power1 = -0.5f * (a.y * dx1 * dx1 + a.z * dx1) - dx1;
      const float alpha0 = jmin(0.99f, a.w * gsjax::fexp(power0));
      const float alpha1 = jmin(0.99f, a.w * gsjax::fexp(power1));
      part0 += alpha0;
      part1 += alpha1;
      if (i == 0) v = alpha0;
    }
    cs = block_sum(part0 + part1, red);
  } else if constexpr (V == kHsProd) {
    // pixels 2·tid, 2·tid + 1 of row i: one 32-bit word
    const unsigned* px = reinterpret_cast<const unsigned*>(band) + tid;
    float prod0 = 1.0f, prod1 = 1.0f, part0 = 0.0f, part1 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < kChunkJ; ++i) {
      const unsigned w = __ldg(px + i * (kBandW / 2));
      prod0 = prod0 * (1.0f - bf_lo(w) * 1e-6f);  // Π_{i' ≤ i} f, down the chunk
      prod1 = prod1 * (1.0f - bf_hi(w) * 1e-6f);
      part0 += prod0;
      part1 += prod1;
      if (i == 0) v = prod0;
    }
    cs = block_sum(part0 + part1, red);
  } else if constexpr (V == kDots) {
    __shared__ float4 rgb[kChunkJ];
    rgb[tid] = make_float4(bf(band, tid * kBandW), bf(band, tid * kBandW + 1),
                           bf(band, tid * kBandW + 2), 0.0f);
    __syncthreads();
    const unsigned* px = reinterpret_cast<const unsigned*>(band) + tid;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    float wmax = -__int_as_float(0x7f800000);
#pragma unroll 4
    for (int i = 0; i < kChunkJ; ++i) {
      const unsigned w = __ldg(px + i * (kBandW / 2));
      const float wa = bf_lo(w), wb = bf_hi(w);
      const float4 c = rgb[i];
      a0 = a0 + c.x * wa;
      a1 = a1 + c.y * wa;
      a2 = a2 + c.z * wa;
      b0 = b0 + c.x * wb;
      b1 = b1 + c.y * wb;
      b2 = b2 + c.z * wb;
      wmax = fmaxf(wmax, fmaxf(wa, wb));
    }
    const float m = block_max(wmax, red);
    const float s = block_sum((a0 + a1 + a2) + (b0 + b1 + b2), red);
    v = a0 + m;
    cs = s + m;
  } else if constexpr (V == kBwdsums) {
    constexpr int P = kBwdRows, kGroup = 32 / P;
    __shared__ float part6[kWarps][kChunkJ][6];
    const int lane = tid & 31, warp = tid >> 5;
    const unsigned* px = reinterpret_cast<const unsigned*>(band) + tid;
    for (int i0 = 0; i0 < kChunkJ; i0 += P) {
      float s[P * 6];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const unsigned w = __ldg(px + (i0 + q) * (kBandW / 2));
        const float x0 = bf_lo(w), x1 = bf_hi(w);  // dpow at the thread's pixels
        const float d0 = x0 * 0.5f, d1 = x1 * 0.5f;  // dx
        const float t10 = x0 * d0, t11 = x1 * d1;
        const float t20 = x0 * d0 * d0, t21 = x1 * d1 * d1;
#pragma unroll
        for (int rep = 0; rep < 3; ++rep) {
          s[q * 6 + 2 * rep] = opaque(t10) + opaque(t11);
          s[q * 6 + 2 * rep + 1] = opaque(t20) + opaque(t21);
        }
      }
      warp_reduce_scatter<P, 6>(s, lane);
      if ((lane & (kGroup - 1)) == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) part6[warp][i0 + lane / kGroup][k] = s[k];
      }
    }
    __syncthreads();
    float a = 0.0f;  // row tid's six sums
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float t = 0.0f;
      for (int w = 0; w < kWarps; ++w) t += part6[w][tid][k];
      a += t;
    }
    v = a;
    cs = block_sum(a, red);
  } else if constexpr (V == kFori0) {
    const int nr = opaque(floor_mod(__ldg(rows + 1), 1));
    float a = 0.0f;
#pragma unroll
    for (int rep = 0; rep < 3; ++rep)
      for (int w = 1; w < 1 + nr; ++w) a = a + static_cast<float>(w);
    v = cs = a;
  } else if constexpr (V == kWhenF) {
    const int nr = opaque(floor_mod(__ldg(rows + 1), 1));
#pragma unroll
    for (int rep = 0; rep < 3; ++rep)
      if (nr > 0 && tid < 2) out[2 * j + tid] = 0.0f;  // never runs
    __syncthreads();
    v = cs = static_cast<float>(nr);
  } else if constexpr (V == kBanddyn) {
    // run n = warp + 4k (k < 24) is band[c, start_r : start_r + 128], r =
    // n / 32, c = n mod 32: one 8-byte load a lane covers it
    constexpr int kRuns = 3 * kCols / kWarps;
    __shared__ float colsum[3][kCols];
    const int lane = tid & 31, warp = tid >> 5;
    const int st0 = floor_mod(__ldg(rows), 3) * kWinW, st1 = floor_mod(__ldg(rows + 1), 3) * kWinW,
              st2 = floor_mod(__ldg(rows + 2), 3) * kWinW;
    float s[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      s[k] = 0.0f;
      if (k < kRuns) {
        const int n = warp + kWarps * k, r = n >> 5, c = n & 31;
        const int start = r == 0 ? st0 : (r == 1 ? st1 : st2);
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(band + c * kBandW + start) + lane);
        s[k] = ((bf_lo(w.x) + bf_hi(w.x)) + bf_lo(w.y)) + bf_hi(w.y);
      }
    }
    warp_reduce_scatter<32, 1>(s, lane);  // lane l: run warp + 4l's sum
    if (lane < kRuns) {
      const int n = warp + kWarps * lane;
      colsum[n >> 5][n & 31] = s[0];
    }
    __syncthreads();
    const int c = tid & 31;
    const float a = ((0.0f + colsum[0][c]) + colsum[1][c]) + colsum[2][c];
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) part += a;  // (i, c) for the thread's 32 rows i
    v = a;
    cs = block_sum(part, red);
  } else if constexpr (V == kGatherreal) {
    const int end = floor_mod(r0[3], 512) + 512;
    const int nr = opaque(floor_mod(r0[4], 1)) + 1;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int lo = floor_mod(r0[r], 3) * kWinW;
      for (int w = 0; w < nr; ++w) {
        const int b = lo + w * kWinW;
        const bool ok = b + kWinW <= end;
        const int start = min(max(b, 0), kBandW - kWinW);
        gather_round(acc, band, start, [&](int i, unsigned& off) {
          return crow[i] == r && ok && in_window(sid[i], b, off);
        });
      }
    }
  } else if constexpr (V == kDynread) {
    const int nd = opaque(floor_mod(__ldg(rows + 1), 1)) + 10;
    int a = 0;
    for (int i = 0; i < nd; ++i) a = wadd(a, __ldg(rows + 128 + i));
    v = cs = static_cast<float>(a);
  } else if constexpr (V == kFlatgather) {
    const int nd = opaque(floor_mod(r0[1], 1)) + 10;
    for (int k = 0; k < nd; ++k) {
      const int desc = r0[128 + k];
      const int cls = desc & 15;
      const int lo = wmul(desc >> 4, kWinW);
      const int off0 = floor_mod(lo, 256);
      const bool ok = off0 + kWinW <= kBandW;
      const int start = min(max(off0, 0), kBandW - kWinW);
      gather_round(acc, band, start, [&](int i, unsigned& off) {
        return crow[i] == cls && ok && in_window(sid[i], lo, off);
      });
    }
  } else if constexpr (V == kMaskwalk) {
    int m0 = opaque(floor_mod(r0[1], 1)) | 0x13;
    int m1 = opaque(floor_mod(r0[2], 1)) | 0x0B;
    int m2 = opaque(floor_mod(r0[3], 1)) | 0x26;
    const int lo0 = floor_mod(r0[0], 2) * kWinW, lo1 = floor_mod(r0[1], 2) * kWinW,
              lo2 = floor_mod(r0[2], 2) * kWinW;
    const int nr = opaque(floor_mod(r0[4], 1)) + 9;
    for (int it = 0; it < nr; ++it) {
      const bool b0 = m0 != 0;
      const bool b1 = !b0 && m1 != 0;
      const int m = b0 ? m0 : (b1 ? m1 : m2);
      const int lo = b0 ? lo0 : (b1 ? lo1 : lo2);
      const int rc = b0 ? 0 : (b1 ? 1 : 2);
      const int low = m & -m;
      const int pos = low == 0 ? 31 : __ffs(low) - 1;  // the probe's ctz
      const int b = lo + pos * kWinW;
      const int start = floor_mod(b, 256);
      gather_round(acc, band, start, [&](int i, unsigned& off) {
        return crow[i] == rc && in_window(sid[i], b, off);
      });
      const int ms = m & (m - 1);
      m0 = b0 ? ms : m0;
      m1 = b1 ? ms : m1;
      m2 = (b0 || b1) ? m2 : ms;
    }
  }
  if constexpr (kGather) {
    float part = 0.0f;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) part += acc[e];
    v = acc[0];  // thread 0's element 0: (0, 0)
    cs = block_sum(part, red);
  }
  if (tid == 0) {
    out[2 * j] = v;
    out[2 * j + 1] = cs;
  }
}

using ChunkFn = void (*)(const int*, const unsigned short*, float*);
const ChunkFn kKernels[kNumVariants] = {
    chunk_kernel<kBase>,     chunk_kernel<kRoll>,       chunk_kernel<kSwapaxes>,
    chunk_kernel<kDecode>,   chunk_kernel<kOnehot3>,    chunk_kernel<kScatter3>,
    chunk_kernel<kAlpha>,    chunk_kernel<kHsProd>,     chunk_kernel<kDots>,
    chunk_kernel<kBwdsums>,  chunk_kernel<kFori0>,      chunk_kernel<kWhenF>,
    chunk_kernel<kBanddyn>,  chunk_kernel<kGatherreal>, chunk_kernel<kDynread>,
    chunk_kernel<kFlatgather>, chunk_kernel<kMaskwalk>,
};

}  // namespace

// variant: the index into VARIANTS (gsjax_torch/tools/probe_chunk.py);
// rows [8, 256] int32, band [128, 512] bf16 (raw bits) → out [g, 2] f32
extern "C" int gsjax_probe_chunk(int variant, const int* rows,
                                 const unsigned short* band, int g, float* out,
                                 void* stream) {
  if (variant < 0 || variant >= kNumVariants) return static_cast<int>(cudaErrorInvalidValue);
  if (g > 0)
    kKernels[variant]<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(rows, band, out);
  return static_cast<int>(cudaGetLastError());
}
