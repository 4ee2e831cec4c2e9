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
// The layout is blend.cuh's: G blocks of 256 threads, one per pixel, the
// chunk's 128 rows staged in shared memory (ids decoded into sid = id // 9
// and crow = (id mod 9) // 3, the probe's integer semantics: floor division
// and modulo, int32 wrap-around). Each variant runs Hopper's form of the
// probe's op, not the TPU's:
//   * roll, swapaxes, decode: index arithmetic and the stage into shared
//     memory (a rotated index, a column staged one id per thread);
//   * onehot3, gatherreal, flatgather, maskwalk: the band loads their
//     one-hot matrices select, with the probe's window arithmetic, masks
//     and (data-dependent) loop counts; acc [128, 32], element (i, c) the
//     band column that pair i's sid selects in the window its class row
//     names. Thread t owns c = t mod 32 and i = t / 32 + 8q, q < 16;
//   * banddyn: the all-ones one-hot selects every lane, so each of the 96
//     (window, column) sums is taken once and added per row;
//   * scatter3: a count of (class, lane) hits accumulated with shared-
//     memory integer atomics into a window zeroed first (the probe reads
//     scratch it never zeroed);
//   * fori0, when_f: a loop that runs zero times and a branch never taken,
//     their bounds data-dependent;
//   * alpha, hs_prod, dots, bwdsums: blend.cuh's per-thread forms — the
//     quadratic, common.cuh::fexp op for op and α for the thread's pixel
//     down the chunk; the transmittance product down the chunk; the rgb
//     accumulate; the six sums over the tile's 256 pixels of each row
//     (warp shuffles, then the 8 warps' partials from shared memory).
// The probe makes loop bounds data-dependent with `x % 1`; nvcc folds
// that to 0, so such bounds pass through probe::opaque (an empty asm
// statement), as do bwdsums' three repeats, which would otherwise merge.
//
// Bound on the card: every variant reads at most 128 KB of L2-resident
// input and writes 8 bytes a block; the pixel variants do 128·256 pair-
// pixels of 3-26 fp32 operations a block, the others a few thousand
// integer operations. At G = 4096 blocks of one chunk each, the launch,
// each block's stage and barriers, and the per-pixel arithmetic of the
// pixel variants set the times — the split of kernels C-F's per-pixel
// work that the variants measure.
#include "common.cuh"
#include "probe.cuh"

namespace {

using namespace gsjax::probe;

constexpr int kChunkJ = 128;
constexpr int kPx = 256;      // threads: one per pixel
constexpr int kLanesJ = 256;  // ints in a row of `rows`
constexpr int kBandW = 512;   // bf16 values in a row of `band`
constexpr int kWinW = 128;
constexpr int kPerThread = kChunkJ * 32 / kPx;  // acc elements per thread

enum Variant {
  kBase, kRoll, kSwapaxes, kDecode, kOnehot3, kScatter3, kAlpha, kHsProd,
  kDots, kBwdsums, kFori0, kWhenF, kBanddyn, kGatherreal, kDynread,
  kFlatgather, kMaskwalk, kNumVariants
};

// bf16 (raw bits) → f32, exact
__device__ __forceinline__ float bf(const unsigned short* band, int idx) {
  return __uint_as_float(static_cast<unsigned>(__ldg(band + idx)) << 16);
}

// jnp.minimum: NaN-propagating (fminf would drop a NaN)
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
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
  for (int w = 1; w < kPx / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;  // in every thread
}

template <int V>
__global__ void __launch_bounds__(kPx)
chunk_kernel(const int* __restrict__ rows, const unsigned short* __restrict__ band,
             float* __restrict__ out) {
  constexpr bool kDecoded = V == kOnehot3 || V == kScatter3 || V == kGatherreal ||
                            V == kFlatgather || V == kMaskwalk;
  __shared__ int r0[kLanesJ];  // rows[0, :]
  __shared__ int sid[kChunkJ], crow[kChunkJ];
  __shared__ float red[32];
  __shared__ int ired[32];
  const int j = blockIdx.x, tid = threadIdx.x;
  float v = 0.0f, cs = 0.0f;  // the value and the checksum, in thread 0

  if constexpr (kDecoded) {
    r0[tid] = __ldg(rows + tid);
    if (tid < kChunkJ) {
      const int id = __ldg(rows + tid);
      const int s = floor_div(id, 9);
      sid[tid] = s;
      crow[tid] = floor_div(wadd(id, wmul(s, -9)), 3);
    }
    __syncthreads();
  }
  // acc [128, 32] of the gather variants: c = tid mod 32, i = tid / 32 + 8q
  const int c = tid & 31;
  auto row_i = [&](int q) { return (tid >> 5) + 8 * q; };

  if constexpr (V == kBase) {
    v = cs = static_cast<float>(j);
  } else if constexpr (V == kRoll) {
    const int sh = floor_mod(__ldg(rows), 64);
    const int raw = __ldg(rows + ((tid + sh) & (kLanesJ - 1)));  // raw[0, tid]
    const int s = block_sum_int(raw, ired);
    v = static_cast<float>(raw);
    cs = static_cast<float>(s);
  } else if constexpr (V == kSwapaxes) {
    if (tid < kChunkJ) sid[tid] = __ldg(rows + tid);  // the column [CHUNK, 1]
    __syncthreads();
    const int s = block_sum_int(tid < kChunkJ ? sid[tid] : 0, ired);
    v = static_cast<float>(sid[0]);
    cs = static_cast<float>(s);
  } else if constexpr (V == kDecode) {
    const int sh = floor_mod(__ldg(rows), 64);
    int both = 0;
    if (tid < kChunkJ) {
      const int raw = __ldg(rows + ((tid + sh) & (kLanesJ - 1)));
      const int s = floor_div(raw, 9);
      const int cls = wadd(raw, wmul(s, -9));
      const int cr = tid < 100 ? floor_div(cls, 3) : -1;
      sid[tid] = s;
      crow[tid] = cr;
      both = wadd(s, cr);
    }
    __syncthreads();
    const int s = block_sum_int(both, ired);
    v = static_cast<float>(wadd(sid[0], crow[5]));
    cs = static_cast<float>(s);
  } else if constexpr (V == kOnehot3) {
    int base[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) base[r] = wmul(floor_div(sid[r], kWinW), kWinW);
    float part = 0.0f;
#pragma unroll 4
    for (int q = 0; q < kPerThread; ++q) {
      const int i = row_i(q);
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        unsigned off;
        if (crow[i] == r && in_window(sid[i], base[r], off))
          acc = acc + bf(band, c * kBandW + r * kWinW + static_cast<int>(off));
      }
      part += acc;
      if (q == 0) v = acc;
    }
    cs = block_sum(part, red);
  } else if constexpr (V == kScatter3) {
    __shared__ int cnt[3 * kWinW];
    for (int e = tid; e < 3 * kWinW; e += kPx) cnt[e] = 0;
    __syncthreads();
    if (tid < kChunkJ) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int b = wmul(floor_div(sid[r], kWinW), kWinW);
        unsigned off;
        if (crow[tid] == r && in_window(sid[tid], b, off))
          atomicAdd(&cnt[r * kWinW + static_cast<int>(off)], 1);
      }
    }
    __syncthreads();
    // scr[0:16, window] = 0 + (u2[0:16] + u2[16:32]), u2's rows all the count
    float part = 0.0f;
    for (int e = tid; e < 16 * 3 * kWinW; e += kPx) {
      const float u = static_cast<float>(cnt[e % (3 * kWinW)]);
      const float w = 0.0f + (u + u);
      part += w;
      if (e == 0) v = w;
    }
    cs = block_sum(part, red);
  } else if constexpr (V == kAlpha) {
    __shared__ float att[4][kChunkJ];
    if (tid < kChunkJ) {
#pragma unroll
      for (int k = 0; k < 4; ++k) att[k][tid] = bf(band, tid * kBandW + k);
    }
    __syncthreads();
    const float px = static_cast<float>(tid);
    float part = 0.0f;
    for (int i = 0; i < kChunkJ; ++i) {
      const float dx = px - att[0][i];
      const float power = -0.5f * (att[1][i] * dx * dx + att[2][i] * dx) - dx;
      const float alpha = jmin(0.99f, att[3][i] * gsjax::fexp(power));
      part += alpha;
      if (i == 0) v = alpha;
    }
    cs = block_sum(part, red);
  } else if constexpr (V == kHsProd) {
    float prod = 1.0f, part = 0.0f;
    for (int i = 0; i < kChunkJ; ++i) {
      const float f = 1.0f - bf(band, i * kBandW + tid) * 1e-6f;
      prod = prod * f;  // Π_{i' ≤ i} f, the transmittance down the chunk
      part += prod;
      if (i == 0) v = prod;
    }
    cs = block_sum(part, red);
  } else if constexpr (V == kDots) {
    __shared__ float rgb[3][kChunkJ];
    if (tid < kChunkJ) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb[k][tid] = bf(band, tid * kBandW + k);
    }
    __syncthreads();
    float i0 = 0.0f, i1 = 0.0f, i2 = 0.0f, wmax = -__int_as_float(0x7f800000);
    for (int i = 0; i < kChunkJ; ++i) {
      const float w = bf(band, i * kBandW + tid);
      i0 = i0 + rgb[0][i] * w;
      i1 = i1 + rgb[1][i] * w;
      i2 = i2 + rgb[2][i] * w;
      wmax = fmaxf(wmax, w);
    }
    const float m = block_max(wmax, red);
    const float s = block_sum(i0 + i1 + i2, red);
    v = i0 + m;
    cs = s + m;
  } else if constexpr (V == kBwdsums) {
    __shared__ float part6[kPx / 32][kChunkJ][6];
    const int lane = tid & 31, warp = tid >> 5;
    for (int i = 0; i < kChunkJ; ++i) {
      const float x = bf(band, i * kBandW + tid);  // dpow
      const float d = x * 0.5f;                    // dx
      const float t1 = x * d, t2 = x * d * d;
#pragma unroll
      for (int rep = 0; rep < 3; ++rep) {
        const float s1 = warp_sum(opaque(t1));
        const float s2 = warp_sum(opaque(t2));
        if (lane == 0) {
          part6[warp][i][2 * rep] = s1;
          part6[warp][i][2 * rep + 1] = s2;
        }
      }
    }
    __syncthreads();
    float acc = 0.0f;
    if (tid < kChunkJ) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float s = 0.0f;
        for (int w = 0; w < kPx / 32; ++w) s += part6[w][tid][k];
        acc += s;
      }
    }
    v = acc;
    cs = block_sum(acc, red);
  } else if constexpr (V == kFori0) {
    const int nr = opaque(floor_mod(__ldg(rows + 1), 1));
    float acc = 0.0f;
#pragma unroll
    for (int rep = 0; rep < 3; ++rep)
      for (int w = 1; w < 1 + nr; ++w) acc = acc + static_cast<float>(w);
    v = cs = acc;
  } else if constexpr (V == kWhenF) {
    const int nr = opaque(floor_mod(__ldg(rows + 1), 1));
#pragma unroll
    for (int rep = 0; rep < 3; ++rep)
      if (nr > 0 && tid < 2) out[2 * j + tid] = 0.0f;  // never runs
    __syncthreads();
    v = cs = static_cast<float>(nr);
  } else if constexpr (V == kBanddyn) {
    __shared__ float colsum[3][32];
    if (tid < 96) {
      const int r = tid >> 5;
      const int start = floor_mod(__ldg(rows + r), 3) * kWinW;
      float s = 0.0f;
      for (int l = 0; l < kWinW; ++l) s = s + bf(band, c * kBandW + start + l);
      colsum[r][c] = s;
    }
    __syncthreads();
    const float acc = ((0.0f + colsum[0][c]) + colsum[1][c]) + colsum[2][c];
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) part += acc;
    v = acc;
    cs = block_sum(part, red);
  } else if constexpr (V == kGatherreal) {
    int lo[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) lo[r] = floor_mod(r0[r], 3) * kWinW;
    const int end = floor_mod(r0[3], 512) + 512;
    const int nr = opaque(floor_mod(r0[4], 1)) + 1;
    float part = 0.0f;
#pragma unroll 4
    for (int q = 0; q < kPerThread; ++q) {
      const int i = row_i(q);
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        for (int w = 0; w < nr; ++w) {
          const int b = lo[r] + w * kWinW;
          const bool ok = b + kWinW <= end;
          const int start = min(max(b, 0), kBandW - kWinW);
          unsigned off;
          if (crow[i] == r && ok && in_window(sid[i], b, off))
            acc = acc + bf(band, c * kBandW + start + static_cast<int>(off));
        }
      }
      part += acc;
      if (q == 0) v = acc;
    }
    cs = block_sum(part, red);
  } else if constexpr (V == kDynread) {
    const int nd = opaque(floor_mod(__ldg(rows + 1), 1)) + 10;
    int acc = 0;
    for (int i = 0; i < nd; ++i) acc = wadd(acc, __ldg(rows + 128 + i));
    v = cs = static_cast<float>(acc);
  } else if constexpr (V == kFlatgather) {
    const int nd = opaque(floor_mod(r0[1], 1)) + 10;
    float acc[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) acc[q] = 0.0f;
    for (int k = 0; k < nd; ++k) {
      const int desc = r0[128 + k];
      const int cls = desc & 15;
      const int lo = wmul(desc >> 4, kWinW);
      const int off0 = floor_mod(lo, 256);
      const bool ok = off0 + kWinW <= kBandW;
      const int start = min(max(off0, 0), kBandW - kWinW);
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int i = row_i(q);
        unsigned off;
        if (crow[i] == cls && ok && in_window(sid[i], lo, off))
          acc[q] = acc[q] + bf(band, c * kBandW + start + static_cast<int>(off));
      }
    }
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) part += acc[q];
    v = acc[0];
    cs = block_sum(part, red);
  } else if constexpr (V == kMaskwalk) {
    int m0 = opaque(floor_mod(r0[1], 1)) | 0x13;
    int m1 = opaque(floor_mod(r0[2], 1)) | 0x0B;
    int m2 = opaque(floor_mod(r0[3], 1)) | 0x26;
    const int lo0 = floor_mod(r0[0], 2) * kWinW, lo1 = floor_mod(r0[1], 2) * kWinW,
              lo2 = floor_mod(r0[2], 2) * kWinW;
    const int nr = opaque(floor_mod(r0[4], 1)) + 9;
    float acc[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) acc[q] = 0.0f;
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
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int i = row_i(q);
        unsigned off;
        if (crow[i] == rc && in_window(sid[i], b, off))
          acc[q] = acc[q] + bf(band, c * kBandW + start + static_cast<int>(off));
      }
      const int ms = m & (m - 1);
      m0 = b0 ? ms : m0;
      m1 = b1 ? ms : m1;
      m2 = (b0 || b1) ? m2 : ms;
    }
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) part += acc[q];
    v = acc[0];
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
    kKernels[variant]<<<g, kPx, 0, static_cast<cudaStream_t>(stream)>>>(rows, band, out);
  return static_cast<int>(cudaGetLastError());
}
