// Kernel B: pair expansion with the exact ellipse-tile cull, compacted in
// pid order.
//
// Replaces the TPU kernel gsjax/render/binning.py::_expand_kernel, which
// swept [16, 4096] blocks of a stacked column table, looped over the 9
// classes inside one grid step and wrote a dense class-major [9, NH_pad]
// table of tile ids for XLA to compact.
//
// Bound on the card: device memory traffic. The function needs each home
// row's fields once (~53 bytes: home tile, window, liveness, mean, conic,
// cull threshold, depth bits) and writes 12 bytes a live pair (its pid
// and its i64 sort key); the ~60 operations of window tests and cull math
// a candidate are far below the byte time. What the design does about it:
//  * one thread a home row, its K = span² classes in registers, so
//    neighbouring threads read neighbouring rows and every input is read
//    once (a thread per (row, class), class-major, swept the whole input
//    once per class: at bonsai 1080p its 180 MB stacked table was far
//    larger than the 50 MB L2, so it came from device memory 9 times);
//  * the home rows' own tensors are read in place, with no stacked table,
//    all of a row's fields at once (one round trip to memory), and -b/c,
//    -b/a are divided here once a row (IEEE division rounds as torch's
//    does); the cull threshold (a log) comes from torch;
//  * the window and the band keep a range of class columns times a range
//    of class rows, so a row's candidate mask is a few shifts, and the
//    span is a template constant (odd, 1 to 15), so a class's offsets
//    cost no division: the kernel issued more instructions than it moved
//    bytes with a per-class test and a runtime span;
//  * only the live candidates are written, in ascending pid = row·K + c,
//    which is what the stable sort needs for its tie order: each thread's
//    K-bit live mask (in ⌈K/32⌉ words), a block scan of the counts, and
//    the block's base offset from a single-pass decoupled look-back over
//    the counts the blocks publish (blocks take their row ranges from a
//    ticket counter in the order they start, so a block waits only on
//    blocks that run).
//    The offsets depend on the data only: two launches are bit-equal;
//  * the block's pids and keys are staged in shared memory in pid order
//    and written as 16-byte stores on 16-byte boundaries: 256 rows a
//    block up to span 7, fewer above, so that a block's rows · K · 12
//    bytes stay within the shared memory of one SM.
// The live count goes to a device word that the wrapper reads once.
//
// The cull quadratic must round exactly as the plain version does, which
// is why the library is built with -fmad=false.
#include "common.cuh"

namespace {

// a block's status word: flag above the count (0: nothing yet)
constexpr unsigned long long kAggregate = 1ull << 32;  // the block's own count
constexpr unsigned long long kInclusive = 2ull << 32;  // the count of blocks ≤ it

struct HomeRows {  // the home rows' fields, read in place
  const int* home_x;
  const int* home_y;
  const int* win;  // [NH, 4]: wx0, wx1, wy0, wy1
  const unsigned char* valid;
  const float* mean2d;  // row stride mean_stride, x then y
  long long mean_stride;
  const float* conic;  // row stride conic_stride, a b c
  long long conic_stride;
  const float* thr;
  const int* dbits;  // row stride dbits_stride: the depths' f32 bits
  long long dbits_stride;
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The sum of the counts of blocks 0..b-1 (warp 0, every lane): lane i
// waits on block end − i's status, and the window's aggregates up to the
// nearest inclusive prefix are summed; without one, the window moves 32
// blocks back.
__device__ unsigned exclusive_prefix(const unsigned long long* status, int b, int lane) {
  unsigned prefix = 0;
  for (int end = b - 1;; end -= 32) {
    const int idx = end - lane;
    unsigned long long s = kInclusive;  // before block 0: an inclusive 0
    if (idx >= 0) {
      do {
        s = load_status(status + idx);
      } while (s < kAggregate);
    }
    const unsigned inclusive = __ballot_sync(0xffffffffu, s >= kInclusive);
    const int last = inclusive ? __ffs(inclusive) - 1 : 31;
    unsigned v = lane <= last ? static_cast<unsigned>(s) : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    prefix += v;
    if (inclusive) return prefix;
  }
}

// kSpan: the tile span (odd), a constant so that a class's offsets
// (c % span, c / span) cost a multiply, not a division; kRows: home rows
// a block, one a thread. Bit c % 32 of mask[c / 32]: class c of the row
// is a live pair.
template <int kSpan, int kRows>
__global__ void __launch_bounds__(kRows)
    expand_kernel(HomeRows r, int nh, int ty0, int band_rows, int tiles_x, float ts,
                  unsigned long long* __restrict__ status,
                  unsigned* __restrict__ ticket_count, int* __restrict__ pid_out,
                  long long* __restrict__ key_out) {
  constexpr int k_slots = kSpan * kSpan;
  constexpr int kWords = (k_slots + 31) / 32;
  constexpr int kWarps = kRows / 32;
  constexpr int h = kSpan / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_key = reinterpret_cast<long long*>(smem);  // [kRows · K]
  int* s_pid = reinterpret_cast<int*>(s_key + kRows * k_slots);
  __shared__ int s_block;
  __shared__ unsigned s_warp[kWarps], s_total, s_base;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_block = static_cast<int>(atomicAdd(ticket_count, 1u));
  __syncthreads();
  const int b = s_block;
  const int row = b * kRows + tid;

  unsigned mask[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) mask[w] = 0u;
  int hx = 0, hy = 0;
  long long dk = 0;  // the key's low word: depth bits + 2^31
  if (row < nh) {
    // every field at once, so the row costs one round trip to memory (a
    // dead row's fields too: its live neighbours share their sectors)
    const bool live = r.valid[row] != 0;
    hx = r.home_x[row];
    hy = r.home_y[row];
    const int* wn = r.win + 4 * static_cast<size_t>(row);
    const int wx0 = wn[0], wx1 = wn[1], wy0 = wn[2], wy1 = wn[3];
    const float* m = r.mean2d + static_cast<size_t>(row) * r.mean_stride;
    const float* q = r.conic + static_cast<size_t>(row) * r.conic_stride;
    const float mx = m[0], my = m[1];
    const float ca = q[0], cb = q[1], cc = q[2];
    const float thr = r.thr[row];
    dk = static_cast<long long>(r.dbits[static_cast<size_t>(row) * r.dbits_stride]) +
         2147483648LL;
    // class c = cy·span + cx is the tile (hx + cx − h, hy + cy − h): the
    // window and the band keep a range of cx times a range of cy
    const int cx0 = max(wx0 - hx + h, 0), cx1 = min(wx1 - hx + h, kSpan);
    const int cy0 = max(max(wy0, ty0) - hy + h, 0);
    const int cy1 = min(min(wy1, ty0 + band_rows) - hy + h, kSpan);
    bool any = false;
    if (live && cx0 < cx1) {
      const unsigned cols = ((1u << cx1) - 1u) & ~((1u << cx0) - 1u);
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        for (int cy = cy0; cy < cy1; ++cy) {
          const int o = cy * kSpan - 32 * w;  // class row cy's first bit in word w
          if (o > -kSpan && o < 32) mask[w] |= o >= 0 ? cols << o : cols >> -o;
        }
        any |= mask[w] != 0u;
      }
    }
    if (any) {
      const float ncbrcc = -cb / cc, ncbrca = -cb / ca;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        for (unsigned mm = mask[w]; mm; mm &= mm - 1) {
          const int c = 32 * w + __ffs(mm) - 1;
          const int tx = hx + (c % kSpan - h);
          const int ty = hy + (c / kSpan - h);
          const float dxl = static_cast<float>(tx) * ts - mx;
          const float dxr = dxl + (ts - 1.0f);
          const float dyl = static_cast<float>(ty) * ts - my;
          const float dyr = dyl + (ts - 1.0f);
          const float qmin =
              gsjax::box_qmin(ca, cb, cc, ncbrcc, ncbrca, dxl, dxr, dyl, dyr);
          if (!(gsjax::box_inside(dxl, dxr, dyl, dyr) || qmin <= thr)) {
            mask[w] &= ~(1u << (c - 32 * w));
          }
        }
      }
    }
  }

  // the block's exclusive scan of the counts, in row order
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) cnt += __popc(mask[w]);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned own = lane < kWarps ? s_warp[lane] : 0u;
    unsigned wi = own;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < kWarps) s_warp[lane] = wi - own;
    const unsigned total = __shfl_sync(0xffffffffu, wi, kWarps - 1);
    if (lane == 0) {
      s_total = total;
      atomicExch(status + b, (b == 0 ? kInclusive : kAggregate) | total);
    }
  }
  __syncthreads();

  // stage the block's live pairs in pid order
  if (cnt) {
    unsigned pos = s_warp[warp] + static_cast<unsigned>(incl - cnt);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      for (unsigned mm = mask[w]; mm; mm &= mm - 1, ++pos) {
        const int c = 32 * w + __ffs(mm) - 1;
        const int tx = hx + (c % kSpan - h);
        const int ty = hy + (c / kSpan - h);
        s_pid[pos] = row * k_slots + c;
        s_key[pos] = (static_cast<long long>((ty - ty0) * tiles_x + tx) << 32) | dk;
      }
    }
  }

  // the block's base offset
  if (warp == 0) {
    unsigned base = 0;
    if (b > 0) {
      base = exclusive_prefix(status, b, lane);
      if (lane == 0) atomicExch(status + b, kInclusive | (base + s_total));
    }
    if (lane == 0) {
      s_base = base;
      if (b == static_cast<int>(gridDim.x) - 1) ticket_count[1] = base + s_total;
    }
  }
  __syncthreads();

  // [base, base + total): 16-byte stores on 16-byte boundaries, the
  // partial groups at both ends element by element
  const unsigned base = s_base, end = base + s_total;
  for (unsigned g = (base & ~3u) + 4u * tid; g < end; g += 4u * kRows) {
    if (g >= base && g + 4u <= end) {
      const unsigned i = g - base;
      *reinterpret_cast<int4*>(pid_out + g) =
          make_int4(s_pid[i], s_pid[i + 1], s_pid[i + 2], s_pid[i + 3]);
    } else {
      for (unsigned e = max(g, base); e < min(g + 4u, end); ++e) pid_out[e] = s_pid[e - base];
    }
  }
  for (unsigned g = (base & ~1u) + 2u * tid; g < end; g += 2u * kRows) {
    if (g >= base && g + 2u <= end) {
      const unsigned i = g - base;
      longlong2 v;
      v.x = s_key[i];
      v.y = s_key[i + 1];
      *reinterpret_cast<longlong2*>(key_out + g) = v;
    } else {
      for (unsigned e = max(g, base); e < min(g + 2u, end); ++e) key_out[e] = s_key[e - base];
    }
  }
}

// scratch: (blocks + 1) 8-byte words, zeroed here: the blocks' status
// words, then the ticket counter and the live count (u32 each)
template <int kSpan, int kRows>
cudaError_t launch(const HomeRows& r, int nh, int ty0, int band_rows, int tiles_x, int ts,
                   void* scratch, int* pid_live, long long* key, cudaStream_t st) {
  constexpr int smem = kRows * kSpan * kSpan * static_cast<int>(sizeof(long long) + sizeof(int));
  static_assert(kRows % 32 == 0 && kRows <= 1024, "whole warps, one block");
  static_assert(smem <= 227 * 1024, "a block's staged pairs exceed an SM's shared memory");
  const int blocks = (nh + kRows - 1) / kRows;
  auto* status = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (static_cast<size_t>(blocks) + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess || blocks == 0) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(expand_kernel<kSpan, kRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  expand_kernel<kSpan, kRows><<<blocks, kRows, smem, st>>>(
      r, nh, ty0, band_rows, tiles_x, static_cast<float>(ts), status,
      reinterpret_cast<unsigned*>(status + blocks), pid_live, key);
  return cudaGetLastError();
}

}  // namespace

// scratch: (blocks + 1) 8-byte words, blocks = ⌈nh / rows⌉ with the
// span's rows a block below (binning.EXPAND_ROWS): the blocks' status
// words, then the ticket counter and the live count (u32 each). span:
// odd, 1 to 15.
extern "C" int gsjax_expand_live_pairs(
    const int* home_x, const int* home_y, const int* win, const unsigned char* valid,
    const float* mean2d, long long mean_stride, const float* conic, long long conic_stride,
    const float* thr, const int* dbits, long long dbits_stride, int nh, int ty0, int band_rows,
    int tiles_x, int ts, int span, void* scratch, int* pid_live, long long* key, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HomeRows r{home_x, home_y, win,          valid, mean2d,
                   mean_stride, conic, conic_stride, thr, dbits, dbits_stride};
  cudaError_t err;
#define GSJAX_EXPAND(S, R) \
  case S: err = launch<S, R>(r, nh, ty0, band_rows, tiles_x, ts, scratch, pid_live, key, st); break
  switch (span) {
    GSJAX_EXPAND(1, 256);
    GSJAX_EXPAND(3, 256);
    GSJAX_EXPAND(5, 256);
    GSJAX_EXPAND(7, 256);
    GSJAX_EXPAND(9, 128);
    GSJAX_EXPAND(11, 128);
    GSJAX_EXPAND(13, 64);
    GSJAX_EXPAND(15, 64);
    default: err = cudaErrorInvalidValue;
  }
#undef GSJAX_EXPAND
  return static_cast<int>(err);
}
