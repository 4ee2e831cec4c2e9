// Kernel I: the per-step cost of a block's index scalars, on Hopper.
//
// Replaces the TPU kernel tools/probe_scalars.py::kernel (made by
// _mk(variant)). The probe runs a G-step grid whose step j gets six
// int32 scalars and sums them (wrapping): `smem` from a scalar-prefetch
// table, stab[6j .. 6j+5]; `vmem` from fixed lanes of the step's row,
// rows[j, 248 .. 253]; `reduce` as three masked min / max pairs over the
// step's first CHUNK = 128 ids (ids ≡ r mod 3, r = 0, 1, 2; the min of an
// empty class is 2^30, the max −1); `base` does nothing but the write.
// On the TPU every step writes o[0, 0] and the last one wins; blocks on
// the card run in no order, so block j writes out[j] and the probe's
// o[0, 0] is out[G − 1].
//
// Hopper's sources for the same scalars: a scalar-prefetch table becomes
// a table in global memory that the block loads itself (`smem`); the
// row's lanes are loads from the block's own row (`vmem`); the masked
// cross-sublane reduce is a warp min / max (redux.sync) over the 128 ids,
// one per thread, then the four warps' results through shared memory
// (`reduce`). All four variants launch G blocks of 128 threads, so their
// times over `base` are each source's cost per block.
//
// Bound on the card: none of the variants moves more than 516 bytes or
// does more than ~2k integer operations per block; at G = 8192 blocks
// the launch and each block's first load set the time.
#include "probe.cuh"

namespace {

using namespace gsjax::probe;

constexpr int kChunkI = 128;  // ids reduced per block, one per thread
enum Variant { kBase = 0, kSmem = 1, kVmem = 2, kReduce = 3 };

template <int V>
__global__ void scalars_kernel(const int* __restrict__ stab,
                               const int* __restrict__ rows, int lanes,
                               int* __restrict__ out) {
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  if constexpr (V == kBase) {
    if (tid == 0) out[j] = 0;
  } else if constexpr (V == kSmem || V == kVmem) {
    if (tid == 0) {
      const int* src = V == kSmem ? stab + static_cast<size_t>(j) * 6
                                  : rows + static_cast<size_t>(j) * lanes + 248;
      int acc = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) acc = wadd(acc, __ldg(src + i));
      out[j] = acc;
    }
  } else {
    __shared__ int part[kChunkI / 32][6];
    const int lane = tid & 31, warp = tid >> 5;
    const int id = __ldg(rows + static_cast<size_t>(j) * lanes + tid);
    const int cls = floor_mod(id, 3);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int mn = __reduce_min_sync(kFull, cls == r ? id : (1 << 30));
      const int mx = __reduce_max_sync(kFull, cls == r ? id : -1);
      if (lane == 0) {
        part[warp][2 * r] = mn;
        part[warp][2 * r + 1] = mx;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        int mn = part[0][2 * r], mx = part[0][2 * r + 1];
        for (int w = 1; w < kChunkI / 32; ++w) {
          mn = min(mn, part[w][2 * r]);
          mx = max(mx, part[w][2 * r + 1]);
        }
        acc = wadd(acc, wadd(mn, mx));
      }
      out[j] = acc;
    }
  }
}

}  // namespace

// variant 0 base, 1 smem, 2 vmem, 3 reduce; stab [g·6] int32, rows
// [g, lanes] int32 (lanes ≥ 254) → out [g] int32
extern "C" int gsjax_probe_scalars(int variant, const int* stab,
                                   const int* rows, int g, int lanes, int* out,
                                   void* stream) {
  if (g <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: scalars_kernel<kBase><<<g, kChunkI, 0, st>>>(stab, rows, lanes, out); break;
    case kSmem: scalars_kernel<kSmem><<<g, kChunkI, 0, st>>>(stab, rows, lanes, out); break;
    case kVmem: scalars_kernel<kVmem><<<g, kChunkI, 0, st>>>(stab, rows, lanes, out); break;
    case kReduce: scalars_kernel<kReduce><<<g, kChunkI, 0, st>>>(stab, rows, lanes, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
