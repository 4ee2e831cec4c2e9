// Kernel A: fat-parent ragged repeat with the per-copy block math.
//
// Replaces the TPU kernel gsjax/render/homesort.py::_repeat_kernel. The
// TPU had no gather it could afford, so it selected each copy slot's
// parent row with a one-hot MXU matmul over a sliding window of a 3-way
// bf16-split table, then ran the block math in lane-major orientation.
// Here each copy slot's thread reads its parent's f32 row (exact, no
// split) and runs _tail_chain's math: block decode → window = block ∩
// rect → home = clipped block centre → exact block ellipse cull against
// the per-parent threshold `thr` (computed by torch, so no device logf can
// flip a borderline cull).
//
// Bound on the card: device memory traffic. The function needs each fat
// parent's row once (72 bytes, with fb, fbe and thr 84) and writes 64
// bytes a copy slot (its 48-byte tail row and 4 key words); its block
// math is ~50 operations a slot. What the design does about it:
//  * a block owns kSlots consecutive copy slots. The parents' copy runs
//    are contiguous and increasing (fb = exclusive cumsum of n_ex), so the
//    parents of a block's slots are one contiguous run: warp 0 finds its
//    first and warp 1 its last by a 32-ary search (each step 32 lanes
//    probe fb and a ballot narrows the range 32-fold: 4-5 steps over a
//    million parents, where a thread's own binary search took ~20
//    dependent loads);
//  * the block stages that run of parents (fb, fbe, thr and the 18-float
//    rows, loaded coalesced; neighbouring slots share a parent, ~3.4
//    copies each at bonsai 1080p) in shared memory, and each thread finds
//    its parent there (≤ 8 steps over shared memory);
//  * slots past the live copy count nc have no parent and skip the search
//    and the parents;
//  * the block's [kSlots, 12] tail tile is staged in shared memory and
//    written as contiguous 16-byte stores (a thread's 48-byte row as 12
//    scalar stores spread each warp store over 1.5 KB); the key rows
//    [4, fat_cap] are written coalesced, a word a thread.
// fb rises strictly over the fat parents (homesort.fat_parent_table
// keeps the parents with n_ex > 0), so a block's slots have at most
// kSlots parents; a table that breaks this traps.
#include "common.cuh"

namespace {

constexpr int kCols = 18;
constexpr int kSlots = 256;  // copy slots a block, one a thread
constexpr int kTail = 12;

// #{i < n : fb[i] ≤ s} for fb ascending, by one warp (every lane returns
// it): each step probes 32 evenly spaced entries of [lo, hi), and the
// ballot's count narrows the range to one gap between probes.
__device__ int count_le_warp(const float* __restrict__ fb, int n, float s, int lane) {
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + step * lane;
    const int k = __popc(__ballot_sync(0xffffffffu, idx < hi && fb[idx] <= s));
    if (k == 0) return lo;
    lo += step * (k - 1) + 1;
    hi = min(hi, lo - 1 + step);
  }
  return lo + __popc(__ballot_sync(0xffffffffu, lo + lane < hi && fb[lo + lane] <= s));
}

// #{i in [lo, hi) : fb[i] ≤ s} + lo, fb ascending, by one thread
__device__ int count_le(const float* __restrict__ fb, int lo, int hi, float s) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (fb[mid] <= s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kSlots)
    repeat_kernel(const float* __restrict__ src18, const float* __restrict__ fb,
                  const float* __restrict__ fbe, const float* __restrict__ thr, int nf,
                  const long long* __restrict__ n_copies, int fat_cap, int tiles_x,
                  int tiles_y, int span, float ts, float* __restrict__ tail,
                  float* __restrict__ keys) {
  __shared__ float s_rows[kSlots * kCols];
  __shared__ float s_fb[kSlots], s_fbe[kSlots], s_thr[kSlots];
  __shared__ __align__(16) float s_tail[kSlots * kTail];
  __shared__ int s_first, s_end;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * kSlots;
  const int j = s0 + tid;
  const float slot = static_cast<float>(j);
  const int nc = static_cast<int>(min(max(*n_copies, 0LL), static_cast<long long>(fat_cap)));
  const int live_end = min(s0 + kSlots, nc);  // slots [s0, live_end) have parents

  // the parents of the block's slots below nc: [first, first + count)
  int first = 0, count = 0;
  if (s0 < live_end) {
    if (warp < 2) {
      const int c = count_le_warp(fb, nf, static_cast<float>(warp == 0 ? s0 : live_end - 1),
                                  lane);
      if (lane == 0) {
        if (warp == 0) s_first = max(c - 1, 0); else s_end = c;
      }
    }
    __syncthreads();
    first = s_first;
    count = s_end - first;
    if (count > kSlots) __trap();  // fb does not rise strictly
    const float* rows = src18 + static_cast<size_t>(first) * kCols;
    for (int e = tid; e < count * kCols; e += kSlots) s_rows[e] = rows[e];
    for (int e = tid; e < count; e += kSlots) {
      s_fb[e] = fb[first + e];
      s_fbe[e] = fbe[first + e];
      s_thr[e] = thr[first + e];
    }
    __syncthreads();
  }

  float a[kCols];  // the parent row; zeros where no parent covers the slot
#pragma unroll
  for (int c = 0; c < kCols; ++c) a[c] = 0.0f;
  float th = 0.0f;
  if (j < live_end) {  // fb[< first] ≤ s0 and fb[≥ first + count] > the last slot
    const int par = count_le(s_fb, 0, count, slot) - 1;
    if (par >= 0 && slot < s_fbe[par]) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) a[c] = s_rows[par * kCols + c];
      th = s_thr[par];
    }
  }

  if (j < fat_cap) {
    const int h = span / 2;
    const int b = static_cast<int>(slot - a[0] + 1.0f);  // block 1..nb-1
    const int gsbx = max(static_cast<int>(a[12]), 1);
    const int bx = b % gsbx;
    const int by = b / gsbx;
    const int cwx0 = static_cast<int>(a[13]) + span * bx;
    const int cwx1 = min(cwx0 + span, static_cast<int>(a[15]));
    const int cwy0 = static_cast<int>(a[14]) + span * by;
    const int cwy1 = min(cwy0 + span, static_cast<int>(a[16]));
    const int chx = min(cwx0 + h, tiles_x - 1);
    const int chy = min(cwy0 + h, tiles_y - 1);

    // _block_qmin: the window's pixel rect [wx0·ts, wx1·ts − 1] × ...
    const float mx = a[1], my = a[2], ca = a[3], cb = a[4], cc = a[5];
    const float dxl = static_cast<float>(cwx0) * ts - mx;
    const float dxr = static_cast<float>(cwx1) * ts - 1.0f - mx;
    const float dyl = static_cast<float>(cwy0) * ts - my;
    const float dyr = static_cast<float>(cwy1) * ts - 1.0f - my;
    const float ncbrcc = -cb / cc;
    const float ncbrca = -cb / ca;
    float qmin = gsjax::box_qmin(ca, cb, cc, ncbrcc, ncbrca, dxl, dxr, dyl, dyr);
    if (gsjax::box_inside(dxl, dxr, dyl, dyr)) qmin = 0.0f;
    const bool ok = j < nc && qmin <= th;

    const size_t n = static_cast<size_t>(fat_cap);
    const float sent = static_cast<float>(tiles_x * tiles_y);
    keys[j] = ok ? static_cast<float>(chy * tiles_x + chx) : sent;
    keys[n + j] = ok ? a[7] : 1.0f;
    const float w0 = gsjax::clip(static_cast<float>(cwx0), 0.0f, 16383.0f);
    const float w1 = gsjax::clip(static_cast<float>(cwx1), 0.0f, 16383.0f);
    const float w2 = gsjax::clip(static_cast<float>(cwy0), 0.0f, 16383.0f);
    const float w3 = gsjax::clip(static_cast<float>(cwy1), 0.0f, 16383.0f);
    keys[2 * n + j] = w0 * 16384.0f + w1;
    keys[3 * n + j] = w2 * 16384.0f + w3;

    // tail row: mean2, depth, conic, radius, rgb, opacity, 0
    float4* t = reinterpret_cast<float4*>(s_tail + tid * kTail);
    t[0] = make_float4(a[1], a[2], a[7], a[3]);
    t[1] = make_float4(a[4], a[5], a[8], a[9]);
    t[2] = make_float4(a[10], a[11], a[6], 0.0f);
  }
  __syncthreads();

  // the block's tail rows [s0, min(s0 + kSlots, fat_cap)), 16 bytes a store
  const int n4 = min(kSlots, fat_cap - s0) * (kTail / 4);
  float4* dst = reinterpret_cast<float4*>(tail + static_cast<size_t>(s0) * kTail);
  const float4* src = reinterpret_cast<const float4*>(s_tail);
  for (int e = tid; e < n4; e += kSlots) dst[e] = src[e];
}

}  // namespace

// n_copies: the live copy count, an i64 on the card (nc = its clip to
// [0, fat_cap]), so the host need not wait for it
extern "C" int gsjax_repeat_fat_parents(const float* src18, const float* fb,
                                        const float* fbe, const float* thr,
                                        int nf, const long long* n_copies, int fat_cap,
                                        int tiles_x, int tiles_y, int span,
                                        int ts, float* tail, float* keys,
                                        void* stream) {
  if (fat_cap > 0) {
    const int blocks = (fat_cap + kSlots - 1) / kSlots;
    repeat_kernel<<<blocks, kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
        src18, fb, fbe, thr, nf, n_copies, fat_cap, tiles_x, tiles_y, span,
        static_cast<float>(ts), tail, keys);
  }
  return static_cast<int>(cudaGetLastError());
}
