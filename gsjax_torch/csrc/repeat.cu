// Kernel A: fat-parent ragged repeat with the per-copy block math.
//
// Replaces the TPU kernel gsjax/render/homesort.py::_repeat_kernel. The
// TPU had no gather it could afford, so it selected each copy slot's
// parent row with a one-hot MXU matmul over a sliding window of a 3-way
// bf16-split table, then ran the block math in lane-major orientation.
// Here one thread owns one copy slot: it finds its parent by binary
// search over the fat-compacted, strictly increasing first-slot column
// `fb` (upper bound − 1, live iff slot < fbe[parent]), loads the parent's
// f32 row directly (exact, no split), and runs _tail_chain's math:
// block decode → window = block ∩ rect → home = clipped block centre →
// exact block ellipse cull against the per-parent threshold `thr`
// (computed by torch, so no device logf can flip a borderline cull).
//
// Bound on the card: device memory traffic. Per slot it reads ~log2(NF)
// fb values (the top levels stay in L1/L2, and neighbouring slots share
// the path) plus one 72-byte parent row that neighbouring slots share,
// and writes 80 bytes. The output writes are coalesced: the tail table
// row-major [fat_cap, 12] (each thread a 48-byte row) and the keys
// class-major [8, fat_cap] (consecutive threads, consecutive words).
#include "common.cuh"

namespace {

constexpr int kCols = 18;

__global__ void repeat_kernel(const float* __restrict__ src18,
                              const float* __restrict__ fb,
                              const float* __restrict__ fbe,
                              const float* __restrict__ thr, int nf, int nc,
                              int fat_cap, int tiles_x, int tiles_y, int span,
                              float ts, float* __restrict__ tail,
                              float* __restrict__ keys) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= fat_cap) return;
  const float slot = static_cast<float>(j);

  int lo = 0, hi = nf;  // first parent whose first slot is > slot
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (fb[mid] <= slot) lo = mid + 1; else hi = mid;
  }
  const int par = lo - 1;
  const bool has = par >= 0 && slot < fbe[par];

  float a[kCols];  // the parent row; zeros where no parent covers the slot
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    a[c] = has ? src18[static_cast<size_t>(par) * kCols + c] : 0.0f;
  const float th = has ? thr[par] : 0.0f;

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
#pragma unroll
  for (int r = 4; r < 8; ++r) keys[r * n + j] = 0.0f;

  // tail row: mean2, depth, conic, radius, rgb, opacity, 0
  float* t = tail + static_cast<size_t>(j) * 12;
  t[0] = a[1]; t[1] = a[2]; t[2] = a[7];
  t[3] = a[3]; t[4] = a[4]; t[5] = a[5];
  t[6] = a[8];
  t[7] = a[9]; t[8] = a[10]; t[9] = a[11];
  t[10] = a[6]; t[11] = 0.0f;
}

}  // namespace

extern "C" int gsjax_repeat_fat_parents(const float* src18, const float* fb,
                                        const float* fbe, const float* thr,
                                        int nf, int nc, int fat_cap,
                                        int tiles_x, int tiles_y, int span,
                                        int ts, float* tail, float* keys,
                                        void* stream) {
  if (fat_cap > 0) {
    const int threads = 256;
    const int blocks = (fat_cap + threads - 1) / threads;
    repeat_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        src18, fb, fbe, thr, nf, nc, fat_cap, tiles_x, tiles_y, span,
        static_cast<float>(ts), tail, keys);
  }
  return static_cast<int>(cudaGetLastError());
}
