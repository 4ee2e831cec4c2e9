// Kernel B: per-(home row, class) pair expansion with the exact
// ellipse-tile cull.
//
// Replaces the TPU kernel gsjax/render/binning.py::_expand_kernel, which
// swept [16, 4096] column blocks and looped over the 9 classes inside one
// grid step. Here one thread owns one (row, class) candidate: thread i
// handles class c = i / NH_pad of row i % NH_pad, so consecutive threads
// read consecutive words of each input column and write consecutive words
// of the class-major outputs tile2d / pid2d [9, NH_pad].
//
// Bound on the card: device memory traffic — 15 column reads (60 bytes,
// shared by the 9 classes of a row through L2) and 8 bytes written per
// candidate, against ~40 flops of cull math. Nothing is staged in shared
// memory; the L2 holds a row's columns between its class sweeps.
//
// The cull quadratic must round exactly as the plain version does, which
// is why the library is built with -fmad=false, and why -b/c and -b/a
// arrive as per-row columns computed by torch (as in the reference).
#include "common.cuh"

namespace {

constexpr int kInvalid = 0x7FFFFFFF;

__global__ void expand_kernel(const float* __restrict__ cols, int nh_pad,
                              int ty0, int band_rows, int tiles_x, float ts,
                              int span, int* __restrict__ tile2d,
                              int* __restrict__ pid2d) {
  const int k_slots = span * span;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(k_slots) * nh_pad) return;
  const int c = static_cast<int>(i / nh_pad);
  const int row = static_cast<int>(i - static_cast<long long>(c) * nh_pad);
  const float* col = cols + row;
  const size_t s = static_cast<size_t>(nh_pad);

  const int hx = static_cast<int>(col[0]);
  const int hy = static_cast<int>(col[s]);
  const int wx0 = static_cast<int>(col[2 * s]);
  const int wx1 = static_cast<int>(col[3 * s]);
  const int wy0 = static_cast<int>(col[4 * s]);
  const int wy1 = static_cast<int>(col[5 * s]);
  const bool okv = col[6 * s] > 0.5f;

  const int h = span / 2;
  const int tx = hx + (c % span - h);
  const int ty = hy + (c / span - h);
  bool ok = okv && tx >= wx0 && tx < wx1 && ty >= wy0 && ty < wy1 &&
            ty >= ty0 && ty < ty0 + band_rows;
  if (ok) {
    const float mx = col[7 * s], my = col[8 * s];
    const float ca = col[9 * s], cb = col[10 * s], cc = col[11 * s];
    const float thr = col[12 * s];
    const float ncbrcc = col[13 * s], ncbrca = col[14 * s];
    const float dxl = static_cast<float>(tx) * ts - mx;
    const float dxr = dxl + (ts - 1.0f);
    const float dyl = static_cast<float>(ty) * ts - my;
    const float dyr = dyl + (ts - 1.0f);
    const float qmin =
        gsjax::box_qmin(ca, cb, cc, ncbrcc, ncbrca, dxl, dxr, dyl, dyr);
    ok = gsjax::box_inside(dxl, dxr, dyl, dyr) || qmin <= thr;
  }
  tile2d[i] = ok ? (ty - ty0) * tiles_x + tx : kInvalid;
  pid2d[i] = row * k_slots + c;
}

}  // namespace

extern "C" int gsjax_expand_pairs(const float* cols, int nh_pad, int ty0,
                                  int band_rows, int tiles_x, int ts,
                                  int span, int* tile2d, int* pid2d,
                                  void* stream) {
  const long long total = static_cast<long long>(span) * span * nh_pad;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    expand_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        cols, nh_pad, ty0, band_rows, tiles_x, static_cast<float>(ts), span,
        tile2d, pid2d);
  }
  return static_cast<int>(cudaGetLastError());
}
