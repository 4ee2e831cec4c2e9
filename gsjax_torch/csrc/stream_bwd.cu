// Kernel D: the stream backend's backward tile blend (the VJP of kernel C).
//
// Replaces the TPU kernel gsjax/render/pallas_stream.py::_stream_bwd_kernel.
// On the TPU the grid walked chunk slots in reverse order on one core and
// accumulated each home row's gradient read-modify-write into one HBM
// buffer through VMEM band blocks and one-hot MXU scatters; that relies on
// the grid running in order. Here blocks run in parallel and in no order,
// so nothing is accumulated across blocks: one block per tile replays the
// forward's chunks in the forward's order from C = 1 (blend.cuh,
// blend_bwd_kernel, kernel F's tile loop too), taking each pair's suffix
// sum from the forward's image, writes each pair's 9 sums to row pid of
// dpair [NH·K, 9] and marks the row (replayed[pid] = 1). Pair ids are
// unique, so no two blocks write one row. A second kernel,
// class_sum_kernel, then sums each home row's K class rows in class
// order, reading only the marked ones: dpair is allocated, never zeroed,
// and only the rows of replayed pairs are read back (at 1080p: 1.7M of
// 25M rows). No float atomics; two launches give the same bits.
//
// Bound on the card: fp32 arithmetic, ~39 operations per live pair-pixel
// (the pixel's C ≥ eps before the pair: quadratic, fexp, the transmittance
// chain) and ~46 more per included one (the dα chain, the 9 products and
// their sums), against 36 bytes of attributes per replayed pair. The design
// computes α once per pair-pixel (the reverse replay it replaces did so
// three times), reduces 4 pairs' gradients over a warp's pixels in one
// reduce-scatter (54 shuffles, against 45 a pair), two pixels per thread
// added before it, and stops a warp once its pixels are done.
#include "blend.cuh"

namespace gsjax {

// d_home[h, c] = Σ_{k < K, replayed[h·K + k]} dpair[h·K + k, c], k
// ascending: the home row's gradient from its K class rows, reading only
// the rows the blend kernel wrote (the rest of dpair is never
// initialised). One thread per (home row, column); no atomics.
__global__ void class_sum_kernel(const float* __restrict__ dpair,
                                 const unsigned char* __restrict__ replayed,
                                 int nh, int k_slots,
                                 float* __restrict__ d_home) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(nh) * kAtt) return;
  const size_t h = e / kAtt;
  const size_t c = e - h * kAtt;
  float s = 0.0f;
  for (int k = 0; k < k_slots; ++k) {
    const size_t row = h * k_slots + k;
    if (replayed[row]) s += dpair[row * kAtt + c];
  }
  d_home[e] = s;
}

}  // namespace gsjax

extern "C" int gsjax_stream_backward(const float* att, const int* pid,
                                     const int* starts, const float* fwd,
                                     const float* ct_img, const float* ct_T,
                                     int n_tiles, int ty0, int tiles_x, int ts,
                                     int chunk, int k_slots, float alpha_clamp,
                                     float alpha_min, float eps_T,
                                     float* dpair, unsigned char* replayed,
                                     void* stream) {
  return gsjax::launch_blend_backward(
      gsjax::PairRows{att, pid, k_slots, replayed}, starts, fwd, ct_img, ct_T,
      n_tiles, ty0, tiles_x, ts, chunk, alpha_clamp, alpha_min, eps_T, dpair,
      stream);
}

extern "C" int gsjax_stream_class_sum(const float* dpair,
                                      const unsigned char* replayed, int nh,
                                      int k_slots, float* d_home,
                                      void* stream) {
  const long long n = static_cast<long long>(nh) * gsjax::kAtt;
  if (n > 0) {
    const int threads = 256;
    gsjax::class_sum_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                              threads, 0, static_cast<cudaStream_t>(stream)>>>(
        dpair, replayed, nh, k_slots, d_home);
  }
  return static_cast<int>(cudaGetLastError());
}
