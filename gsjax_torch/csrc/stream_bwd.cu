// Kernel D: the stream backend's backward tile blend (the VJP of kernel C).
//
// Replaces the TPU kernel gsjax/render/pallas_stream.py::_stream_bwd_kernel.
// On the TPU the grid walked chunk slots in reverse order on one core and
// accumulated each home row's gradient read-modify-write into one HBM
// buffer through VMEM band blocks and one-hot MXU scatters; that relies on
// the grid running in order. Here blocks run in parallel and in no order,
// so nothing is accumulated across blocks: one block per tile replays the
// forward's chunks in reverse (blend.cuh, blend_bwd_kernel, kernel F's
// tile loop too) and writes each pair's 9 sums to row pid of dpair
// [NH·K, 9]. Pair ids are unique, so no two blocks write one row: the
// wrapper sums the K class rows of each home row. No float atomics; two
// launches give the same bits.
//
// Bound on the card: fp32 arithmetic, ~85 operations per replayed pair-
// pixel (quadratic, fexp, the transmittance chain, the dα chain and the 9
// products), against 36 bytes of attributes per replayed pair.
#include "blend.cuh"

extern "C" int gsjax_stream_backward(const float* att, const int* pid,
                                     const int* starts, const float* fwd,
                                     const float* ct_img, const float* ct_T,
                                     int n_tiles, int ty0, int tiles_x, int ts,
                                     int chunk, int k_slots, float alpha_clamp,
                                     float alpha_min, float eps_T,
                                     float* dpair, void* stream) {
  return gsjax::launch_blend_backward(gsjax::PairRows{att, pid, k_slots},
                                      starts, fwd, ct_img, ct_T, n_tiles, ty0,
                                      tiles_x, ts, chunk, alpha_clamp,
                                      alpha_min, eps_T, dpair, stream);
}
