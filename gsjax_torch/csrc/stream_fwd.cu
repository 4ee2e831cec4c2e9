// Kernel C: the stream backend's forward tile blend.
//
// Replaces the TPU kernel gsjax/render/pallas_stream.py::_stream_fwd_kernel.
// On the TPU the grid walked chunk slots in order, DMA'd 3-tile-row bands
// of the (home, depth)-ordered attribute table into VMEM and fetched each
// chunk's attributes with one-hot MXU rounds over a bf16 split table; the
// chunk's transmittance came from a Hillis-Steele product down the
// sublanes. Here one block of ts·ts threads owns one tile, one thread one
// pixel, and stages each chunk's attributes straight from the home-ordered
// f32 table [NH, 9] at sid = pid / 9 — exact attributes, absolute means.
// The tile loop (blend.cuh, blend_fwd_kernel) is kernel E's too; only the
// row source differs.
//
// Bound on the card: the per-pixel arithmetic (~45 operations per pair-
// pixel) for dense tiles, and the staging gather (36 bytes per pair, rows
// scattered by sid) for sparse ones.
#include "blend.cuh"

extern "C" int gsjax_stream_forward(const float* att, const int* pid,
                                    const int* starts, int n_tiles, int ty0,
                                    int tiles_x, int ts, int chunk,
                                    int k_slots, float alpha_clamp,
                                    float alpha_min, float eps_T, float* out,
                                    void* stream) {
  return gsjax::launch_blend_forward(gsjax::PairRows{att, pid, k_slots},
                                     starts, n_tiles, ty0, tiles_x, ts, chunk,
                                     alpha_clamp, alpha_min, eps_T, out,
                                     stream);
}
