// Kernel C: the stream backend's forward tile blend.
//
// Replaces the TPU kernel gsjax/render/pallas_stream.py::_stream_fwd_kernel.
// On the TPU the grid walked chunk slots in order, DMA'd 3-tile-row bands
// of the (home, depth)-ordered attribute table into VMEM and fetched each
// chunk's attributes with one-hot MXU rounds over a bf16 split table; the
// chunk's transmittance came from a Hillis-Steele product down the
// sublanes. Here one block of ts·ts / 2 threads owns one tile, two
// pixels a thread, and the block stages each chunk's attributes straight
// from the home-ordered f32 table [NH, 9] at sid = pid / 9 — exact
// attributes, absolute means — 9 consecutive threads on one 36-byte row.
// The tile loop (blend.cuh, blend_fwd_kernel) is kernel E's too; only the
// row source differs.
//
// Bound on the card: the per-pixel arithmetic (~39 fp32 operations for α
// and the transmittance per eligible live pair-pixel, ~6 more per included
// one; -fmad=false, which D's bit-exact replay needs, halves the usable
// rate) for dense tiles, and the staging gather (36 bytes per pair, rows
// scattered by sid) for sparse ones. The TPU kernel evaluated every pair
// at every pixel of the chunks it ran; here each warp owns an 8×8-pixel
// rectangle, skips the pairs whose α_min ellipse misses it (the strip
// cull, decided once per (pair, warp) at staging) and stops once its
// pixels' C < eps. At the bonsai 1080p orbit's view 0 that evaluates 50%
// of the 442M pair-pixels of the chunks run, every one of which a walk of
// every pair at every pixel evaluates; img, T_act and n_done keep that
// walk's bits.
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
