// Kernel F: the flat backend's backward tile blend (the VJP of kernel E).
//
// Replaces the TPU kernel gsjax/render/pallas_flat.py::_bwd_kernel (via
// _bwd_call). On the TPU the grid walked the slots in reverse order and
// carried each tile's replay state (C at the exit, Σ v·w of the later
// slots) from one grid step to the next in a resident output block,
// which relies on the grid running in order. Here one block per tile
// replays its slots 0 .. n_done − 1 in a loop in the forward's order
// (blend.cuh, blend_bwd_kernel, kernel D's tile loop) from C = 1, with
// E's image (rows 0-2) for the suffix sums and n_done (row 5) for the
// slot count, and writes slot row [slot, lane, 0:9] of datt [NCB, chunk,
// 9]. A slot belongs to one tile, so no two blocks write one row: no
// atomics, and two launches give the same bits. Slots at or past n_done,
// padded lanes and the dead slots past cbase[T] keep the zeros the
// wrapper allocated. The reduction to home rows is gather_pair_attrs's
// VJP, outside.
//
// Bound on the card: as kernel D, fp32 arithmetic, ~39 operations per
// live pair-pixel (the pixel's C ≥ eps before the pair) and ~46 more per
// included one, with one α per pair-pixel, 4 pairs reduced over a warp's
// pixels at a time and a warp that stops once its pixels are done (see
// blend.cuh, which says where the time goes); its rows are contiguous
// and its output is per slot, so it needs no per-pair buffer.
#include "blend.cuh"

extern "C" int gsjax_slots_backward(const float* att_al, const int* starts,
                                    const int* cbase, const float* fwd,
                                    const float* ct_img, const float* ct_T,
                                    int n_tiles, int ty0, int tiles_x, int ts,
                                    int chunk, float alpha_clamp,
                                    float alpha_min, float eps_T, float* datt,
                                    void* stream) {
  return gsjax::launch_blend_backward(gsjax::SlotRows{att_al, cbase, chunk},
                                      starts, fwd, ct_img, ct_T, n_tiles, ty0,
                                      tiles_x, ts, chunk, alpha_clamp,
                                      alpha_min, eps_T, datt, stream);
}
