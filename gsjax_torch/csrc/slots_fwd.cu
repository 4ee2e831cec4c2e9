// Kernel E: the flat backend's forward tile blend over the slot stream.
//
// Replaces the TPU kernel gsjax/render/pallas_flat.py::_fwd_kernel (via
// _fwd_call). On the TPU the grid walked slots in order, one [chunk, 9]
// attribute block per grid step, with the tile's compositing state held
// in its output block, which Pallas keeps resident while consecutive
// slots of one tile revisit it; dead slots past cbase[T] carried a
// sentinel tile, and tiles with no slot were forced to (img 0, T 1)
// afterwards. Here one block owns one tile (ts·ts / 2 threads, two pixels
// a thread) and walks its slots cbase[t] .. cbase[t+1]−1 in a loop
// (blend.cuh, blend_fwd_kernel, kernel C's tile loop with its strip cull
// and warp stop): each slot's rows are contiguous in att_al [NCB, chunk,
// 9], so the block stages a chunk as one contiguous run of words, lanes at
// or past the tile's count are masked, and the state stays in registers. A
// tile with no slot runs no chunk and writes (0, 0, 0, 1, 1, 0, 0, 0);
// dead slots are never visited, so the slot tiles (tile_of) the TPU grid
// needed are not read.
//
// Bound on the card: as kernel C, ~39 fp32 operations per eligible live
// pair-pixel and ~6 more per included one for dense tiles; its staging
// loads are contiguous 36-byte rows instead of C's rows scattered by sid.
#include "blend.cuh"

extern "C" int gsjax_slots_forward(const float* att_al, const int* starts,
                                   const int* cbase, int n_tiles, int ty0,
                                   int tiles_x, int ts, int chunk,
                                   float alpha_clamp, float alpha_min,
                                   float eps_T, float* out, void* stream) {
  return gsjax::launch_blend_forward(gsjax::SlotRows{att_al, cbase, chunk},
                                     starts, n_tiles, ty0, tiles_x, ts, chunk,
                                     alpha_clamp, alpha_min, eps_T, out,
                                     stream);
}
