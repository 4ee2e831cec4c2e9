// Kernel C: the stream backend's forward tile blend.
//
// Replaces the TPU kernel gsjax/render/pallas_stream.py::_stream_fwd_kernel.
// On the TPU the grid walked chunk slots in order, DMA'd 3-tile-row bands
// of the (home, depth)-ordered attribute table into VMEM and fetched each
// chunk's attributes with one-hot MXU rounds over a bf16 split table; the
// chunk's transmittance came from a Hillis-Steele product down the
// sublanes. Here one block of ts·ts threads owns one tile, one thread one
// pixel (centre at integer coordinates, as in _pixel_grid). The block
// walks the tile's segment [starts[t], starts[t+1]) of the depth-sorted
// pair stream in chunks of `chunk` pairs:
//   * stage the chunk's attributes in shared memory (SoA [9][chunk] f32),
//     read straight from the home-ordered f32 table [NH, 9] at
//     sid = pid / 9 — exact attributes, absolute means;
//   * every thread runs the chunk in order, the sequential form of the
//     TPU's chunk math: f = 1−α if eligible else 1; a pair is included
//     iff eligible and C·f ≥ eps; then img += C·α·rgb and T_act = C·f;
//     C ← C·f for every eligible pair (C is the virtual transmittance,
//     which makes termination sticky);
//   * at the chunk's end __syncthreads_or(C ≥ eps) decides whether the
//     tile goes on, so the exit is chunk-granular and C / n_done are the
//     exit state the backward kernel replays from.
// Output [T, 8, ts·ts] f32 rows: rgb, T_act, C, n_done, 0, 0. A tile with
// no pairs leaves (0, 0, 0, 1, 1, 0, 0, 0).
//
// Bound on the card: the per-pixel arithmetic (~25 flops and one fexp
// per pair-pixel) for dense tiles, and the staging gather (36 bytes per
// pair, rows scattered by sid) for sparse ones. Threads of a tile read
// the same shared-memory word at once (a broadcast, no bank conflicts);
// the per-tile work is imbalanced across blocks, which the 8k-tile grid
// spreads over the SMs.
#include "common.cuh"

namespace {

constexpr int kAtt = 9;  // mean2d(2), conic(3), rgb(3), opacity(1)
constexpr int kRows = 8;

__global__ void stream_fwd_kernel(const float* __restrict__ att,
                                  const int* __restrict__ pid,
                                  const int* __restrict__ starts, int ty0,
                                  int tiles_x, int ts, int chunk, int k_slots,
                                  float alpha_clamp, float alpha_min,
                                  float eps_T, float* __restrict__ out) {
  extern __shared__ float sh[];  // [kAtt][chunk]
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_px = blockDim.x;
  const int s0 = starts[t];
  const int count = starts[t + 1] - s0;
  const float px = static_cast<float>((t % tiles_x) * ts + tid % ts);
  const float py = static_cast<float>((t / tiles_x + ty0) * ts + tid / ts);

  float C = 1.0f, T_act = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int n_done = 0;
  for (int k = 0; k * chunk < count; ++k) {
    const int base = s0 + k * chunk;
    const int m = min(chunk, count - k * chunk);
    for (int i = tid; i < m; i += n_px) {
      const float* row = att + static_cast<size_t>(pid[base + i] / k_slots) * kAtt;
#pragma unroll
      for (int c = 0; c < kAtt; ++c) sh[c * chunk + i] = row[c];
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float dx = px - sh[i];
      const float dy = py - sh[chunk + i];
      const float ca = sh[2 * chunk + i];
      const float cb = sh[3 * chunk + i];
      const float cc = sh[4 * chunk + i];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      const float alpha =
          fminf(alpha_clamp, sh[8 * chunk + i] * gsjax::fexp(power));
      if (alpha >= alpha_min && power <= 0.0f) {
        const float Cn = C * (1.0f - alpha);
        if (Cn >= eps_T) {
          const float w = C * alpha;
          r += w * sh[5 * chunk + i];
          g += w * sh[6 * chunk + i];
          b += w * sh[7 * chunk + i];
          T_act = Cn;
        }
        C = Cn;
      }
    }
    n_done = k + 1;
    // also the barrier before the next chunk overwrites the stage
    if (!__syncthreads_or(C >= eps_T)) break;
  }
  float* o = out + static_cast<size_t>(t) * kRows * n_px + tid;
  o[0] = r;
  o[n_px] = g;
  o[2 * n_px] = b;
  o[3 * n_px] = T_act;
  o[4 * n_px] = C;
  o[5 * n_px] = static_cast<float>(n_done);
  o[6 * n_px] = 0.0f;
  o[7 * n_px] = 0.0f;
}

}  // namespace

extern "C" int gsjax_stream_forward(const float* att, const int* pid,
                                    const int* starts, int n_tiles, int ty0,
                                    int tiles_x, int ts, int chunk,
                                    int k_slots, float alpha_clamp,
                                    float alpha_min, float eps_T, float* out,
                                    void* stream) {
  if (n_tiles > 0) {
    const size_t smem = sizeof(float) * kAtt * chunk;
    stream_fwd_kernel<<<n_tiles, ts * ts, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        att, pid, starts, ty0, tiles_x, ts, chunk, k_slots, alpha_clamp,
        alpha_min, eps_T, out);
  }
  return static_cast<int>(cudaGetLastError());
}
