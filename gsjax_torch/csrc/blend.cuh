// The tile blend's device code, shared by kernels C, D (stream backend)
// and E, F (flat backend).
//
// Both backends blend the same pairs in the same order: tile t's segment
// of the depth-sorted pair stream, count = starts[t+1] − starts[t] pairs,
// walked in chunks of `chunk`. They differ only in where pair j of tile t
// keeps its 9 attributes (mean2d, conic, rgb, opacity) and where its
// gradient goes, which a row source describes:
//   * PairRows (C, D): position q = starts[t] + j of the stream holds pair
//     id pid[q]; its attributes are home row pid / K of the f32 table
//     [NH, K]; its gradient goes to row pid of the per-pair buffer;
//   * SlotRows (E, F): the flat backend gathered the pairs into chunk-
//     aligned slots [NCB, chunk, 9] (tile t's slots start at cbase[t]), so
//     pair j is row cbase[t]·chunk + j, contiguous, and its gradient goes
//     to the same row of the slot gradient [NCB, chunk, 9].
// The per-pair math is one copy, so the two backends give the same bits.
//
// Forward (blend_fwd_kernel): one block of ts·ts threads owns one tile,
// one thread one pixel (centre at integer coordinates, as in the
// reference's _pixel_grid). The block walks the tile's chunks:
//   * stage the chunk's attributes in shared memory (SoA [9][chunk] f32);
//   * every thread runs the chunk in order, the sequential form of the
//     TPU's chunk math: f = 1−α if eligible else 1; a pair is included
//     iff eligible and C·f ≥ eps; then img += C·α·rgb and T_act = C·f;
//     C ← C·f for every eligible pair (C is the virtual transmittance,
//     which makes termination sticky);
//   * at the chunk's end __syncthreads_or(C ≥ eps) decides whether the
//     tile goes on, so the exit is chunk-granular and C / n_done are the
//     exit state the backward replays from.
// Output [T, 8, ts·ts] f32 rows: rgb, T_act, C, n_done, 0, 0. A tile with
// no pairs leaves (0, 0, 0, 1, 1, 0, 0, 0).
//
// Backward (blend_bwd_kernel): one block per tile, one thread per pixel,
// replays the chunks the forward ran in reverse, from k = n_done − 1 down
// to 0, starting from the forward's exit state (C_exit = out[t, 4],
// n_done = out[t, 5]) and S = 0:
//   * stage the chunk's attributes and gradient rows in shared memory;
//   * pass 1 recomputes α, eligible and f = 1 − α down the chunk and
//     rebuilds C_entry = C_exit / max(Π f, 1e-30);
//   * pass 2 sums v·w over the chunk (v = rgb·ct_img, w = include·T·α,
//     include = eligible ∧ C_entry·Π_{j≤i} f_j ≥ eps): the suffix sums;
//   * pass 3 forms, per pair, U = S + (Σ_chunk v·w − Σ_{j≤i} v·w),
//     dα = include·(v·T − (U + ct_T·T_act)/f), dpow = dα·α and
//     d_op = dα·G where α is unclamped, and the 9 attribute gradients
//     (mean2d, conic through dx/dy; rgb = w·ct_img; opacity); a warp sums
//     them over its 32 pixels with shuffles (skipped when no lane
//     includes the pair) and the 8 warps' partials are added in warp
//     order from shared memory;
//   * the pair's 9 sums go to its gradient row. A row belongs to one pair
//     of one tile, so no two blocks write one row: no float atomics, and
//     two launches give the same bits. Rows of pairs never replayed keep
//     the zeros the wrapper allocated;
//   * the state becomes (C_entry, S + Σ_chunk v·w).
// α, eligible and include come from the same expressions, in the same
// operand order, as the forward's (the library builds with -fmad=false),
// so the replay makes the forward's decisions; near T ≈ eps the rebuilt
// include set may still differ by one splat per pixel, as in the
// reference (gsjax/render/pallas_flat.py, module docstring).
//
// Bound on the card: the per-pixel arithmetic (~45 fp32 operations per
// pair-pixel forward, ~85 backward) for dense tiles, the staging loads
// (36 bytes per pair) for sparse ones. Threads of a tile read the same
// shared-memory word at once (a broadcast, no bank conflicts); the per-
// tile work is imbalanced across blocks, which the 8k-tile grid spreads
// over the SMs. The backward's three passes recompute the quadratic and
// fexp (3x the essential fexp work) instead of holding a chunk of per-
// pixel values, and each included pair costs a warp 45 shuffles; both
// are the price of keeping every per-pixel quantity in registers.
#pragma once

#include "common.cuh"

namespace gsjax {

constexpr int kAtt = 9;  // mean2d(2), conic(3), rgb(3), opacity(1)
constexpr int kRows = 8;

// Stream backend: pair ids into the home-ordered table [NH, 9].
struct PairRows {
  const float* att;
  const int* pid;
  int k_slots;
  // the first row key of tile t, whose segment starts at s0
  __device__ int begin(int /*t*/, int s0) const { return s0; }
  // the gradient row of the pair at position q
  __device__ int key(int q) const { return __ldg(pid + q); }
  __device__ const float* row(int key) const {
    return att + static_cast<size_t>(key / k_slots) * kAtt;
  }
};

// Flat backend: the chunk-aligned slot stream [NCB, chunk, 9].
struct SlotRows {
  const float* att_al;
  const int* cbase;
  int chunk;
  __device__ int begin(int t, int /*s0*/) const { return __ldg(cbase + t) * chunk; }
  __device__ int key(int q) const { return q; }
  __device__ const float* row(int key) const {
    return att_al + static_cast<size_t>(key) * kAtt;
  }
};

// stage the chunk's m rows from row key r0 in shared memory (SoA)
template <class Rows>
__device__ __forceinline__ void stage_chunk(const Rows& rows, int r0, int m,
                                            int chunk, float* sh, int* keys) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int q = rows.key(r0 + i);
    if (keys != nullptr) keys[i] = q;
    const float* row = rows.row(q);
#pragma unroll
    for (int c = 0; c < kAtt; ++c) sh[c * chunk + i] = __ldg(row + c);
  }
}

template <class Rows>
__global__ void blend_fwd_kernel(Rows rows, const int* __restrict__ starts,
                                 int ty0, int tiles_x, int ts, int chunk,
                                 float alpha_clamp, float alpha_min,
                                 float eps_T, float* __restrict__ out) {
  extern __shared__ float sh[];  // [kAtt][chunk]
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_px = blockDim.x;
  const int s0 = starts[t];
  const int count = starts[t + 1] - s0;
  const int r0 = rows.begin(t, s0);
  const float px = static_cast<float>((t % tiles_x) * ts + tid % ts);
  const float py = static_cast<float>((t / tiles_x + ty0) * ts + tid / ts);

  float C = 1.0f, T_act = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int n_done = 0;
  for (int k = 0; k * chunk < count; ++k) {
    const int m = min(chunk, count - k * chunk);
    stage_chunk(rows, r0 + k * chunk, m, chunk, sh, static_cast<int*>(nullptr));
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float dx = px - sh[i];
      const float dy = py - sh[chunk + i];
      const float ca = sh[2 * chunk + i];
      const float cb = sh[3 * chunk + i];
      const float cc = sh[4 * chunk + i];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      const float alpha = fminf(alpha_clamp, sh[8 * chunk + i] * fexp(power));
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

template <class Rows>
int launch_blend_forward(Rows rows, const int* starts, int n_tiles, int ty0,
                         int tiles_x, int ts, int chunk, float alpha_clamp,
                         float alpha_min, float eps_T, float* out,
                         void* stream) {
  if (n_tiles > 0) {
    const size_t smem = sizeof(float) * kAtt * chunk;
    blend_fwd_kernel<Rows><<<n_tiles, ts * ts, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        rows, starts, ty0, tiles_x, ts, chunk, alpha_clamp, alpha_min, eps_T,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

struct PairTerms {
  float dx, dy, G, raw, alpha;
  bool eligible;
};

// the forward's per pair-pixel quantities, in its operand order
__device__ __forceinline__ PairTerms pair_terms(const float* sh, int chunk,
                                                int i, float px, float py,
                                                float alpha_clamp,
                                                float alpha_min) {
  PairTerms q;
  q.dx = px - sh[i];
  q.dy = py - sh[chunk + i];
  const float ca = sh[2 * chunk + i];
  const float cb = sh[3 * chunk + i];
  const float cc = sh[4 * chunk + i];
  const float power =
      -0.5f * (ca * q.dx * q.dx + cc * q.dy * q.dy) - cb * q.dx * q.dy;
  q.G = fexp(power);
  q.raw = sh[8 * chunk + i] * q.G;
  q.alpha = fminf(alpha_clamp, q.raw);
  q.eligible = q.alpha >= alpha_min && power <= 0.0f;
  return q;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the warp's sum
}

template <class Rows>
__global__ void blend_bwd_kernel(Rows rows, const int* __restrict__ starts,
                                 const float* __restrict__ fwd,
                                 const float* __restrict__ ct_img,
                                 const float* __restrict__ ct_T, int ty0,
                                 int tiles_x, int ts, int chunk,
                                 float alpha_clamp, float alpha_min,
                                 float eps_T, float* __restrict__ dout) {
  extern __shared__ float sh[];  // [kAtt][chunk] attributes
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_px = blockDim.x;
  const int n_warps = n_px / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* red = sh + kAtt * chunk;  // [n_warps][chunk][kAtt] warp partials
  int* skey = reinterpret_cast<int*>(red + n_warps * chunk * kAtt);  // [chunk]

  const float* o = fwd + static_cast<size_t>(t) * kRows * n_px;
  const int n_done = static_cast<int>(o[5 * n_px]);  // one value per tile
  if (n_done == 0) return;
  const int s0 = starts[t];
  const int count = starts[t + 1] - s0;
  const int r0 = rows.begin(t, s0);
  const float px = static_cast<float>((t % tiles_x) * ts + tid % ts);
  const float py = static_cast<float>((t / tiles_x + ty0) * ts + tid / ts);
  const size_t p = static_cast<size_t>(t) * n_px + tid;
  const float cr = ct_img[3 * p], cg = ct_img[3 * p + 1], cbl = ct_img[3 * p + 2];
  const float ctTT = ct_T[p] * o[3 * n_px + tid];  // ct_T · T_act
  float C = o[4 * n_px + tid];  // transmittance at the exit of chunk k
  float S = 0.0f;               // Σ v·w over the chunks after k

  for (int k = n_done - 1; k >= 0; --k) {
    const int m = min(chunk, count - k * chunk);
    stage_chunk(rows, r0 + k * chunk, m, chunk, sh, skey);
    __syncthreads();

    // pass 1: the chunk's transmittance product → C at its entry
    float prod = 1.0f;
    for (int i = 0; i < m; ++i) {
      const PairTerms q = pair_terms(sh, chunk, i, px, py, alpha_clamp, alpha_min);
      if (q.eligible) prod = prod * (1.0f - q.alpha);
    }
    const float C_entry = C / fmaxf(prod, 1e-30f);

    // pass 2: Σ v·w over the chunk
    float tot = 0.0f, ex = 1.0f;
    for (int i = 0; i < m; ++i) {
      const PairTerms q = pair_terms(sh, chunk, i, px, py, alpha_clamp, alpha_min);
      const float f = q.eligible ? 1.0f - q.alpha : 1.0f;
      const float inc = ex * f;
      if (q.eligible && C_entry * inc >= eps_T) {
        const float w = C_entry * ex * q.alpha;
        const float v = cr * sh[5 * chunk + i] + cg * sh[6 * chunk + i] +
                        cbl * sh[7 * chunk + i];
        tot = tot + v * w;
      }
      ex = inc;
    }

    // pass 3: the per-pair gradients, summed over the tile's pixels
    float pre = 0.0f;
    ex = 1.0f;
    for (int i = 0; i < m; ++i) {
      const PairTerms q = pair_terms(sh, chunk, i, px, py, alpha_clamp, alpha_min);
      const float f = q.eligible ? 1.0f - q.alpha : 1.0f;
      const float inc = ex * f;
      const bool include = q.eligible && C_entry * inc >= eps_T;
      float g[kAtt];
#pragma unroll
      for (int c = 0; c < kAtt; ++c) g[c] = 0.0f;
      if (include) {
        const float T_i = C_entry * ex;
        const float w = T_i * q.alpha;
        const float v = cr * sh[5 * chunk + i] + cg * sh[6 * chunk + i] +
                        cbl * sh[7 * chunk + i];
        pre = pre + v * w;
        const float U = S + (tot - pre);
        const float dalpha = v * T_i - (U + ctTT) / f;
        if (q.raw < alpha_clamp) {
          const float ca = sh[2 * chunk + i];
          const float cb = sh[3 * chunk + i];
          const float cc = sh[4 * chunk + i];
          const float dpow = dalpha * q.alpha;
          g[0] = dpow * (ca * q.dx + cb * q.dy);
          g[1] = dpow * (cb * q.dx + cc * q.dy);
          g[2] = dpow * (-0.5f * q.dx * q.dx);
          g[3] = dpow * (-q.dx * q.dy);
          g[4] = dpow * (-0.5f * q.dy * q.dy);
          g[8] = dalpha * q.G;
        }
        g[5] = w * cr;
        g[6] = w * cg;
        g[7] = w * cbl;
      }
      ex = inc;
      float* r = red + (warp * chunk + i) * kAtt;
      if (__any_sync(0xffffffffu, include)) {
#pragma unroll
        for (int c = 0; c < kAtt; ++c) {
          const float s = warp_sum(g[c]);
          if (lane == 0) r[c] = s;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kAtt; ++c) r[c] = 0.0f;
      }
    }
    __syncthreads();
    for (int e = tid; e < m * kAtt; e += n_px) {
      const int i = e / kAtt;
      const int c = e - i * kAtt;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += red[(w * chunk + i) * kAtt + c];
      dout[static_cast<size_t>(skey[i]) * kAtt + c] = s;
    }
    C = C_entry;
    S = S + tot;
    // the next chunk's staging overwrites sh, red and skey
    __syncthreads();
  }
}

template <class Rows>
int launch_blend_backward(Rows rows, const int* starts, const float* fwd,
                          const float* ct_img, const float* ct_T, int n_tiles,
                          int ty0, int tiles_x, int ts, int chunk,
                          float alpha_clamp, float alpha_min, float eps_T,
                          float* dout, void* stream) {
  if (n_tiles > 0) {
    const int n_px = ts * ts;
    const size_t smem =
        sizeof(float) * (kAtt * chunk + (n_px / 32) * chunk * kAtt + chunk);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          blend_bwd_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    blend_bwd_kernel<Rows><<<n_tiles, n_px, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        rows, starts, fwd, ct_img, ct_T, ty0, tiles_x, ts, chunk, alpha_clamp,
        alpha_min, eps_T, dout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsjax
