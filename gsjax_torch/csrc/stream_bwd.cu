// Kernel D: the stream backend's backward tile blend (the VJP of kernel C).
//
// Replaces the TPU kernel gsjax/render/pallas_stream.py::_stream_bwd_kernel.
// On the TPU the grid walked chunk slots in reverse order on one core and
// accumulated each home row's gradient read-modify-write into one HBM
// buffer through VMEM band blocks and one-hot MXU scatters; that relies on
// the grid running in order. Here blocks run in parallel and in no order,
// so nothing is accumulated across blocks. One block of ts·ts threads owns
// one tile, one thread one pixel, and replays the chunks the forward ran
// in reverse, from k = n_done − 1 down to 0, starting from the exit state
// kernel C wrote (C_exit = out[t, 4], n_done = out[t, 5]) and S = 0:
//   * stage the chunk's attributes (SoA [9][chunk] f32) and pair ids in
//     shared memory, read straight from the home-ordered table [NH, 9];
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
//   * the pair's 9 sums go to row pid of dpair [NH·K, 9]. Pair ids are
//     unique, so no two blocks write one row: the wrapper sums the K
//     class rows of each home row. No float atomics; two launches give
//     the same bits.
//   * the state becomes (C_entry, S + Σ_chunk v·w).
// α, eligible and include come from the same expressions, in the same
// operand order, as kernel C's (the library builds with -fmad=false), so
// the replay makes the forward's decisions; near T ≈ eps the rebuilt
// include set may still differ by one splat per pixel, as in the
// reference (gsjax/render/pallas_flat.py, module docstring).
//
// Bound on the card: fp32 arithmetic, ~85 operations per replayed
// pair-pixel (quadratic, fexp, the transmittance chain, the dα chain and
// the 9 products), against 36 bytes of attributes per replayed pair. The
// three passes recompute the quadratic and fexp (3x the essential fexp
// work) instead of holding a chunk of per-pixel values, and each included
// pair costs a warp 45 shuffles; both are the price of keeping every
// per-pixel quantity in registers.
#include "common.cuh"

namespace {

constexpr int kAtt = 9;  // mean2d(2), conic(3), rgb(3), opacity(1)
constexpr int kRows = 8;

struct PairTerms {
  float dx, dy, G, raw, alpha;
  bool eligible;
};

// kernel C's per pair-pixel quantities, in its operand order
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
  q.G = gsjax::fexp(power);
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

__global__ void stream_bwd_kernel(const float* __restrict__ att,
                                  const int* __restrict__ pid,
                                  const int* __restrict__ starts,
                                  const float* __restrict__ fwd,
                                  const float* __restrict__ ct_img,
                                  const float* __restrict__ ct_T, int ty0,
                                  int tiles_x, int ts, int chunk, int k_slots,
                                  float alpha_clamp, float alpha_min,
                                  float eps_T, float* __restrict__ dpair) {
  extern __shared__ float sh[];  // [kAtt][chunk] attributes
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_px = blockDim.x;
  const int n_warps = n_px / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* red = sh + kAtt * chunk;  // [n_warps][chunk][kAtt] warp partials
  int* spid = reinterpret_cast<int*>(red + n_warps * chunk * kAtt);  // [chunk]

  const float* o = fwd + static_cast<size_t>(t) * kRows * n_px;
  const int n_done = static_cast<int>(o[5 * n_px]);  // one value per tile
  if (n_done == 0) return;
  const int s0 = starts[t];
  const int count = starts[t + 1] - s0;
  const float px = static_cast<float>((t % tiles_x) * ts + tid % ts);
  const float py = static_cast<float>((t / tiles_x + ty0) * ts + tid / ts);
  const size_t p = static_cast<size_t>(t) * n_px + tid;
  const float cr = ct_img[3 * p], cg = ct_img[3 * p + 1], cbl = ct_img[3 * p + 2];
  const float ctTT = ct_T[p] * o[3 * n_px + tid];  // ct_T · T_act
  float C = o[4 * n_px + tid];  // transmittance at the exit of chunk k
  float S = 0.0f;               // Σ v·w over the chunks after k

  for (int k = n_done - 1; k >= 0; --k) {
    const int base = s0 + k * chunk;
    const int m = min(chunk, count - k * chunk);
    for (int i = tid; i < m; i += n_px) {
      const int q = pid[base + i];
      spid[i] = q;
      const float* row = att + static_cast<size_t>(q / k_slots) * kAtt;
#pragma unroll
      for (int c = 0; c < kAtt; ++c) sh[c * chunk + i] = row[c];
    }
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
      dpair[static_cast<size_t>(spid[i]) * kAtt + c] = s;
    }
    C = C_entry;
    S = S + tot;
    // the next chunk's staging overwrites sh, red and spid
    __syncthreads();
  }
}

}  // namespace

extern "C" int gsjax_stream_backward(const float* att, const int* pid,
                                     const int* starts, const float* fwd,
                                     const float* ct_img, const float* ct_T,
                                     int n_tiles, int ty0, int tiles_x, int ts,
                                     int chunk, int k_slots, float alpha_clamp,
                                     float alpha_min, float eps_T,
                                     float* dpair, void* stream) {
  if (n_tiles > 0) {
    const int n_px = ts * ts;
    const size_t smem =
        sizeof(float) * (kAtt * chunk + (n_px / 32) * chunk * kAtt + chunk);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          stream_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    stream_bwd_kernel<<<n_tiles, n_px, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        att, pid, starts, fwd, ct_img, ct_T, ty0, tiles_x, ts, chunk, k_slots,
        alpha_clamp, alpha_min, eps_T, dpair);
  }
  return static_cast<int>(cudaGetLastError());
}
