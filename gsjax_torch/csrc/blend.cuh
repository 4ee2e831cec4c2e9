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
//     tile goes on, so the exit is chunk-granular: the backward replays
//     n_done chunks.
// Output [T, 8, ts·ts] f32 rows: rgb, T_act, C, n_done, 0, 0. A tile with
// no pairs leaves (0, 0, 0, 1, 1, 0, 0, 0).
//
// Backward (blend_bwd_kernel): one block per tile, kBwdPixels pixels per
// thread, replays the chunks the forward ran in the forward's order, k =
// 0 .. n_done − 1, from the forward's start (C = 1):
//   * stage the chunk's attributes and gradient rows in shared memory;
//   * each pixel runs the chunk once, with the forward's expressions in
//     its operand order (the library builds with -fmad=false), so α,
//     eligible, include and C are the forward's bit for bit. It adds
//     pre += w·rgb per channel as the forward adds img, and takes the
//     suffix sum U_i = Σ_{j>i, included} v_j·w_j (v = rgb·ct_img) from the
//     forward's image, U = ct·(img − pre): at the pixel's last included
//     pair each difference is exactly 0. Then dα = v·T − (U + ct_T·T_act)
//     /(1−α), dpow = dα·α and d_op = dα·G where α is unclamped, and the 9
//     attribute gradients (mean2d, conic through dx/dy; rgb = w·ct_img;
//     opacity), each thread's pixels added first;
//   * the 9 sums over a warp's pixels are taken kBwdPairs pairs at a time
//     by one reduce-scatter (warp_reduce_scatter: 9(P−1) + 9·log2(32/P)
//     shuffles for P pairs, 54 for 4, where one warp_sum per value cost
//     45 per pair), skipped when no lane of the warp includes a pair of
//     the group; the lanes write the sums to the warp's partials in
//     shared memory, and the warps' partials are added in warp order;
//   * C only falls, so once every pixel of a warp has C < eps no later
//     pair of the tile includes any of them: the warp stops there (no α,
//     no reductions) and records where it stopped (wend); the sum skips
//     its partials past that point. It still meets the block's barriers;
//   * the pair's 9 sums go to its gradient row. A row belongs to one pair
//     of one tile, so no two blocks write one row: no float atomics, and
//     two launches give the same bits. PairRows marks each row it writes
//     (replayed[pid] = 1, a byte only its pair's block stores), so D's
//     per-pair buffer needs no zeroing; F's slot rows never replayed keep
//     the zeros its wrapper allocated.
// Replaying forward from C = 1 needs no C at a chunk's entry: the reverse
// replay this replaces rebuilt it by dividing the exit C by the chunk's
// product, ran the chunk three times (product, Σ v·w, gradients) and
// could flip a pixel's include decision near T ≈ eps (the reference's
// Pallas kernels still can, gsjax/render/pallas_flat.py's docstring).
//
// Bound on the card: the per-pixel arithmetic for dense tiles (~39 fp32
// operations for α and the transmittance wherever the pixel's C ≥ eps
// before the pair, ~6 more forward and ~46 more backward where the pair
// is included), the staging loads (36 bytes per pair) for sparse ones.
// Threads of a tile read the same shared-memory word at once (a
// broadcast, no bank conflicts); the per-tile work is imbalanced across
// blocks, which the 8k-tile grid spreads over the SMs. In the backward
// the reductions over pixels are still the largest part: taking them
// out of the shipped kernel saves ~40% of its time, the gradient
// products ~20%, and the replay itself is the rest
// (gsjax_torch/tools/blend_bwd_variants.py times these ablations).
// -fmad=false, which the bit-exact replay needs, halves the usable fp32
// rate of the forward and of the replay, so the backward's gradient
// products, past every decision, use explicit fused multiply-adds.
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
  // the backward's marks [NH·K]: 1 where it wrote gradient row pid
  unsigned char* replayed = nullptr;
  // the first row key of tile t, whose segment starts at s0
  __device__ int begin(int /*t*/, int s0) const { return s0; }
  // the gradient row of the pair at position q
  __device__ int key(int q) const { return __ldg(pid + q); }
  __device__ const float* row(int key) const {
    return att + static_cast<size_t>(key / k_slots) * kAtt;
  }
  __device__ void mark(int key) const { replayed[key] = 1; }
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
  __device__ void mark(int /*key*/) const {}  // the slot gradient is zeroed
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

// The backward's grouping: kBwdPairs consecutive pairs are reduced over
// a warp's pixels together (a power of two from 2 to 32), and each thread
// owns kBwdPixels pixels (1, 2 or 4). render/stream.py mirrors both
// (BWD_PAIRS, BWD_PIXELS).
constexpr int kBwdPairs = 4;
constexpr int kBwdPixels = 2;
static_assert(kBwdPairs >= 2 && kBwdPairs <= 32 && (kBwdPairs & (kBwdPairs - 1)) == 0,
              "kBwdPairs: a power of two from 2 to 32");
static_assert(kBwdPixels == 1 || kBwdPixels == 2 || kBwdPixels == 4,
              "kBwdPixels: 1, 2 or 4");

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

// Sum v[P·kAtt] (pair-major: v[q·kAtt + c] is pair q's gradient c) over
// the warp's 32 lanes. log2 P halving steps (lanes across offset 16, 8,
// …, 32/P swap halves, each keeps one half and adds the other's: 9(P−1)
// shuffles) leave lane l the 9 values of pair l / (32/P), summed over
// the lanes that share its top bits; a butterfly over the remaining
// log2(32/P) bits finishes the sums (9·log2(32/P) shuffles), so every
// lane of pair q's group holds q's 9 sums in v[0..8]. a + b == b + a in
// IEEE arithmetic, so those lanes hold the same bits.
__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

template <int P>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[P * kAtt],
                                                    int lane) {
  // loops with constant trip counts, fully unrolled, so every index of v
  // is a constant and v stays in registers
  constexpr int kHalvings = log2i(P);
#pragma unroll
  for (int lvl = 0; lvl < kHalvings; ++lvl) {
    const int off = 16 >> lvl;
    const int half = (P * kAtt) >> (lvl + 1);
    const bool hi = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < (P * kAtt) / 2; ++j) {
      if (j < half) {
        const float send = hi ? v[j] : v[j + half];
        const float keep = hi ? v[j + half] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
  }
#pragma unroll
  for (int b = kHalvings; b < 5; ++b) {
    const int off = 16 >> b;
#pragma unroll
    for (int c = 0; c < kAtt; ++c)
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], off);
  }
}

template <class Rows>
__global__ void blend_bwd_kernel(Rows rows, const int* __restrict__ starts,
                                 const float* __restrict__ fwd,
                                 const float* __restrict__ ct_img,
                                 const float* __restrict__ ct_T, int ty0,
                                 int tiles_x, int ts, int chunk,
                                 float alpha_clamp, float alpha_min,
                                 float eps_T, float* __restrict__ dout) {
  constexpr int P = kBwdPairs;
  constexpr int PX = kBwdPixels;
  constexpr int kLanesPerPair = 32 / P;
  extern __shared__ float sh[];  // [kAtt][chunk] attributes
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;
  const int n_px = n_thr * PX;
  const int n_warps = n_thr / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* red = sh + kAtt * chunk;  // [n_warps][chunk][kAtt] warp partials
  int* skey = reinterpret_cast<int*>(red + n_warps * chunk * kAtt);  // [chunk]
  int* wend = skey + chunk;  // [n_warps] pairs [0, wend[w]) warp w reduced

  const float* o = fwd + static_cast<size_t>(t) * kRows * n_px;
  const int n_done = static_cast<int>(o[5 * n_px]);  // one value per tile
  if (n_done == 0) return;
  const int s0 = starts[t];
  const int count = starts[t + 1] - s0;
  const int r0 = rows.begin(t, s0);

  // thread tid owns pixels tid·PX .. tid·PX + PX − 1 (a warp a compact
  // band of rows, so its pixels tend to finish together)
  float px[PX], py[PX], cr[PX], cg[PX], cbl[PX], img_r[PX], img_g[PX],
      img_b[PX], ctTT[PX], C[PX], pre_r[PX], pre_g[PX], pre_b[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int pix = tid * PX + j;
    const size_t p = static_cast<size_t>(t) * n_px + pix;
    px[j] = static_cast<float>((t % tiles_x) * ts + pix % ts);
    py[j] = static_cast<float>((t / tiles_x + ty0) * ts + pix / ts);
    cr[j] = ct_img[3 * p];
    cg[j] = ct_img[3 * p + 1];
    cbl[j] = ct_img[3 * p + 2];
    img_r[j] = o[pix];  // the forward's image: Σ over every included pair
    img_g[j] = o[n_px + pix];
    img_b[j] = o[2 * n_px + pix];
    ctTT[j] = ct_T[p] * o[3 * n_px + pix];  // ct_T · T_act
    C[j] = 1.0f;  // the forward's state, replayed
    pre_r[j] = pre_g[j] = pre_b[j] = 0.0f;
  }
  bool live = true;  // some pixel of the warp may still include a pair

  for (int k = 0; k < n_done; ++k) {
    const int m = min(chunk, count - k * chunk);
    stage_chunk(rows, r0 + k * chunk, m, chunk, sh, skey);
    __syncthreads();

    int end = 0;
    for (int i0 = 0; live && i0 < m; i0 += P) {
      float v[P * kAtt];
#pragma unroll
      for (int e = 0; e < P * kAtt; ++e) v[e] = 0.0f;
      bool any = false;  // the lane includes a pair of the group
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int i = i0 + q;
        // a fixed trip count keeps v[] in registers; past m the stage is stale
        if (i >= m) continue;  // uniform over the warp
        const float ca = sh[2 * chunk + i];
        const float cb = sh[3 * chunk + i];
        const float cc = sh[4 * chunk + i];
        const float r = sh[5 * chunk + i];
        const float g = sh[6 * chunk + i];
        const float b = sh[7 * chunk + i];
        // every pixel's α first, free of branches, so a thread's pixels
        // overlap; then each pixel's include chain
        PairTerms at[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j)
          at[j] = pair_terms(sh, chunk, i, px[j], py[j], alpha_clamp, alpha_min);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const PairTerms& a = at[j];
          if (!a.eligible) continue;
          const float f = 1.0f - a.alpha;
          const float Cn = C[j] * f;
          if (Cn >= eps_T) {
            any = true;
            // the forward's adds, in its order: at the pixel's last
            // included pair img − pre is exactly 0
            const float w = C[j] * a.alpha;
            pre_r[j] += w * r;
            pre_g[j] += w * g;
            pre_b[j] += w * b;
            // from here on no decision depends on the bits: the gradient
            // products use fused multiply-adds (explicit, since the build
            // has -fmad=false for the replay's sake)
            const float vv = __fmaf_rn(cbl[j], b, __fmaf_rn(cg[j], g, cr[j] * r));
            // U = Σ over the later included pairs of v·w
            const float U =
                __fmaf_rn(cbl[j], img_b[j] - pre_b[j],
                          __fmaf_rn(cg[j], img_g[j] - pre_g[j],
                                    cr[j] * (img_r[j] - pre_r[j])));
            const float dalpha = __fmaf_rn(vv, C[j], -((U + ctTT[j]) / f));
            const int e = q * kAtt;  // a constant once unrolled
            if (a.raw < alpha_clamp) {
              const float dpow = dalpha * a.alpha;
              const float hx = -0.5f * dpow * a.dx;
              const float hy = -0.5f * dpow * a.dy;
              v[e] = __fmaf_rn(dpow, __fmaf_rn(ca, a.dx, cb * a.dy), v[e]);
              v[e + 1] = __fmaf_rn(dpow, __fmaf_rn(cb, a.dx, cc * a.dy), v[e + 1]);
              v[e + 2] = __fmaf_rn(hx, a.dx, v[e + 2]);
              v[e + 3] = __fmaf_rn(-dpow * a.dx, a.dy, v[e + 3]);
              v[e + 4] = __fmaf_rn(hy, a.dy, v[e + 4]);
              v[e + 8] = __fmaf_rn(dalpha, a.G, v[e + 8]);
            }
            v[e + 5] = __fmaf_rn(w, cr[j], v[e + 5]);
            v[e + 6] = __fmaf_rn(w, cg[j], v[e + 6]);
            v[e + 7] = __fmaf_rn(w, cbl[j], v[e + 7]);
          }
          C[j] = Cn;
        }
      }
      // a group no lane includes is all zeros: no shuffles
      if (__any_sync(0xffffffffu, any)) warp_reduce_scatter<P>(v, lane);
      const int i = i0 + lane / kLanesPerPair;
      const int sub = lane % kLanesPerPair;
      if (i < m) {
        float* rr = red + (warp * chunk + i) * kAtt;
#pragma unroll
        for (int c = 0; c < kAtt; ++c)
          if (c % kLanesPerPair == sub) rr[c] = v[c];
      }
      end = min(i0 + P, m);
      // C only falls: once every pixel of the warp is below eps, no later
      // pair of the tile includes any of them
      bool open = false;
#pragma unroll
      for (int j = 0; j < PX; ++j) open = open || C[j] >= eps_T;
      live = __any_sync(0xffffffffu, open);
    }
    if (lane == 0) wend[warp] = end;
    __syncthreads();
    // the warps' partials in warp order; a warp that stopped adds nothing
    for (int e = tid; e < m * kAtt; e += n_thr) {
      const int i = e / kAtt;
      const int c = e - i * kAtt;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w)
        if (i < wend[w]) s += red[(w * chunk + i) * kAtt + c];
      dout[static_cast<size_t>(skey[i]) * kAtt + c] = s;
      if (c == 0) rows.mark(skey[i]);
    }
    // the next chunk's staging overwrites sh, red, skey and wend
    __syncthreads();
  }
}

// shared memory of the backward: the chunk's attributes and keys, the
// warps' partials and their ends
inline size_t blend_bwd_smem(int n_px, int chunk) {
  const int n_warps = n_px / (32 * kBwdPixels);
  return sizeof(float) * (kAtt * chunk + n_warps * chunk * kAtt + chunk + n_warps);
}

template <class Rows>
int launch_blend_backward(Rows rows, const int* starts, const float* fwd,
                          const float* ct_img, const float* ct_T, int n_tiles,
                          int ty0, int tiles_x, int ts, int chunk,
                          float alpha_clamp, float alpha_min, float eps_T,
                          float* dout, void* stream) {
  if (n_tiles > 0) {
    const int n_px = ts * ts;
    const size_t smem = blend_bwd_smem(n_px, chunk);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          blend_bwd_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    blend_bwd_kernel<Rows><<<n_tiles, n_px / kBwdPixels, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        rows, starts, fwd, ct_img, ct_T, ty0, tiles_x, ts, chunk, alpha_clamp,
        alpha_min, eps_T, dout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsjax
