// Project + SH: the per-splat projection (camera transform, clamped
// perspective Jacobian, 2-D covariance with its low-pass, conic, footprint
// radius, cull mask) and the SH colour as one forward kernel, and their
// hand-derived VJP as a second kernel.
//
// Replaces no TPU kernel: gsjax/render/project.py and sh.py are plain XLA,
// which fuses them itself. In PyTorch the same composition ran as dozens of
// elementwise launches and `stack`s over [N, ...] tensors, and autograd
// replayed each of them in reverse, every intermediate through device
// memory. render/project.py keeps that composition as the forward's plain
// version and the VJP written in PyTorch ops as the backward's.
//
// Bound on the card: bytes. At SH 3 a row reads 59 floats (means 3,
// log_scales 3, quats 4, sh 48, the opacity logit 1) and writes the home
// table's 12 columns (mean2d, depth, conic, radius, rgb, opacity and a
// zero: homesort's row, which the layout then takes without a copy) and
// the valid byte, or the lazy step's 9 table columns; the backward reads
// the 59 again and up to 10 output gradients and writes 59 leaf
// gradients. Some 300 floating operations a row either way, far below
// the card's rate for those bytes. Where the camera needs a gradient
// (pose refinement), the backward also writes each block's sum of its
// rows' partials of the 19 camera values, and a second kernel sums the
// blocks' in a fixed order: no atomics, the same bits every launch.
//
// Design: one thread a row, kRows rows a block. A block's run of sh rows
// (and of d_sh rows, and of the output rows) is contiguous in
// device memory, so it moves between device and shared memory as 16-byte
// loads and stores over the whole run: a thread-per-row walk of 192-byte
// rows would read one sector in six usefully. A thread then reads its own
// row in shared memory, rows laid at a stride that puts a warp's threads
// in distinct banks (an odd number of float4s where a row is a multiple
// of 4 floats, else the odd row length itself). The 3- and 4-float leaves
// are read a thread a row: a warp's loads of one leaf cover one contiguous
// run of sectors, which L1 serves to its next loads. The backward
// recomputes the forward from the leaves (nothing is saved beyond them, as
// D replays C), through the same `project_row`, so both kernels make the
// same cull and clamp decisions. Every leaf gradient is its own row's: no
// atomics, no sums across rows; only the camera's gradient sums rows.
//
// Parity: everything that decides `valid` or `radius` is written in the
// operand order the PyTorch composition takes on the card, its sums'
// included: torch.sum over a last axis of 3 adds (a0 + a2) + a1 and of 4
// (a0 + a2) + (a1 + a3) (a warp reduction over two or four lanes), over
// a middle axis in order; eval_sh's sum over K runs as four interleaved
// partial sums (k mod 4), then ((v0 + v1) + v2) + v3. The library builds
// with -fmad=false, so each product and sum rounds on its own. The
// gradient products use explicit fused multiply-adds: no decision
// depends on their bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace gsjax {
namespace project {

constexpr int kRows = 128;  // rows a block, one a thread
constexpr int kCamVals = 19;  // the camera block's floats (Cam)
constexpr int kReduceThreads = 256;  // cam_reduce_kernel's block

// The camera as render/project.py::camera_params packs it: the view
// matrix's rows 0-2 (W | t), fx, fy, the clamp limits 1.3·tan(fov/2)
// in x and y, the position.
struct Cam {
  float W[3][3], t[3];
  float fx, fy, limx, limy;
  float pos[3];
};

struct Consts {
  float near_cull, lowpass, radius_sigma, alpha_min, cx, cy, width, height;
};

struct FwdArgs {
  const float* means;
  const float* log_scales;
  const float* quats;
  const float* sh;
  const float* opacity_logits;
  const float* cam;
  int64_t n;
  Consts cs;
  // the home table [N, 12] and valid [N], or (table) the [N, 9] attribute
  // table
  float* home;
  unsigned char* valid;
  float* att;
};

// An output gradient: a [N, w] view with unit column stride (null: zero)
struct Grad {
  const float* p;
  int64_t stride;
};

struct BwdArgs {
  const float* means;
  const float* log_scales;
  const float* quats;
  const float* sh;
  const float* opacity_logits;
  const float* cam;
  int64_t n;
  Consts cs;
  Grad g_mean2d, g_depth, g_conic, g_rgb, g_opacity;
  int masked;  // the table's gradient: culled rows' mean, conic, opacity get none
  float* d_means;
  float* d_log_scales;
  float* d_quats;
  float* d_sh;
  float* d_opacity_logits;
  // the camera's gradient: [blocks, kCamVals] partials (null: none asked)
  float* d_cam_part;
};

// The f32 constants the composition multiplies by: its Python floats,
// rounded once from double, as torch rounds a scalar operand.
#define F32(x) static_cast<float>(x)
__device__ __forceinline__ float sh_c0() { return F32(0.28209479177387814); }
__device__ __forceinline__ float sh_c1() { return F32(0.4886025119029199); }

// A block's rows of a [N, C] float matrix in shared memory.
template <int C>
struct Tile {
  static constexpr bool kVec = C % 4 == 0;
  static constexpr int kStride = kVec ? ((C / 4) | 1) * 4 : C;
  static constexpr int kFloats = kRows * kStride;
};

// rows [row0, row0 + rows) of src [N, C] into the tile, thread `tid`'s share
template <int C>
__device__ __forceinline__ void tile_load(const float* __restrict__ src, int64_t row0,
                                          int rows, float* tile, int tid) {
  const float* base = src + row0 * C;
  const int total = rows * C;
  const bool aligned = (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  if constexpr (Tile<C>::kVec) {
    constexpr int c4 = C / 4;
    if (aligned) {
      const float4* b4 = reinterpret_cast<const float4*>(base);
      float4* t4 = reinterpret_cast<float4*>(tile);
      for (int i = tid; i < rows * c4; i += kRows)
        t4[(i / c4) * (Tile<C>::kStride / 4) + i % c4] = __ldg(b4 + i);
      return;
    }
    for (int f = tid; f < total; f += kRows)
      tile[(f / C) * Tile<C>::kStride + f % C] = __ldg(base + f);
  } else {
    int done = 0;
    if (aligned) {
      const float4* b4 = reinterpret_cast<const float4*>(base);
      float4* t4 = reinterpret_cast<float4*>(tile);
      for (int i = tid; i < total / 4; i += kRows) t4[i] = __ldg(b4 + i);
      done = total / 4 * 4;
    }
    for (int f = done + tid; f < total; f += kRows) tile[f] = __ldg(base + f);
  }
}

// the tile's rows to dst [N, C] rows [row0, row0 + rows), thread `tid`'s share
template <int C>
__device__ __forceinline__ void tile_store(const float* tile, float* __restrict__ dst,
                                           int64_t row0, int rows, int tid) {
  float* base = dst + row0 * C;
  const int total = rows * C;
  const bool aligned = (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  if constexpr (Tile<C>::kVec) {
    constexpr int c4 = C / 4;
    if (aligned) {
      float4* b4 = reinterpret_cast<float4*>(base);
      const float4* t4 = reinterpret_cast<const float4*>(tile);
      for (int i = tid; i < rows * c4; i += kRows)
        b4[i] = t4[(i / c4) * (Tile<C>::kStride / 4) + i % c4];
      return;
    }
    for (int f = tid; f < total; f += kRows)
      base[f] = tile[(f / C) * Tile<C>::kStride + f % C];
  } else {
    int done = 0;
    if (aligned) {
      float4* b4 = reinterpret_cast<float4*>(base);
      const float4* t4 = reinterpret_cast<const float4*>(tile);
      for (int i = tid; i < total / 4; i += kRows) b4[i] = t4[i];
      done = total / 4 * 4;
    }
    for (int f = done + tid; f < total; f += kRows) base[f] = tile[f];
  }
}

__device__ __forceinline__ Cam load_cam(const float* __restrict__ c) {
  Cam k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) k.W[i][j] = __ldg(c + 4 * i + j);
    k.t[i] = __ldg(c + 4 * i + 3);
  }
  k.fx = __ldg(c + 12);
  k.fy = __ldg(c + 13);
  k.limx = __ldg(c + 14);
  k.limy = __ldg(c + 15);
#pragma unroll
  for (int i = 0; i < 3; ++i) k.pos[i] = __ldg(c + 16 + i);
  return k;
}

// torch.clamp(v, lo, hi) with tensor bounds, and torch.clamp(v, min=lo):
// a NaN stays NaN
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// Everything the composition computes for one row, and the backward reads.
struct Proj {
  float tc[3];
  bool in_front;
  float zc, ux, uy, uxc, uyc, tx, ty, inv_z, inv_z2;
  float T0[3], T1[3];
  float s[3], qn[4], qden, R[3][3], M[3][3];
  float a0[3], a1[3];
  float c00, c01, c11;
  bool det_ok;
  float inv_det;
  float radius, mean2d[2], conic[3], opacity;
  bool valid;
  float dden, dir[3];
};

// render/project.py::project_plain for one row, in its operand order
__device__ __forceinline__ void project_row(const Cam& k, const Consts& cs, const float m[3],
                                            const float ls[3], const float q[4], float ol,
                                            Proj& p) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p.tc[i] = ((m[0] * k.W[i][0] + m[2] * k.W[i][2]) + m[1] * k.W[i][1]) + k.t[i];
  const float z = p.tc[2];
  p.in_front = z > cs.near_cull;
  p.zc = p.in_front ? z : 1.0f;
  p.ux = p.tc[0] / p.zc;
  p.uy = p.tc[1] / p.zc;
  p.uxc = clamp_t(p.ux, -k.limx, k.limx);
  p.uyc = clamp_t(p.uy, -k.limy, k.limy);
  p.tx = p.uxc * p.zc;
  p.ty = p.uyc * p.zc;
  p.inv_z = 1.0f / p.zc;
  p.inv_z2 = p.inv_z * p.inv_z;
  const float j00 = k.fx * p.inv_z;
  const float j02 = (-k.fx * p.tx) * p.inv_z2;
  const float j11 = k.fy * p.inv_z;
  const float j12 = (-k.fy * p.ty) * p.inv_z2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.T0[c] = j00 * k.W[0][c] + j02 * k.W[2][c];
    p.T1[c] = j11 * k.W[1][c] + j12 * k.W[2][c];
    p.s[c] = expf(ls[c]);
  }
  const float qq = (q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]);
  p.qden = sqrtf(qq + 1e-24f);
#pragma unroll
  for (int i = 0; i < 4; ++i) p.qn[i] = q[i] / p.qden;
  const float w = p.qn[0], x = p.qn[1], y = p.qn[2], zq = p.qn[3];
  p.R[0][0] = 1.0f - 2.0f * (y * y + zq * zq);
  p.R[0][1] = 2.0f * (x * y - w * zq);
  p.R[0][2] = 2.0f * (x * zq + w * y);
  p.R[1][0] = 2.0f * (x * y + w * zq);
  p.R[1][1] = 1.0f - 2.0f * (x * x + zq * zq);
  p.R[1][2] = 2.0f * (y * zq - w * x);
  p.R[2][0] = 2.0f * (x * zq - w * y);
  p.R[2][1] = 2.0f * (y * zq + w * x);
  p.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) p.M[r][c] = p.R[r][c] * p.s[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.a0[c] = (p.T0[0] * p.M[0][c] + p.T0[1] * p.M[1][c]) + p.T0[2] * p.M[2][c];
    p.a1[c] = (p.T1[0] * p.M[0][c] + p.T1[1] * p.M[1][c]) + p.T1[2] * p.M[2][c];
  }
  p.c00 = ((p.a0[0] * p.a0[0] + p.a0[2] * p.a0[2]) + p.a0[1] * p.a0[1]) + cs.lowpass;
  p.c01 = (p.a0[0] * p.a1[0] + p.a0[2] * p.a1[2]) + p.a0[1] * p.a1[1];
  p.c11 = ((p.a1[0] * p.a1[0] + p.a1[2] * p.a1[2]) + p.a1[1] * p.a1[1]) + cs.lowpass;
  const float det = p.c00 * p.c11 - p.c01 * p.c01;
  p.det_ok = det > 0.0f;
  const float det_safe = p.det_ok ? det : 1.0f;
  p.inv_det = 1.0f / det_safe;
  p.conic[0] = p.c11 * p.inv_det;
  p.conic[1] = -p.c01 * p.inv_det;
  p.conic[2] = p.c00 * p.inv_det;
  const float mid = 0.5f * (p.c00 + p.c11);
  const float lam1 = mid + sqrtf(clamp_min_t(mid * mid - det_safe, 0.1f));
  p.radius = ceilf(cs.radius_sigma * sqrtf(lam1));
  p.mean2d[0] = (k.fx * p.tc[0]) * p.inv_z + cs.cx;
  p.mean2d[1] = (k.fy * p.tc[1]) * p.inv_z + cs.cy;
  const bool on_screen = (p.mean2d[0] + p.radius >= 0.0f) &&
                         (p.mean2d[0] - p.radius < cs.width) &&
                         (p.mean2d[1] + p.radius >= 0.0f) &&
                         (p.mean2d[1] - p.radius < cs.height);
  p.opacity = 1.0f / (1.0f + expf(-ol));
  float d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = m[i] - k.pos[i];
  p.dden = sqrtf(((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1]) + 1e-24f);
#pragma unroll
  for (int i = 0; i < 3; ++i) p.dir[i] = d[i] / p.dden;
  p.valid = p.in_front && p.det_ok && on_screen && p.opacity >= cs.alpha_min;
}

// render/sh.py::sh_basis for one unit direction, in its operand order
template <int K>
__device__ __forceinline__ void sh_basis(const float dir[3], float B[K]) {
  B[0] = sh_c0();
  if constexpr (K > 1) {
    const float x = dir[0], y = dir[1], z = dir[2];
    B[1] = -sh_c1() * y;
    B[2] = sh_c1() * z;
    B[3] = -sh_c1() * x;
    if constexpr (K > 4) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      B[4] = F32(1.0925484305920792) * xy;
      B[5] = F32(-1.0925484305920792) * yz;
      B[6] = F32(0.31539156525252005) * ((2.0f * zz - xx) - yy);
      B[7] = F32(-1.0925484305920792) * xz;
      B[8] = F32(0.5462742152960396) * (xx - yy);
      if constexpr (K > 9) {
        B[9] = (F32(-0.5900435899266435) * y) * (3.0f * xx - yy);
        B[10] = (F32(2.890611442640554) * xy) * z;
        B[11] = (F32(-0.4570457994644658) * y) * ((4.0f * zz - xx) - yy);
        B[12] = (F32(0.3731763325901154) * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
        B[13] = (F32(-0.4570457994644658) * x) * ((4.0f * zz - xx) - yy);
        B[14] = (F32(1.445305721320277) * z) * (xx - yy);
        B[15] = (F32(-0.5900435899266435) * x) * (xx - 3.0f * yy);
      }
    }
  }
}

// The basis's VJP: g_dir += Σ_k g_B[k] ∂B_k/∂dir (graphdeco's derivatives).
template <int K>
__device__ __forceinline__ void sh_basis_vjp(const float dir[3], const float gB[K],
                                             float g[3]) {
  g[0] = g[1] = g[2] = 0.0f;
  if constexpr (K > 1) {
    const float x = dir[0], y = dir[1], z = dir[2];
    const float c1 = sh_c1();
    g[0] = fmaf(-c1, gB[3], g[0]);
    g[1] = fmaf(-c1, gB[1], g[1]);
    g[2] = fmaf(c1, gB[2], g[2]);
    if constexpr (K > 4) {
      const float a = F32(1.0925484305920792), b = F32(0.31539156525252005),
                  e = F32(0.5462742152960396);
      g[0] += a * y * gB[4] - 2.0f * b * x * gB[6] - a * z * gB[7] + 2.0f * e * x * gB[8];
      g[1] += a * x * gB[4] - a * z * gB[5] - 2.0f * b * y * gB[6] - 2.0f * e * y * gB[8];
      g[2] += -a * y * gB[5] + 4.0f * b * z * gB[6] - a * x * gB[7];
      if constexpr (K > 9) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float c30 = F32(-0.5900435899266435), c31 = F32(2.890611442640554),
                    c32 = F32(-0.4570457994644658), c33 = F32(0.3731763325901154),
                    c34 = F32(-0.4570457994644658), c35 = F32(1.445305721320277),
                    c36 = F32(-0.5900435899266435);
        g[0] += c30 * 6.0f * x * y * gB[9] + c31 * y * z * gB[10] -
                c32 * 2.0f * x * y * gB[11] - c33 * 6.0f * x * z * gB[12] +
                c34 * (4.0f * zz - 3.0f * xx - yy) * gB[13] + c35 * 2.0f * x * z * gB[14] +
                c36 * 3.0f * (xx - yy) * gB[15];
        g[1] += c30 * 3.0f * (xx - yy) * gB[9] + c31 * x * z * gB[10] +
                c32 * (4.0f * zz - xx - 3.0f * yy) * gB[11] - c33 * 6.0f * y * z * gB[12] -
                c34 * 2.0f * x * y * gB[13] - c35 * 2.0f * y * z * gB[14] -
                c36 * 6.0f * x * y * gB[15];
        g[2] += c31 * x * y * gB[10] + c32 * 8.0f * y * z * gB[11] +
                c33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gB[12] +
                c34 * 8.0f * x * z * gB[13] + c35 * (xx - yy) * gB[14];
      }
    }
  }
}

// A thread's own row of a tile to registers and back: float4s where rows
// are padded to them (a bank pattern without conflicts), else floats.
template <int C>
__device__ __forceinline__ void row_load(const float* row, float v[C]) {
  if constexpr (Tile<C>::kVec) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(row)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = row[i];
  }
}

template <int C>
__device__ __forceinline__ void row_store(float* row, const float v[C]) {
  if constexpr (Tile<C>::kVec) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i)
      reinterpret_cast<float4*>(row)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) row[i] = v[i];
  }
}

// eval_sh's Σ_k B_k·sh_k + 0.5 before the clamp, in torch's order on the
// card: four partial sums over k mod 4, then ((v0 + v1) + v2) + v3
template <int K>
__device__ __forceinline__ void sh_color(const float B[K], const float v[3 * K], float raw[3]) {
  float acc[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[k & 3][c] = acc[k & 3][c] + B[k] * v[3 * k + c];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    raw[c] = (((acc[0][c] + acc[1][c]) + acc[2][c]) + acc[3][c]) + 0.5f;
}

// The forward's output row: the home table's 12 columns, or the lazy
// table's 9.
template <bool kTable>
using OutTile = Tile<kTable ? 9 : 12>;

template <int K, bool kTable>
__device__ __forceinline__ void fwd_row(const FwdArgs& a, const Cam& cam, const float* sh_tile,
                                        float* out_tile, int64_t row0, int r) {
  const int64_t i = row0 + r;
  float m[3], ls[3], q[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[c] = __ldg(a.means + 3 * i + c);
    ls[c] = __ldg(a.log_scales + 3 * i + c);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __ldg(a.quats + 4 * i + c);
  Proj p;
  project_row(cam, a.cs, m, ls, q, __ldg(a.opacity_logits + i), p);
  float B[K], v[3 * K], raw[3], rgb[3];
  sh_basis<K>(p.dir, B);
  row_load<3 * K>(sh_tile + r * Tile<3 * K>::kStride, v);
  sh_color<K>(B, v, raw);
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = clamp_min_t(raw[c], 0.0f);
  if constexpr (kTable) {
    // lazy.lazy_cols' columns: a culled row draws nothing
    const float o[9] = {p.valid ? p.mean2d[0] : 0.0f, p.valid ? p.mean2d[1] : 0.0f,
                        p.valid ? p.conic[0] : 1.0f,  p.valid ? p.conic[1] : 0.0f,
                        p.valid ? p.conic[2] : 1.0f,  rgb[0], rgb[1], rgb[2],
                        p.valid ? p.opacity : 0.0f};
    row_store<9>(out_tile + r * OutTile<kTable>::kStride, o);
  } else {
    // homesort's row: mean2d, depth, conic, radius (0 where culled), rgb,
    // opacity, 0
    const float o[12] = {p.mean2d[0], p.mean2d[1], p.tc[2], p.conic[0], p.conic[1],
                         p.conic[2],  p.valid ? p.radius : 0.0f, rgb[0], rgb[1], rgb[2],
                         p.opacity,   0.0f};
    row_store<12>(out_tile + r * OutTile<kTable>::kStride, o);
    a.valid[i] = p.valid ? 1 : 0;
  }
}

template <int K, bool kTable>
__global__ void __launch_bounds__(kRows) project_fwd_kernel(const FwdArgs a) {
  __shared__ __align__(16) float sh_tile[Tile<3 * K>::kFloats];
  __shared__ __align__(16) float out_tile[OutTile<kTable>::kFloats];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(a.n - row0 < kRows ? a.n - row0 : kRows);
  tile_load<3 * K>(a.sh, row0, rows, sh_tile, threadIdx.x);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows)
    fwd_row<K, kTable>(a, load_cam(a.cam), sh_tile, out_tile, row0, threadIdx.x);
  __syncthreads();
  constexpr int kCols = kTable ? 9 : 12;
  tile_store<kCols>(out_tile, kTable ? a.att : a.home, row0, rows, threadIdx.x);
}

inline int blocks(int64_t n) { return static_cast<int>((n + kRows - 1) / kRows); }

__device__ __forceinline__ float grad_at(const Grad& g, int64_t i, int c) {
  return g.p ? __ldg(g.p + i * g.stride + c) : 0.0f;
}

// One row's VJP; d_sh goes to the row's place in the tile (over its sh),
// and (kCam) the row's partials of the camera's values to cam_tile's
// column tid, rows in Cam's order.
template <int K, bool kCam>
__device__ __forceinline__ void bwd_row(const BwdArgs& a, float* sh_tile, float* cam_tile,
                                        int64_t row0, int tid) {
  const Cam k = load_cam(a.cam);
  const int64_t i = row0 + tid;
  float m[3], ls[3], q[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[c] = __ldg(a.means + 3 * i + c);
    ls[c] = __ldg(a.log_scales + 3 * i + c);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __ldg(a.quats + 4 * i + c);
  Proj p;
  project_row(k, a.cs, m, ls, q, __ldg(a.opacity_logits + i), p);
  float* row = sh_tile + tid * Tile<3 * K>::kStride;
  float B[K], v[3 * K], raw[3];
  sh_basis<K>(p.dir, B);
  row_load<3 * K>(row, v);
  sh_color<K>(B, v, raw);

  // the output gradients; the table's culled rows took constants
  const bool pass = !a.masked || p.valid;
  float g_m2[2], g_k[3], g_rgb[3];
  for (int c = 0; c < 2; ++c) g_m2[c] = pass ? grad_at(a.g_mean2d, i, c) : 0.0f;
  for (int c = 0; c < 3; ++c) {
    g_k[c] = pass ? grad_at(a.g_conic, i, c) : 0.0f;
    g_rgb[c] = grad_at(a.g_rgb, i, c);
  }
  const float g_op = pass ? grad_at(a.g_opacity, i, 0) : 0.0f;
  const float g_depth = grad_at(a.g_depth, i, 0);

  // opacity = sigmoid(logit)
  a.d_opacity_logits[i] = g_op * (1.0f - p.opacity) * p.opacity;

  // rgb = max(Σ_k B_k sh_k + 0.5, 0); dir = d / |d|
  float g_raw[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) g_raw[c] = raw[c] >= 0.0f ? g_rgb[c] : 0.0f;
  float gB[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) s = fmaf(v[3 * kk + c], g_raw[c], s);
    gB[kk] = s;
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int c = 0; c < 3; ++c) v[3 * kk + c] = B[kk] * g_raw[c];
  row_store<3 * K>(row, v);
  float g_dir[3];
  sh_basis_vjp<K>(p.dir, gB, g_dir);
  const float dg = fmaf(p.dir[0], g_dir[0], fmaf(p.dir[1], g_dir[1], p.dir[2] * g_dir[2]));
  float g_m[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) g_m[c] = fmaf(-p.dir[c], dg, g_dir[c]) / p.dden;

  // mean2d = (f·tc) / z + c; depth = tc_z
  float g_tc[3];
  g_tc[0] = g_m2[0] * k.fx * p.inv_z;
  g_tc[1] = g_m2[1] * k.fy * p.inv_z;
  g_tc[2] = g_depth;
  float g_inv_z = fmaf(g_m2[0], k.fx * p.tc[0], g_m2[1] * (k.fy * p.tc[1]));

  // conic = (c11, -c01, c00) / det
  float g_c00 = g_k[2] * p.inv_det, g_c11 = g_k[0] * p.inv_det, g_c01 = -g_k[1] * p.inv_det;
  if (p.det_ok) {
    const float g_inv = fmaf(g_k[0], p.c11, fmaf(-g_k[1], p.c01, g_k[2] * p.c00));
    const float g_det = -g_inv * p.inv_det * p.inv_det;
    g_c00 = fmaf(g_det, p.c11, g_c00);
    g_c11 = fmaf(g_det, p.c00, g_c11);
    g_c01 = fmaf(-2.0f * g_det, p.c01, g_c01);
  }

  // c00 = a0·a0 + lp, c01 = a0·a1, c11 = a1·a1 + lp; a0 = Mᵀ T0, a1 = Mᵀ T1
  float g_a0[3], g_a1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_a0[c] = fmaf(2.0f * g_c00, p.a0[c], g_c01 * p.a1[c]);
    g_a1[c] = fmaf(2.0f * g_c11, p.a1[c], g_c01 * p.a0[c]);
  }
  float g_T0[3], g_T1[3], g_R[3][3], g_s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    g_T0[r] = fmaf(p.M[r][0], g_a0[0], fmaf(p.M[r][1], g_a0[1], p.M[r][2] * g_a0[2]));
    g_T1[r] = fmaf(p.M[r][0], g_a1[0], fmaf(p.M[r][1], g_a1[1], p.M[r][2] * g_a1[2]));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gM = fmaf(p.T0[r], g_a0[c], p.T1[r] * g_a1[c]);
      g_R[r][c] = gM * p.s[c];
      g_s[c] = fmaf(gM, p.R[r][c], g_s[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) a.d_log_scales[3 * i + c] = g_s[c] * p.s[c];

  // R(qn), qn = q / sqrt(|q|² + ε)
  {
    const float w = p.qn[0], x = p.qn[1], y = p.qn[2], z = p.qn[3];
    float gq[4];
    gq[0] = 2.0f * (-z * g_R[0][1] + y * g_R[0][2] + z * g_R[1][0] - x * g_R[1][2] -
                    y * g_R[2][0] + x * g_R[2][1]);
    gq[1] = 2.0f * (y * g_R[0][1] + z * g_R[0][2] + y * g_R[1][0] - 2.0f * x * g_R[1][1] -
                    w * g_R[1][2] + z * g_R[2][0] + w * g_R[2][1] - 2.0f * x * g_R[2][2]);
    gq[2] = 2.0f * (-2.0f * y * g_R[0][0] + x * g_R[0][1] + w * g_R[0][2] + x * g_R[1][0] +
                    z * g_R[1][2] - w * g_R[2][0] + z * g_R[2][1] - 2.0f * y * g_R[2][2]);
    gq[3] = 2.0f * (-2.0f * z * g_R[0][0] - w * g_R[0][1] + x * g_R[0][2] + w * g_R[1][0] -
                    2.0f * z * g_R[1][1] + y * g_R[1][2] + x * g_R[2][0] + y * g_R[2][1]);
    const float qg = fmaf(w, gq[0], fmaf(x, gq[1], fmaf(y, gq[2], z * gq[3])));
#pragma unroll
    for (int c = 0; c < 4; ++c) a.d_quats[4 * i + c] = fmaf(-p.qn[c], qg, gq[c]) / p.qden;
  }

  // T0 = j00 W0 + j02 W2, T1 = j11 W1 + j12 W2 (the Jacobian, clamped)
  const float g_j00 = fmaf(g_T0[0], k.W[0][0], fmaf(g_T0[1], k.W[0][1], g_T0[2] * k.W[0][2]));
  const float g_j02 = fmaf(g_T0[0], k.W[2][0], fmaf(g_T0[1], k.W[2][1], g_T0[2] * k.W[2][2]));
  const float g_j11 = fmaf(g_T1[0], k.W[1][0], fmaf(g_T1[1], k.W[1][1], g_T1[2] * k.W[1][2]));
  const float g_j12 = fmaf(g_T1[0], k.W[2][0], fmaf(g_T1[1], k.W[2][1], g_T1[2] * k.W[2][2]));
  g_inv_z = fmaf(g_j00, k.fx, fmaf(g_j11, k.fy, g_inv_z));
  const float g_inv_z2 = -fmaf(g_j02 * k.fx, p.tx, g_j12 * k.fy * p.ty);
  const float g_tx = -g_j02 * k.fx * p.inv_z2;
  const float g_ty = -g_j12 * k.fy * p.inv_z2;
  g_inv_z = fmaf(2.0f * p.inv_z, g_inv_z2, g_inv_z);
  // inv_z = 1 / zc; t = clamp(tc / zc)·zc
  float g_zc = fmaf(-g_inv_z * p.inv_z, p.inv_z, fmaf(g_tx, p.uxc, g_ty * p.uyc));
  const float g_ux = (p.ux >= -k.limx && p.ux <= k.limx) ? g_tx * p.zc : 0.0f;
  const float g_uy = (p.uy >= -k.limy && p.uy <= k.limy) ? g_ty * p.zc : 0.0f;
  g_tc[0] += g_ux / p.zc;
  g_tc[1] += g_uy / p.zc;
  g_zc -= fmaf(g_ux, p.tc[0], g_uy * p.tc[1]) / (p.zc * p.zc);
  if (p.in_front) g_tc[2] += g_zc;

  // tc = W m + t
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a.d_means[3 * i + c] =
        fmaf(k.W[0][c], g_tc[0], fmaf(k.W[1][c], g_tc[1], fmaf(k.W[2][c], g_tc[2], g_m[c])));

  if constexpr (kCam) {
    // the camera: W | t through tc = W m + t and T = J W; fx, fy through J
    // and mean2d; the limits where torch.clamp passed the gradient to its
    // bound (u beyond it); the position through dir = m - pos
    const float j00 = k.fx * p.inv_z, j02 = (-k.fx * p.tx) * p.inv_z2;
    const float j11 = k.fy * p.inv_z, j12 = (-k.fy * p.ty) * p.inv_z2;
    float* col = cam_tile + tid;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      col[(4 * 0 + c) * kRows] = fmaf(g_tc[0], m[c], g_T0[c] * j00);
      col[(4 * 1 + c) * kRows] = fmaf(g_tc[1], m[c], g_T1[c] * j11);
      col[(4 * 2 + c) * kRows] = fmaf(g_tc[2], m[c], fmaf(g_T0[c], j02, g_T1[c] * j12));
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) col[(4 * r + 3) * kRows] = g_tc[r];
    col[12 * kRows] = fmaf(g_j00, p.inv_z, fmaf(-g_j02 * p.tx, p.inv_z2,
                                                g_m2[0] * p.tc[0] * p.inv_z));
    col[13 * kRows] = fmaf(g_j11, p.inv_z, fmaf(-g_j12 * p.ty, p.inv_z2,
                                                g_m2[1] * p.tc[1] * p.inv_z));
    const float g_uxc = g_tx * p.zc, g_uyc = g_ty * p.zc;
    col[14 * kRows] = p.ux > k.limx ? g_uxc : (p.ux < -k.limx ? -g_uxc : 0.0f);
    col[15 * kRows] = p.uy > k.limy ? g_uyc : (p.uy < -k.limy ? -g_uyc : 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) col[(16 + c) * kRows] = -g_m[c];
  }
}

template <int K, bool kCam>
__global__ void __launch_bounds__(kRows) project_bwd_kernel(const BwdArgs a) {
  __shared__ __align__(16) float sh_tile[Tile<3 * K>::kFloats];
  // the rows' camera partials, one column a row (a row past n adds 0)
  __shared__ float cam_tile[kCam ? kCamVals * kRows : 1];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(a.n - row0 < kRows ? a.n - row0 : kRows);
  const int tid = threadIdx.x;
  tile_load<3 * K>(a.sh, row0, rows, sh_tile, tid);
  if constexpr (kCam)
    for (int j = 0; j < kCamVals; ++j) cam_tile[j * kRows + tid] = 0.0f;
  __syncthreads();
  if (tid < rows) bwd_row<K, kCam>(a, sh_tile, cam_tile, row0, tid);
  __syncthreads();
  tile_store<3 * K>(sh_tile, a.d_sh, row0, rows, tid);
  if constexpr (kCam) {
    if (tid < kCamVals) {  // the block's sum of each value, rows in order
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += cam_tile[tid * kRows + r];
      a.d_cam_part[static_cast<int64_t>(blockIdx.x) * kCamVals + tid] = s;
    }
  }
}

// d_cam[j] = the sum of the blocks' partials part[b][j], a block a value:
// strided partial sums, then a tree, in a fixed order
__global__ void __launch_bounds__(kReduceThreads)
    cam_reduce_kernel(const float* __restrict__ part, int64_t blocks, float* d_cam) {
  __shared__ float s[kReduceThreads];
  const int j = blockIdx.x, tid = threadIdx.x;
  float acc = 0.0f;
  for (int64_t b = tid; b < blocks; b += kReduceThreads) acc += part[b * kCamVals + j];
  s[tid] = acc;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (tid < w) s[tid] += s[tid + w];
    __syncthreads();
  }
  if (tid == 0) d_cam[j] = s[0];
}

template <bool kCam>
int launch_bwd(const BwdArgs& a, int k, cudaStream_t s) {
  const int nb = blocks(a.n);
  switch (k) {
    case 1: project_bwd_kernel<1, kCam><<<nb, kRows, 0, s>>>(a); break;
    case 4: project_bwd_kernel<4, kCam><<<nb, kRows, 0, s>>>(a); break;
    case 9: project_bwd_kernel<9, kCam><<<nb, kRows, 0, s>>>(a); break;
    case 16: project_bwd_kernel<16, kCam><<<nb, kRows, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kTable>
int launch_fwd(const FwdArgs& a, int k, cudaStream_t s) {
  switch (k) {
    case 1: project_fwd_kernel<1, kTable><<<blocks(a.n), kRows, 0, s>>>(a); break;
    case 4: project_fwd_kernel<4, kTable><<<blocks(a.n), kRows, 0, s>>>(a); break;
    case 9: project_fwd_kernel<9, kTable><<<blocks(a.n), kRows, 0, s>>>(a); break;
    case 16: project_fwd_kernel<16, kTable><<<blocks(a.n), kRows, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace project
}  // namespace gsjax

using gsjax::project::BwdArgs;
using gsjax::project::Consts;
using gsjax::project::FwdArgs;
using gsjax::project::Grad;

// sh is [N, k, 3]; att non-null selects the table (home and valid are
// then unused)
extern "C" int gsjax_project_forward(const float* means, const float* log_scales,
                                     const float* quats, const float* sh,
                                     const float* opacity_logits, const float* cam,
                                     long long n, int k, float near_cull, float lowpass,
                                     float radius_sigma, float alpha_min, float cx, float cy,
                                     float width, float height, float* home,
                                     unsigned char* valid, float* att, void* stream) {
  const FwdArgs a{means, log_scales, quats, sh, opacity_logits, cam, n,
                  Consts{near_cull, lowpass, radius_sigma, alpha_min, cx, cy, width, height},
                  home, valid, att};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return att ? gsjax::project::launch_fwd<true>(a, k, s)
             : gsjax::project::launch_fwd<false>(a, k, s);
}

// the floats of the backward's camera partials for n rows (d_cam_part)
extern "C" int gsjax_project_cam_scratch(long long n) {
  return gsjax::project::blocks(n) * gsjax::project::kCamVals;
}

// the output gradients as (pointer, row stride) pairs, a null pointer for
// none; masked: the gradient of the table; d_cam non-null: the camera
// block's gradient [19] too, through d_cam_part
// [gsjax_project_cam_scratch(n)]
extern "C" int gsjax_project_backward(
    const float* means, const float* log_scales, const float* quats, const float* sh,
    const float* opacity_logits, const float* cam, long long n, int k, float near_cull,
    float lowpass, float radius_sigma, float alpha_min, float cx, float cy, float width,
    float height, const float* g_mean2d, long long s_mean2d, const float* g_depth,
    long long s_depth, const float* g_conic, long long s_conic, const float* g_rgb,
    long long s_rgb, const float* g_opacity, long long s_opacity, int masked, float* d_means,
    float* d_log_scales, float* d_quats, float* d_sh, float* d_opacity_logits,
    float* d_cam_part, float* d_cam, void* stream) {
  const BwdArgs a{means, log_scales, quats, sh, opacity_logits, cam, n,
                  Consts{near_cull, lowpass, radius_sigma, alpha_min, cx, cy, width, height},
                  Grad{g_mean2d, s_mean2d}, Grad{g_depth, s_depth}, Grad{g_conic, s_conic},
                  Grad{g_rgb, s_rgb}, Grad{g_opacity, s_opacity}, masked, d_means,
                  d_log_scales, d_quats, d_sh, d_opacity_logits, d_cam ? d_cam_part : nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace pj = gsjax::project;
  if (!d_cam) return pj::launch_bwd<false>(a, k, s);
  const int err = pj::launch_bwd<true>(a, k, s);
  if (err) return err;
  pj::cam_reduce_kernel<<<pj::kCamVals, pj::kReduceThreads, 0, s>>>(d_cam_part, pj::blocks(n),
                                                                    d_cam);
  return static_cast<int>(cudaGetLastError());
}
