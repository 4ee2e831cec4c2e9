// Device helpers shared by the gsjax_torch kernels.
//
// Every expression here is written in the operand order of its plain
// PyTorch version, and the library is built with -fmad=false, so each
// multiply and add rounds on its own exactly as the separate PyTorch ops
// do: the kernels agree with their plain versions bit for bit on the
// integer outputs (tile ids, cull decisions) and to the last place on
// the blend.
#pragma once

#include <cuda_runtime.h>

namespace gsjax {

// exp(x) for x <= 0, clamped to [-87, 0]: 2^(x·log2 e) with the exponent
// assembled in the exponent field and the Cephes degree-5 polynomial for
// the fraction (gsjax/render/fastmath.py::fexp). Constants are the f32
// values the reference rounds its Python floats to, as hex literals so no
// decimal-to-float rounding can differ.
__device__ __forceinline__ float fexp(float x) {
  const float y = fmaxf(x, -87.0f) * 0x1.715476p+0f;  // log2 e
  const float n = floorf(y);
  const float f = y - n;
  float p = f * 0x1.426p-13f + 0x1.5f0556p-10f;
  p = p * f + 0x1.3b2b24p-7f;
  p = p * f + 0x1.c6af9ap-5f;
  p = p * f + 0x1.ebfbep-3f;
  p = p * f + 0x1.62e43p-1f;
  const float poly = p * f + 1.0f;
  return poly * __int_as_float((static_cast<int>(n) + 127) << 23);
}

// The conic quadratic a·dx² + 2b·dx·dy + c·dy², in the reference's
// operand order: ((a·dx)·dx + ((2·b)·dx)·dy) + (c·dy)·dy.
__device__ __forceinline__ float quad(float ca, float cb, float cc, float dx,
                                      float dy) {
  return ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy;
}

// jnp.clip / torch.minimum(torch.maximum(x, lo), hi)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// min of the conic quadratic over the pixel box [dxl, dxr] × [dyl, dyr]
// (offsets from the mean): 0 if the mean is inside, else the least of the
// four edge minima, each edge's free coordinate at its clamped 1-D
// minimiser. ncbrcc = -b/c, ncbrca = -b/a.
__device__ __forceinline__ float box_qmin(float ca, float cb, float cc,
                                          float ncbrcc, float ncbrca,
                                          float dxl, float dxr, float dyl,
                                          float dyr) {
  const float ex0 = quad(ca, cb, cc, dxl, clip(ncbrcc * dxl, dyl, dyr));
  const float ex1 = quad(ca, cb, cc, dxr, clip(ncbrcc * dxr, dyl, dyr));
  const float ey0 = quad(ca, cb, cc, clip(ncbrca * dyl, dxl, dxr), dyl);
  const float ey1 = quad(ca, cb, cc, clip(ncbrca * dyr, dxl, dxr), dyr);
  return fminf(fminf(ex0, ex1), fminf(ey0, ey1));
}

__device__ __forceinline__ bool box_inside(float dxl, float dxr, float dyl,
                                           float dyr) {
  return dxl <= 0.0f && dxr >= 0.0f && dyl <= 0.0f && dyr >= 0.0f;
}

}  // namespace gsjax
