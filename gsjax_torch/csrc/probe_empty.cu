// The empty launch: a measuring tool for the probes' bounds, on Hopper.
//
// Block 0's thread 0 writes one int and no thread does anything else, so
// a launch costs what the card takes to start and retire the grid: the
// launch itself, the block scheduler's work for `grid` blocks of `block`
// threads, and the dynamic shared memory each block is given. Timed at a
// probe's own launch shape, it is the least time any kernel of that
// shape can take, the floor that chip_smoke.py counts in the probes'
// bounds (G-J). It replaces no TPU kernel and has no plain version.
#include "probe.cuh"

namespace {

__global__ void empty_kernel(int* __restrict__ out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = 0;
}

}  // namespace

// grid blocks of `block` threads, `smem` bytes of dynamic shared memory a
// block → out[0] = 0
extern "C" int gsjax_probe_empty(int grid, int block, int smem, int* out, void* stream) {
  if (grid <= 0 || block <= 0 || block > 1024 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a kernel must opt in; once per size, outside any graph
  // capture that follows (the attribute is not a stream operation)
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  empty_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}
