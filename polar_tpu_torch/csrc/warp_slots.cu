// Where an SM puts the warps of resident blocks: each warp's lane 0 writes
// its SM (%smid) and warp slot (%warpid; slot s issues from the SM's
// sub-partition s % 4), then every thread spins, so that the blocks of a
// launch sized to fill the SMs are resident together. A probe for the
// Arikan capacity-8 body's leader-warp rule (scl_decode.cu `leader_warp`),
// run by sim/kernel_times.py --slots; no path of the port launches it.
#include <cuda_runtime.h>

namespace {

__global__ void warp_slots(unsigned* out, long long spin) {
  extern __shared__ unsigned char pad[];
  unsigned slot, sm;
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  if ((threadIdx.x & 31) == 0) {
    unsigned* o = out + 2 * (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
    o[0] = sm;
    o[1] = slot;
    pad[threadIdx.x] = 1;
  }
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {
  }
}

}  // namespace

extern "C" int warp_slots_launch(unsigned* out, int blocks, int threads,
                                 int smem, long long spin) {
  if (cudaFuncSetAttribute(warp_slots, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  warp_slots<<<blocks, threads, smem>>>(out, spin);
  return (int)cudaGetLastError();
}
