// The integer tensor-core rate of one card, measured: every SM runs one
// CTA of two warpgroups, each issuing wgmma m64n256 products on a tile
// resident in its shared memory, `iters` times 4 in a row (one 128-byte
// swizzled slab), one group kept in flight.  kind 0 is s8 x s8 (k32, 2 x
// 64 x 256 x 32 int8 operations an instruction), kind 1 the b1 AND-popc
// (k256, 64 x 256 x 256 bit AND-popcount-adds an instruction).  The s8
// loop read against the published 1,979 TOP/s says how near its peak such
// a loop runs; the b1 loop gives the bound tools/rule_match_packed_designs.py
// and chip_smoke.py hold the packed kernels to.  Built with -I
// src/repro_torch/csrc for sm90.cuh.

#include "sm90.cuh"

namespace {

constexpr int kN = 256;
constexpr int kWG = 2;

template <bool kBits>
__global__ void __launch_bounds__(128 * kWG, 1)
wgmma_rate_kernel(int iters, int* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* tile = smem + (base - smem_u32(smem));
  // any bits will do; a pattern keeps the products from being all zeros
  for (int i = threadIdx.x; i < (64 * kWG + kN) * kSlab; i += blockDim.x)
    tile[i] = static_cast<unsigned char>(i * 2654435761u >> 24);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint32_t a = base + wg * 64 * kSlab;
  const uint32_t b = base + 64 * kWG * kSlab;
  int acc[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = 0;
  for (int it = 0; it < iters; ++it) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 32; ++kk) {
      if constexpr (kBits) {
        wgmma_b1<kN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk), 1);
      } else {
        wgmma_s8<kN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
  }
  wgmma_wait_all();
  fence_regs(acc);
  int sum = 0;
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) sum += acc[e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// one CTA a SM; out holds sms x 256 ints
extern "C" int wgmma_rate_launch(int kind, int iters, int sms, void* out,
                                 void* stream) {
  const int smem = 1024 + (64 * kWG + kN) * kSlab;
  auto kernel = kind ? wgmma_rate_kernel<true> : wgmma_rate_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<sms, 128 * kWG, smem, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
