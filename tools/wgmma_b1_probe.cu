// Does this toolkit assemble Hopper's binary tensor-core product for
// sm_90a?  tools/rule_match_packed_designs.py compiles this file first:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -cubin tools/wgmma_b1_probe.cu
//
// The kernel is never launched; the build is the answer.

#include <cstdint>

__global__ void wgmma_b1_probe(int* out, uint64_t a, uint64_t b) {
  int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n8k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3}, %4, %5, p;\n"
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n}\n"
      : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
      : "l"(a), "l"(b), "r"(1));
  out[threadIdx.x] = d0 + d1 + d2 + d3;
}
