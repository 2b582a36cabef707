// Packed-popcount rule matching for Hopper (sm_90a).
//
// Replaces the TPU kernel rule_scores_fused_pallas
// (src/repro/kernels/rule_match/fused.py):
//
//   out[b, r] = [ sum_w popc(Qw[b, w] & Aw[r, w]) == sizes[r] ] * conf[r]
//
// Bound: operations at the serving shapes.  B*R*W AND+popcount+add triples
// run against 16 popcounts per clock per SM, while the bytes are one read of
// Qw, Aw, sizes and conf and one write of the [B, R] float output.  Unlike
// mining, the output is the whole score matrix, so the kernel is
// output-stationary and needs no atomics: a block owns 64 rules (one per
// thread, its words walked 32 at a time in registers) and a group of 8
// queries, whose words sit in shared memory where every thread of a warp
// reads the same 16 bytes (a broadcast).  Consecutive threads write
// consecutive r, so the stores coalesce.  Blocks of 64 rules keep a batch of
// 8 queries spread over many SMs when the index is wide.
//
// Padded rule rows carry sizes = -1: a dot is >= 0, so they never match.
// The caller passes W % 4 == 0 with Qw and Aw 16-byte aligned (the words are
// read as uint4).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // rules per block, one per thread
constexpr int kQueries = 8;   // queries per block (serving pads B to 8)
constexpr int kWords = 32;    // words per stage (rule words in registers)
constexpr int kQuads = kWords / 4;

__global__ void __launch_bounds__(kThreads)
rule_match_packed_kernel(const uint32_t* __restrict__ Qw,
                         const uint32_t* __restrict__ Aw,
                         const int32_t* __restrict__ sizes,
                         const float* __restrict__ conf,
                         float* __restrict__ out, int B, int R, int W) {
  __shared__ __align__(16) uint32_t sQ[kQueries][kWords];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < R;
  const uint4* arow =
      reinterpret_cast<const uint4*>(Aw + static_cast<size_t>(live ? r : 0) * W);
  const int size = live ? sizes[r] : -1;
  const float c = live ? conf[r] : 0.0f;

  for (int q0 = blockIdx.y * kQueries; q0 < B; q0 += gridDim.y * kQueries) {
    const int nq = min(kQueries, B - q0);
    int dot[kQueries];
#pragma unroll
    for (int b = 0; b < kQueries; ++b) dot[b] = 0;

    for (int w0 = 0; w0 < W; w0 += kWords) {
      const int nquad = min(kWords, W - w0) / 4;
      uint4 a[kQuads];
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
        a[q] = q < nquad ? __ldg(arow + w0 / 4 + q) : make_uint4(0, 0, 0, 0);

      __syncthreads();  // the previous stage has been read
      for (int i = threadIdx.x; i < kQueries * kQuads; i += kThreads) {
        const int b = i / kQuads, q = i % kQuads;
        uint4 x = make_uint4(0, 0, 0, 0);
        if (b < nq && q < nquad)
          x = __ldg(reinterpret_cast<const uint4*>(
                        Qw + static_cast<size_t>(q0 + b) * W + w0) + q);
        reinterpret_cast<uint4*>(sQ[b])[q] = x;
      }
      __syncthreads();

#pragma unroll
      for (int b = 0; b < kQueries; ++b) {
        const uint4* qrow = reinterpret_cast<const uint4*>(sQ[b]);
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const uint4 t = qrow[q];
          dot[b] += __popc(t.x & a[q].x) + __popc(t.y & a[q].y) +
                    __popc(t.z & a[q].z) + __popc(t.w & a[q].w);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int b = 0; b < kQueries; ++b)
        if (b < nq)
          out[static_cast<size_t>(q0 + b) * R + r] =
              static_cast<float>(dot[b] == size) * c;
    }
  }
}

}  // namespace

extern "C" int rule_match_packed_launch(const void* Qw, const void* Aw,
                                        const void* sizes, const void* conf,
                                        void* out, int B, int R, int W,
                                        void* stream) {
  const int grid_x = (R + kThreads - 1) / kThreads;
  const int grid_y = std::min(65535, (B + kQueries - 1) / kQueries);
  rule_match_packed_kernel<<<dim3(grid_x, grid_y), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(Qw), static_cast<const uint32_t*>(Aw),
      static_cast<const int32_t*>(sizes), static_cast<const float*>(conf),
      static_cast<float*>(out), B, R, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
