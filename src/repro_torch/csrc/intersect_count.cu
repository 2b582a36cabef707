// Row-aligned AND-popcount of two tid-slabs (the Eclat primitive), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel intersect_count_pallas
// (src/repro/kernels/support_count/intersect.py):
//
//   out[m] = sum_w popc(A[m, w] & B[m, w])
//
// Bound: bytes.  Each word of A and B is read once for one AND+popcount+add,
// so 2*M*W*4 bytes move for M*W popcounts: at the dense path's [128, 3200]
// tile that is 0.98 us at 3.35 TB/s against 0.10 us of popcounts.  The TPU
// grid revisits a [1, bm] output block along its sequential word axis; CUDA
// blocks run in no order, so the kernel is output-stationary instead: one
// owner per row (a block of 256 threads, or a warp where the row is short)
// walks the whole row and stores its int32 once, with no atomics, so the
// result is deterministic.  Neighbouring threads load neighbouring 16-byte
// uint4s of both slabs (coalesced), popcount the four ANDed words, and the
// row's partial sums meet through warp shuffles and, in a block, one
// shared-memory step.
//
// The caller passes W % 4 == 0 with A and B 16-byte aligned (the words are
// read as uint4).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows of at most this many uint4 go to one warp each (4 loads a lane);
// longer rows get a whole block
constexpr int kWarpRowQuads = 128;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int kThreadsPerRow>
__global__ void __launch_bounds__(kThreads)
intersect_count_kernel(const uint4* __restrict__ A,
                       const uint4* __restrict__ B,
                       int32_t* __restrict__ out, int M, int Q) {
  constexpr int kRowsPerBlock = kThreads / kThreadsPerRow;
  const int lane = threadIdx.x % kThreadsPerRow;
  const int m = blockIdx.x * kRowsPerBlock + threadIdx.x / kThreadsPerRow;
  int sum = 0;
  if (m < M) {
    const uint4* a = A + static_cast<size_t>(m) * Q;
    const uint4* b = B + static_cast<size_t>(m) * Q;
#pragma unroll 4
    for (int q = lane; q < Q; q += kThreadsPerRow) {
      const uint4 x = __ldg(a + q);
      const uint4 y = __ldg(b + q);
      sum += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
             __popc(x.w & y.w);
    }
  }
  // every lane of a warp reaches the shuffles: a warp never straddles rows
  sum = warp_sum(sum);
  if constexpr (kThreadsPerRow == 32) {
    if (lane == 0 && m < M) out[m] = sum;
  } else {
    __shared__ int partial[kWarps];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) partial[warp] = sum;
    __syncthreads();
    if (warp == 0) {
      sum = warp_sum(threadIdx.x < kWarps ? partial[threadIdx.x] : 0);
      if (threadIdx.x == 0 && m < M) out[m] = sum;
    }
  }
}

}  // namespace

extern "C" int intersect_count_launch(const void* A, const void* B, void* out,
                                      int M, int W, void* stream) {
  const int Q = W / 4;
  const auto* a = static_cast<const uint4*>(A);
  const auto* b = static_cast<const uint4*>(B);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (Q <= kWarpRowQuads) {
    intersect_count_kernel<32><<<(M + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        a, b, o, M, Q);
  } else {
    intersect_count_kernel<kThreads><<<M, kThreads, 0, s>>>(a, b, o, M, Q);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
