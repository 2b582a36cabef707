// Packed-popcount support counting for Hopper (sm_90a).
//
// Replaces the TPU kernel support_count_fused_pallas
// (src/repro/kernels/support_count/fused.py):
//
//   out[m] += #{ t : sum_w popc(Tw[t, w] & Cw[m, w]) == sizes[m] }
//
// Bound: operations.  N*M*W AND+popcount+add triples run against 16
// popcounts per clock per SM, while each word of Tw and Cw need only be read
// once.  Design: one thread owns one candidate and keeps 32 of its words in
// registers; a block of 128 candidates stages 32 transaction rows x 32 words
// in shared memory, where every thread of a warp reads the same 16 bytes (a
// broadcast), so one shared load feeds four popcounts and one candidate word
// feeds 32.  The TPU grid revisits an output block along its sequential
// transaction axis; CUDA blocks run in no order, so a block owns a candidate
// slice and a chunk of transactions and atomically adds its int32 partial
// counts.  Integer atomics commute: the result is exact and deterministic.
//
// The caller zeroes `out`, and passes W % 4 == 0 with Tw and Cw 16-byte
// aligned (the words are read as uint4).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // candidates per block, one per thread
constexpr int kRows = 32;      // transaction rows per shared-memory stage
constexpr int kWords = 32;     // words per stage (candidate words in registers)
constexpr int kQuads = kWords / 4;

__global__ void __launch_bounds__(kThreads)
support_count_packed_kernel(const uint32_t* __restrict__ Tw,
                            const uint32_t* __restrict__ Cw,
                            const int32_t* __restrict__ sizes,
                            int32_t* __restrict__ out,
                            int N, int M, int W, int rows_per_block) {
  __shared__ __align__(16) uint32_t sT[kRows][kWords];

  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  // a dot is >= 0, so a dead lane's -1 never matches
  const int size = live ? sizes[m] : -1;
  const uint4* crow =
      reinterpret_cast<const uint4*>(Cw + static_cast<size_t>(live ? m : 0) * W);
  int hits = 0;

  for (int chunk0 = blockIdx.y * rows_per_block; chunk0 < N;
       chunk0 += gridDim.y * rows_per_block) {
    const int chunk_end = min(N, chunk0 + rows_per_block);
    for (int r0 = chunk0; r0 < chunk_end; r0 += kRows) {
      const int nr = min(kRows, chunk_end - r0);
      int dot[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot[r] = 0;

      for (int w0 = 0; w0 < W; w0 += kWords) {
        const int nq = min(kWords, W - w0) / 4;
        uint4 c[kQuads];
#pragma unroll
        for (int q = 0; q < kQuads; ++q)
          c[q] = q < nq ? __ldg(crow + w0 / 4 + q) : make_uint4(0, 0, 0, 0);

        __syncthreads();  // the previous stage has been read
        for (int i = threadIdx.x; i < kRows * kQuads; i += kThreads) {
          const int r = i / kQuads, q = i % kQuads;
          uint4 x = make_uint4(0, 0, 0, 0);
          if (r < nr && q < nq)
            x = __ldg(reinterpret_cast<const uint4*>(
                          Tw + static_cast<size_t>(r0 + r) * W + w0) + q);
          reinterpret_cast<uint4*>(sT[r])[q] = x;
        }
        __syncthreads();

#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const uint4* trow = reinterpret_cast<const uint4*>(sT[r]);
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            const uint4 t = trow[q];
            dot[r] += __popc(t.x & c[q].x) + __popc(t.y & c[q].y) +
                      __popc(t.z & c[q].z) + __popc(t.w & c[q].w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) hits += (r < nr) & (dot[r] == size);
    }
  }
  if (live && hits) atomicAdd(out + m, hits);
}

}  // namespace

extern "C" int support_count_packed_launch(const void* Tw, const void* Cw,
                                           const void* sizes, void* out,
                                           int N, int M, int W,
                                           void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int grid_x = (M + kThreads - 1) / kThreads;
  // enough blocks to fill every SM several times over: split the
  // transactions into chunks of whole stages
  const int want_y = std::max(1, (std::max(sms, 1) * 8 + grid_x - 1) / grid_x);
  int rows_per_block = (N + want_y - 1) / want_y;
  rows_per_block =
      std::max(kRows, (rows_per_block + kRows - 1) / kRows * kRows);
  const int grid_y =
      std::min(65535, (N + rows_per_block - 1) / rows_per_block);
  support_count_packed_kernel<<<dim3(grid_x, grid_y), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(Tw), static_cast<const uint32_t*>(Cw),
      static_cast<const int32_t*>(sizes), static_cast<int32_t*>(out), N, M, W,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
