// Int8 tensor-core support counting for Hopper (sm_90a).
//
// Replaces the TPU kernel support_count_pallas
// (src/repro/kernels/support_count/kernel.py), which runs the containment
// test as an int8 matmul on the matrix unit:
//
//   out[m] += sum_t [ sum_i T[t, i] * C[m, i] == sizes[m] ]
//
// Bound: operations.  2*N*M*I int8 operations against 1,979 dense TOP/s; the
// bytes are one read of T [N, I] and C [M, I].  Design: mma.sync m16n8k32
// s8 x s8 -> s32 on the tensor cores (integer accumulation, exact), with the
// compare against sizes and the sum over transactions in the epilogue, so
// the [N, M] dot matrix never leaves registers.  A block of 4 warps owns 64
// transactions x 128 candidates (each warp 32 x 64: 2 x 8 mma tiles) and
// walks the item axis 64 bytes at a time through shared memory, whose row
// stride of 80 bytes puts the 32 lanes' fragment loads on 32 distinct banks.
// Blocks run in no order; each folds its hits per candidate in shared memory
// and atomically adds them to `out` (integer atomics commute: exact).  A
// block loops over transaction tiles when N needs more than 65535 of them.
// TMA and wgmma are left for a later change.
//
// The caller zeroes `out`, and passes I % 64 == 0 with T and C 16-byte
// aligned (rows are staged as int4).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 64;         // transactions per block tile
constexpr int kBM = 128;        // candidates per block tile
constexpr int kBK = 64;         // items (bytes) per shared-memory stage
constexpr int kLds = kBK + 16;  // padded row stride in bytes
constexpr int kThreads = 128;   // 4 warps: 2 (transactions) x 2 (candidates)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
support_count_int8_kernel(const int8_t* __restrict__ T,
                          const int8_t* __restrict__ C,
                          const int32_t* __restrict__ sizes,
                          int32_t* __restrict__ out, int N, int M, int I) {
  __shared__ __align__(16) int8_t sT[kBN * kLds];
  __shared__ __align__(16) int8_t sC[kBM * kLds];
  __shared__ int s_hits[kBM];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread-in-group
  const int wm = warp >> 1;               // rows wm*32 .. +32 of the tile
  const int wn = warp & 1;                // columns wn*64 .. +64 of the tile
  const int col0 = blockIdx.x * kBM;

  s_hits[tid] = 0;  // kThreads == kBM

  // this lane's epilogue columns: n-tile ni, column 2t + j; a dot is >= 0,
  // so the -1 of a column past M never matches
  int size_of[8][2];
  int hits[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + wn * 64 + ni * 8 + 2 * t + j;
      size_of[ni][j] = c < M ? sizes[c] : -1;
      hits[ni][j] = 0;
    }

  for (int row0 = blockIdx.y * kBN; row0 < N; row0 += gridDim.y * kBN) {
    int acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    for (int k0 = 0; k0 < I; k0 += kBK) {
      __syncthreads();  // the previous stage has been read
      for (int i = tid; i < kBN * kBK / 16; i += kThreads) {
        const int r = i / (kBK / 16), v = i % (kBK / 16);
        int4 x = make_int4(0, 0, 0, 0);
        if (row0 + r < N)
          x = __ldg(reinterpret_cast<const int4*>(
              T + static_cast<size_t>(row0 + r) * I + k0 + v * 16));
        *reinterpret_cast<int4*>(sT + r * kLds + v * 16) = x;
      }
      for (int i = tid; i < kBM * kBK / 16; i += kThreads) {
        const int r = i / (kBK / 16), v = i % (kBK / 16);
        int4 x = make_int4(0, 0, 0, 0);
        if (col0 + r < M)
          x = __ldg(reinterpret_cast<const int4*>(
              C + static_cast<size_t>(col0 + r) * I + k0 + v * 16));
        *reinterpret_cast<int4*>(sC + r * kLds + v * 16) = x;
      }
      __syncthreads();

#pragma unroll
      for (int ks = 0; ks < kBK; ks += 32) {
        // A (16 x 32, row-major): a0/a1 rows g/g+8 at k 4t..4t+3,
        // a2/a3 the same rows at k 16+4t..; B (32 x 8, column-major, i.e.
        // a candidate row of C): b0 at k 4t.., b1 at k 16+4t.., column g
        uint32_t a[2][4], b[8][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int8_t* p = sT + (wm * 32 + mi * 16 + g) * kLds + ks + 4 * t;
          a[mi][0] = ld32(p);
          a[mi][1] = ld32(p + 8 * kLds);
          a[mi][2] = ld32(p + 16);
          a[mi][3] = ld32(p + 8 * kLds + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int8_t* q = sC + (wn * 64 + ni * 8 + g) * kLds + ks + 4 * t;
          b[ni][0] = ld32(q);
          b[ni][1] = ld32(q + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
    }

    // epilogue: d0/d1 are row g, columns 2t/2t+1; d2/d3 are row g+8
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = row0 + wm * 32 + mi * 16 + g;
      const bool lo = r < N, hi = r + 8 < N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          hits[ni][j] += (lo & (acc[mi][ni][j] == size_of[ni][j])) +
                         (hi & (acc[mi][ni][2 + j] == size_of[ni][j]));
    }
  }

  __syncthreads();  // s_hits is zeroed even when I == 0 skipped the stages
  // sum over the 8 groups g (lane bits 2..4) that share a column
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int h = hits[ni][j];
      h += __shfl_xor_sync(0xffffffffu, h, 4);
      h += __shfl_xor_sync(0xffffffffu, h, 8);
      h += __shfl_xor_sync(0xffffffffu, h, 16);
      if (g == 0 && h) atomicAdd(&s_hits[wn * 64 + ni * 8 + 2 * t + j], h);
    }
  __syncthreads();
  const int c = col0 + tid;
  if (c < M && s_hits[tid]) atomicAdd(out + c, s_hits[tid]);
}

}  // namespace

extern "C" int support_count_int8_launch(const void* T, const void* C,
                                         const void* sizes, void* out, int N,
                                         int M, int I, void* stream) {
  const int grid_x = (M + kBM - 1) / kBM;
  const int grid_y = std::min(65535, (N + kBN - 1) / kBN);
  support_count_int8_kernel<<<dim3(grid_x, grid_y), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(T), static_cast<const int8_t*>(C),
      static_cast<const int32_t*>(sizes), static_cast<int32_t*>(out), N, M, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
