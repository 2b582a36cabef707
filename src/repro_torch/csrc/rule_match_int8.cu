// Int8 tensor-core rule matching for Hopper (sm_90a).
//
// Replaces the TPU kernel rule_scores_pallas
// (src/repro/kernels/rule_match/kernel.py), which runs the antecedent
// containment test as an int8 matmul on the matrix unit:
//
//   out[b, r] = [ sum_i Q[b, i] * A[r, i] == sizes[r] ] * conf[r]
//
// Bound: bytes at the serving shapes (a batch of at most 64 queries against
// one read of the [R, I] antecedents, and the [B, R] float output written
// once); 2*B*R*I int8 operations against 1,979 dense TOP/s are smaller.
// Design: mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores (integer
// accumulation, exact), with the compare against sizes and the conf weight in
// the epilogue, so no [B, R] integer matrix reaches device memory.  A block
// of 4 warps owns 16 queries x 64 rules (each warp 16 x 16: two mma tiles)
// and walks the item axis 64 bytes at a time through shared memory, whose row
// stride of 80 bytes puts the 32 lanes' fragment loads on 32 distinct banks.
// Serving pads B to 8, not 16: rows of the m16 fragment past B are staged as
// zeros and never stored.  Each output element has one owner, so there are
// no atomics.  TMA and wgmma are left for a later change.
//
// sizes are integral floats (-1 on padded rows, which a dot >= 0 never
// equals); the compare is exact below 2**24 items.  The caller passes
// I % 64 == 0 with Q and A 16-byte aligned (rows are staged as int4).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 16;         // queries per block tile (one m16 fragment)
constexpr int kBN = 64;         // rules per block tile
constexpr int kBK = 64;         // items (bytes) per shared-memory stage
constexpr int kLds = kBK + 16;  // padded row stride in bytes
constexpr int kThreads = 128;   // 4 warps side by side along the rules
constexpr int kWarpN = kBN / 4; // rules per warp: two n8 tiles

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
rule_match_int8_kernel(const int8_t* __restrict__ Q,
                       const int8_t* __restrict__ A,
                       const float* __restrict__ sizes,
                       const float* __restrict__ conf,
                       float* __restrict__ out, int B, int R, int I) {
  __shared__ __align__(16) int8_t sQ[kBM * kLds];
  __shared__ __align__(16) int8_t sA[kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread-in-group
  const int col0 = blockIdx.x * kBN;

  // this lane's epilogue columns: n-tile ni, column 2t + j
  float size_of[2][2], conf_of[2][2];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + warp * kWarpN + ni * 8 + 2 * t + j;
      size_of[ni][j] = c < R ? sizes[c] : -1.0f;
      conf_of[ni][j] = c < R ? conf[c] : 0.0f;
    }

  for (int row0 = blockIdx.y * kBM; row0 < B; row0 += gridDim.y * kBM) {
    int acc[2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0;

    for (int k0 = 0; k0 < I; k0 += kBK) {
      __syncthreads();  // the previous stage has been read
      for (int i = tid; i < kBM * kBK / 16; i += kThreads) {
        const int r = i / (kBK / 16), v = i % (kBK / 16);
        int4 x = make_int4(0, 0, 0, 0);
        if (row0 + r < B)
          x = __ldg(reinterpret_cast<const int4*>(
              Q + static_cast<size_t>(row0 + r) * I + k0 + v * 16));
        *reinterpret_cast<int4*>(sQ + r * kLds + v * 16) = x;
      }
      for (int i = tid; i < kBN * kBK / 16; i += kThreads) {
        const int r = i / (kBK / 16), v = i % (kBK / 16);
        int4 x = make_int4(0, 0, 0, 0);
        if (col0 + r < R)
          x = __ldg(reinterpret_cast<const int4*>(
              A + static_cast<size_t>(col0 + r) * I + k0 + v * 16));
        *reinterpret_cast<int4*>(sA + r * kLds + v * 16) = x;
      }
      __syncthreads();

#pragma unroll
      for (int ks = 0; ks < kBK; ks += 32) {
        // A operand (16 x 32 queries, row-major): a0/a1 rows g/g+8 at k
        // 4t..4t+3, a2/a3 the same rows at k 16+4t..; B operand (32 x 8,
        // column-major, i.e. a rule row of A): b0 at k 4t.., b1 at
        // k 16+4t.., column g
        uint32_t a[4], b[2][2];
        const int8_t* p = sQ + g * kLds + ks + 4 * t;
        a[0] = ld32(p);
        a[1] = ld32(p + 8 * kLds);
        a[2] = ld32(p + 16);
        a[3] = ld32(p + 8 * kLds + 16);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int8_t* q = sA + (warp * kWarpN + ni * 8 + g) * kLds + ks + 4 * t;
          b[ni][0] = ld32(q);
          b[ni][1] = ld32(q + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_s8(acc[ni], a, b[ni]);
      }
    }

    // epilogue: d0/d1 are row g, columns 2t/2t+1; d2/d3 are row g+8
    const int rlo = row0 + g, rhi = row0 + g + 8;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + warp * kWarpN + ni * 8 + 2 * t + j;
        if (c >= R) continue;
        if (rlo < B)
          out[static_cast<size_t>(rlo) * R + c] =
              static_cast<float>(static_cast<float>(acc[ni][j]) ==
                                 size_of[ni][j]) * conf_of[ni][j];
        if (rhi < B)
          out[static_cast<size_t>(rhi) * R + c] =
              static_cast<float>(static_cast<float>(acc[ni][2 + j]) ==
                                 size_of[ni][j]) * conf_of[ni][j];
      }
  }
}

}  // namespace

extern "C" int rule_match_int8_launch(const void* Q, const void* A,
                                      const void* sizes, const void* conf,
                                      void* out, int B, int R, int I,
                                      void* stream) {
  const int grid_x = (R + kBN - 1) / kBN;
  const int grid_y = std::min(65535, (B + kBM - 1) / kBM);
  rule_match_int8_kernel<<<dim3(grid_x, grid_y), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(Q), static_cast<const int8_t*>(A),
      static_cast<const float*>(sizes), static_cast<const float*>(conf),
      static_cast<float*>(out), B, R, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
