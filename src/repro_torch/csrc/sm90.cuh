// Hopper (sm_90a) building blocks of the port's TMA and wgmma kernels:
// the flash attention forward and backward (through attention_sm90.cuh,
// which adds their 4-d TMA loads, descriptors, maps and bf16 wgmma) and
// wkv6.cu (with its own 3-d TMA loads and maps) take the mbarrier, fence
// and tensor-map helpers; the
// integer wgmma kernels, rule_match_int8.cu and rule_match_packed.cu
// (through rule_match_wgmma.cuh) and support_count_int8.cu and
// support_count_packed.cu (through support_count_wgmma.cuh), take all of
// it.
//
// - mbarriers and TMA: one thread copies a 2-d box of a tensor map into
//   shared memory and the copy completes its bytes on an mbarrier;
// - wgmma operand descriptors for K-major tiles in 128-byte swizzle: rows
//   of 128 bytes (a TMA box 128 bytes wide), 8-row groups 1,024 bytes
//   apart;
// - wgmma m64nNk32 s8 x s8 -> s32 (wgmma_s8) and m64nNk256 b1 AND-popc ->
//   s32 (wgmma_b1).  A k32 s8 step and a k256 b1 step both read 32 bytes
//   of a row, so one descriptor, advanced 32 bytes a step, serves both,
//   and wgmma_step picks the instruction from a template flag;
// - libcuda's cuTensorMapEncodeTiled, found through the runtime, so
//   the libraries need no link against libcuda.

#pragma once

#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>

namespace {

constexpr int kSlab = 128;        // bytes a swizzled row (a TMA box) holds

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 2-d tensor map (coordinates innermost first) into shared
// memory, completing its bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma operand descriptor for a K-major, 128-byte-swizzled tile: rows of
// 128 bytes, 8-row groups 1,024 bytes apart; layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// returns once at most `Pending` committed groups are still running
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[N/2] (+)= A[64 x 32 bytes] . B[32 bytes x N] with s32 accumulators, A
// and B K-major in shared memory; d is overwritten where accumulate is 0.
// wgmma_s8: int8 x int8 over 32 items; wgmma_b1: popc(a & b) over 256
// bits.  Accumulator 4j + e of a thread in warp w (lane = 4g + t) is row
// 16w + g + 8(e / 2), column 8j + 2t + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_b1(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

#define REPRO_WGMMA_INT_N8(NAME, OP)                                          \
  template <>                                                                 \
  __device__ __forceinline__ void NAME<8>(int(&d)[4], uint64_t a,             \
                                           uint64_t b, int accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n" OP " {"                   \
        "%0, %1, %2, %3"                                                      \
        "}, %4, %5, p;\n}\n"                                                  \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                      \
        : "l"(a), "l"(b), "r"(accumulate));                                   \
  }

#define REPRO_WGMMA_INT_N16(NAME, OP)                                         \
  template <>                                                                 \
  __device__ __forceinline__ void NAME<16>(int(&d)[8], uint64_t a,            \
                                           uint64_t b, int accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" OP " {"                  \
        "%0, %1, %2, %3, %4, %5, %6, %7"                                      \
        "}, %8, %9, p;\n}\n"                                                  \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),         \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])                                  \
        : "l"(a), "l"(b), "r"(accumulate));                                   \
  }

#define REPRO_WGMMA_INT_N32(NAME, OP)                                         \
  template <>                                                                 \
  __device__ __forceinline__ void NAME<32>(int(&d)[16], uint64_t a,           \
                                           uint64_t b, int accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" OP " {"                  \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
        "%14, %15"                                                            \
        "}, %16, %17, p;\n}\n"                                                \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),         \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),         \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),                 \
          "+r"(d[14]), "+r"(d[15])                                            \
        : "l"(a), "l"(b), "r"(accumulate));                                   \
  }

#define REPRO_WGMMA_INT_N64(NAME, OP)                                         \
  template <>                                                                 \
  __device__ __forceinline__ void NAME<64>(int(&d)[32], uint64_t a,           \
                                           uint64_t b, int accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" OP " {"                  \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
        "%26, %27, %28, %29, %30, %31"                                        \
        "}, %32, %33, p;\n}\n"                                                \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),         \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),         \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),                 \
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),                 \
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),                 \
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),                 \
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),                 \
          "+r"(d[30]), "+r"(d[31])                                            \
        : "l"(a), "l"(b), "r"(accumulate));                                   \
  }

#define REPRO_WGMMA_INT_N128(NAME, OP)                                        \
  template <>                                                                 \
  __device__ __forceinline__ void NAME<128>(int(&d)[64], uint64_t a,          \
                                           uint64_t b, int accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" OP " {"                  \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
        "%62, %63"                                                            \
        "}, %64, %65, p;\n}\n"                                                \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),         \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),         \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),                 \
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),                 \
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),                 \
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),                 \
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),                 \
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),                 \
          "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),                 \
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),                 \
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),                 \
          "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),                 \
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),                 \
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),                 \
          "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),                 \
          "+r"(d[62]), "+r"(d[63])                                            \
        : "l"(a), "l"(b), "r"(accumulate));                                   \
  }

#define REPRO_WGMMA_INT_N256(NAME, OP)                                        \
  template <>                                                                 \
  __device__ __forceinline__ void NAME<256>(int(&d)[128], uint64_t a,         \
                                           uint64_t b, int accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" OP " {"                 \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "        \
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "        \
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "        \
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "          \
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "        \
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"          \
        "}, %128, %129, p;\n}\n"                                              \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),         \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),         \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),                 \
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),                 \
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),                 \
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),                 \
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),                 \
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),                 \
          "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),                 \
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),                 \
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),                 \
          "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),                 \
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),                 \
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),                 \
          "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),                 \
          "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),                 \
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),                 \
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),                 \
          "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),                 \
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]),                 \
          "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),                 \
          "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),                 \
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]),                 \
          "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),                 \
          "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),               \
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),             \
          "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),             \
          "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),             \
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]),             \
          "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),             \
          "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),             \
          "+r"(d[126]), "+r"(d[127])                                          \
        : "l"(a), "l"(b), "r"(accumulate));                                   \
  }

#define REPRO_WGMMA_INT(N)                                                    \
  REPRO_WGMMA_INT_N##N(wgmma_s8,                                              \
                       "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8") \
  REPRO_WGMMA_INT_N##N(wgmma_b1, "wgmma.mma_async.sync.aligned.m64n" #N       \
                                 "k256.s32.b1.b1.and.popc")

REPRO_WGMMA_INT(8)
REPRO_WGMMA_INT(16)
REPRO_WGMMA_INT(32)
REPRO_WGMMA_INT(64)
REPRO_WGMMA_INT(128)
REPRO_WGMMA_INT(256)

// d (+)= one 32-byte step of A and B: the int8 product (kBits false) or
// the AND-popcount of 256 bits (kBits true)
template <int N, bool kBits>
__device__ __forceinline__ void wgmma_step(int (&d)[N / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (kBits) {
    wgmma_b1<N>(d, a, b, 1);
  } else {
    wgmma_s8<N>(d, a, b, 1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point query so the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a [rows, row_bytes] byte matrix read in boxes of 128 bytes x box_rows
// rows, 128-byte swizzled; rows past `rows` and bytes past row_bytes read
// as zeros (row_bytes % 16 == 0, ptr 16-byte aligned)
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int rows, int row_bytes, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {kSlab, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
