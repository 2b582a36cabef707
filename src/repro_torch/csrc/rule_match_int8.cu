// Int8 tensor-core rule matching for Hopper (sm_90a).
//
// Replaces the TPU kernel rule_scores_pallas
// (src/repro/kernels/rule_match/kernel.py:72), which runs the antecedent
// containment test as an int8 matmul on the matrix unit:
//
//   out[b, r] = [ sum_i Q[b, i] * A[r, i] == sizes[r] ] * conf[r]
//
// Bound: bytes at the serving shapes (a batch of at most 64 queries against
// one read of the [R, I] antecedents, and the [B, R] float output written
// once); 2*B*R*I int8 operations against 1,979 dense TOP/s are smaller.
// At the serving shape [64 x 896 x 1,024] the bytes take 0.36 us, so what
// sets the time is latency: the launch, one trip to memory, the epilogue.
//
// Design.
// - wgmma m64nNk32 s8 x s8 -> s32 reads both operands from shared memory
//   by descriptor as rows contiguous in the item axis (K-major), which is
//   how the antecedents and the queries are stored, so either can be the
//   M operand (64 rows a warpgroup) and the other the N; the sum is exact
//   integer arithmetic.  wgmma, not mma.sync, because it needs no fragment
//   loads: a warpgroup's 64 x N tile over 128 items is four instructions.
// - Two layouts, each the faster at one of serving's two buckets
//   (tools/rule_match_int8_designs.py, medians of 9 rounds, NVIDIA H100
//   80GB HBM3, 700.00 W):
//   * queries on M and 32-rule tiles as N, when the batch is over 32 (a
//     bucket of 64 fills M) and those tiles fit in one wave: 0.00508 ms
//     at [64 x 896 x 1,024], against 0.00526 with the rules on M;
//   * otherwise rules on M and the batch, rounded up to 8, 16, 32 or 64,
//     as N, so that a bucket of 8 fills the instruction with no rows of
//     zeros: 0.00457 ms at [8 x 896 x 1,024], against 0.00517 with the
//     queries on M.
// - Loads: one thread issues TMA loads of 128-item slabs (128-byte rows,
//   128-byte swizzle) of both operands onto one mbarrier a slab, all of a
//   CTA's slabs at once when they fit in its ring of 8 stages (I <= 1,024
//   at one CTA a tile), so one memory latency is exposed, not I / 64.  A
//   longer item axis cycles the ring, refilled as each slab is consumed.
//   TMA's zero fill covers ragged B, R and I (I % 64 == 0 is enough).
// - Filling the card: a tile's item axis is split over a cluster of `cs`
//   CTAs (1, 2, 4 or 8).  Each CTA sums its slabs into int32 partials,
//   written to its own shared memory; after a cluster barrier each CTA
//   adds the cluster's partials for its 1/cs share of the tile through
//   distributed shared memory, compares, weights and stores it.  Exact,
//   and no atomics.  The shared operand is not multicast: each CTA of a
//   cluster reads another slice of the items.  At the serving shape 28
//   tiles x 4 = 112 CTAs each read 24 KB; at bucket 8, 14 x 8 = 112 CTAs
//   read 9 KB each.
// - Wide indexes: rules on M, two warpgroups a CTA (128 rules, one 64 x N
//   product each) sharing one query block, so each antecedent byte is read
//   once and the 64 queries once per 128 rules; 16,384 rules are 128 CTAs,
//   one wave.
// - The launch geometry (layout, warpgroups, N, cs) is the caller's:
//   kernels/rule_match/kernel.py's geometry() picks it.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.0052 ms at
// the serving shape, 0.0047 at bucket 8 and 0.0092 at 16,384 rules,
// against 0.0155, 0.0214 and 0.0240 for torch._int_mm plus the compare
// and weight (the kernel this one replaced: 0.0171-0.0175 at the serving
// shape, 0.0246 at 16,384 rules).  Without a cluster the serving shape
// takes 0.0073 ms with the queries on M, 0.0080 with the rules on M.
//
// Left: the launch itself is most of what remains (a CTA reads 9-24 KB,
// the bytes bound is 0.36 us).  A CUDA graph around serving's launches,
// or fusing the top-k into the epilogue so the [B, R] scores never reach
// device memory, are what could still move it.
//
// sizes are integral floats (-1 on padded rows, which a dot >= 0 never
// equals); the compare is exact below 2**24 items.  Q and A are
// contiguous, 16-byte aligned, I % 16 == 0 (the wrapper asks I % 64 == 0).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlab = 128;        // items (bytes) a swizzled row holds
constexpr int kMaxStages = 8;     // slabs in flight in a CTA's ring
constexpr int kPad = 4;           // ints of padding a partials row

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

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[N/2] (+)= A[64 x 32] . B[32 x N], s8 in, s32 accumulators, A and B
// K-major in shared memory; d is overwritten where accumulate is 0.
// Accumulator 4j + e of a thread in warp w (lane = 4g + t) is row
// 16w + g + 8(e / 2), column 8j + 2t + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[4], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// A CTA's tile: kM rows of the M operand (64 a warpgroup) by N rows of the
// N operand, over its cluster rank's share of the item slabs.
template <int WG, int N, bool kRulesOnM>
struct Tile {
  static constexpr int kM = 64 * WG;
  static constexpr int kRules = kRulesOnM ? kM : N;     // rules a tile
  static constexpr int kQueries = kRulesOnM ? N : kM;   // queries a tile
  static constexpr uint32_t kMBytes = kM * kSlab;
  static constexpr uint32_t kStageBytes = (kM + N) * kSlab;
  static constexpr uint32_t kPartialBytes = kQueries * (kRules + kPad) * 4;
};

template <int WG, int N, bool kRulesOnM>
size_t smem_bytes(int stages) {
  using T = Tile<WG, N, kRulesOnM>;
  const size_t ring = static_cast<size_t>(stages) * T::kStageBytes;
  // 1 KB to align the base to the swizzle atom, the ring (whose space the
  // partials reuse once it is drained), a barrier a stage
  return 1024 + (ring > T::kPartialBytes ? ring : T::kPartialBytes)
         + 8 * stages;
}

template <int WG, int N, bool kRulesOnM>
__global__ void __launch_bounds__(128 * WG, 1)
rule_match_int8_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_q,
                       const float* __restrict__ sizes,
                       const float* __restrict__ conf,
                       float* __restrict__ out, int B, int R, int I,
                       int stages) {
  using T = Tile<WG, N, kRulesOnM>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const size_t ring = static_cast<size_t>(stages) * T::kStageBytes;
  const uint32_t bars = base + static_cast<uint32_t>(
      ring > T::kPartialBytes ? ring : T::kPartialBytes);
  int* partial = reinterpret_cast<int*>(smem + (base - smem_u32(smem)));

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = (blockIdx.x / cs) * T::kRules;
  const int q0 = blockIdx.y * T::kQueries;
  const CUtensorMap* tm_m = kRulesOnM ? &tm_a : &tm_q;
  const CUtensorMap* tm_n = kRulesOnM ? &tm_q : &tm_a;
  const int m0 = kRulesOnM ? r0 : q0;
  const int n0 = kRulesOnM ? q0 : r0;

  // this rank's slabs of the item axis
  const int slabs = (I + kSlab - 1) / kSlab;
  const int s_begin = rank * slabs / cs;
  const int count = (rank + 1) * slabs / cs - s_begin;

  auto issue = [&](int i) {      // slab i of this CTA into stage i % stages
    const int s = i % stages;
    const uint32_t dst = base + s * T::kStageBytes;
    const uint32_t bar = bars + 8 * s;
    const int col = (s_begin + i) * kSlab;
    mbar_expect_tx(bar, T::kStageBytes);
    tma_load(dst, tm_m, bar, col, m0);
    tma_load(dst + T::kMBytes, tm_n, bar, col, n0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < count && i < stages; ++i) issue(i);

  // ---- products: each warpgroup its 64 rows of M -----------------------
  const int wg = threadIdx.x / 128;
  int acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0;
  for (int i = 0; i < count; ++i) {
    const int s = i % stages;
    mbar_wait(bars + 8 * s, (i / stages) & 1);
    const uint32_t a = base + s * T::kStageBytes + wg * 64 * kSlab;
    const uint32_t b = base + s * T::kStageBytes + T::kMBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 32; ++kk)
      wgmma_s8<N>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (i + stages < count) {    // uniform: the ring cycles
      __syncthreads();           // every warpgroup is done with stage s
      if (threadIdx.x == 0) issue(i + stages);
    }
  }

  // ---- partials: [queries][rules + kPad] int32 over the drained ring ---
  __syncthreads();
  {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int row = wg * 64 + 16 * warp + g + 8 * ((e % 4) / 2);
      const int col = 8 * (e / 4) + 2 * t + e % 2;
      const int q = kRulesOnM ? col : row;
      const int r = kRulesOnM ? row : col;
      partial[q * (T::kRules + kPad) + r] = acc[e];
    }
  }
  cluster.sync();                // every rank's partials are written

  // ---- epilogue: this rank's 1/cs of the tile, 4 rules a thread --------
  constexpr int kTotal = T::kQueries * T::kRules;
  const int share = kTotal / cs;
  const bool vec = (R % 4) == 0;
  for (int e = rank * share + 4 * threadIdx.x; e < (rank + 1) * share;
       e += 4 * blockDim.x) {
    const int q = e / T::kRules, r = e % T::kRules;
    const int query = q0 + q, rule = r0 + r;
    if (query >= B || rule >= R) continue;
    int* local = partial + q * (T::kRules + kPad) + r;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int c = 0; c < cs; ++c) {
      const int4 p = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(local, c));
      sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
    }
    const int dot[4] = {sum.x, sum.y, sum.z, sum.w};
    float* o = out + static_cast<size_t>(query) * R + rule;
    if (vec) {                   // rule % 4 == 0 and R % 4 == 0: aligned
      const float4 sz = *reinterpret_cast<const float4*>(sizes + rule);
      const float4 cf = *reinterpret_cast<const float4*>(conf + rule);
      *reinterpret_cast<float4*>(o) = make_float4(
          static_cast<float>(static_cast<float>(dot[0]) == sz.x) * cf.x,
          static_cast<float>(static_cast<float>(dot[1]) == sz.y) * cf.y,
          static_cast<float>(static_cast<float>(dot[2]) == sz.z) * cf.z,
          static_cast<float>(static_cast<float>(dot[3]) == sz.w) * cf.w);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (rule + x < R)
          o[x] = static_cast<float>(static_cast<float>(dot[x]) ==
                                    sizes[rule + x]) * conf[rule + x];
    }
  }
  cluster.sync();                // no rank leaves while others read it
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

// a [rows, I] int8 matrix read in boxes of 128 items x box_rows rows,
// 128-byte swizzled; rows past `rows` and items past I read as zeros
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int rows, int I, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(I),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(I)};
  const cuuint32_t box[2] = {kSlab, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void* Q;
  const void* A;
  const float* sizes;
  const float* conf;
  float* out;
  int B, R, I, cs;
  cudaStream_t stream;
};

template <int WG, int N, bool kRulesOnM>
int launch(const Args& a) {
  using T = Tile<WG, N, kRulesOnM>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_a, tm_q;
  if (!encode_map(encode, &tm_a, a.A, a.R, a.I, T::kRules) ||
      !encode_map(encode, &tm_q, a.Q, a.B, a.I, T::kQueries))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (a.I + kSlab - 1) / kSlab;
  const int per_cta = (slabs + a.cs - 1) / a.cs;
  const int stages = per_cta < kMaxStages ? (per_cta > 0 ? per_cta : 1)
                                          : kMaxStages;
  const size_t smem = smem_bytes<WG, N, kRulesOnM>(stages);
  auto kernel = rule_match_int8_kernel<WG, N, kRulesOnM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.R + T::kRules - 1) / T::kRules * a.cs,
                     (a.B + T::kQueries - 1) / T::kQueries);
  cfg.blockDim = dim3(128 * WG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_q, a.sizes, a.conf, a.out,
                           a.B, a.R, a.I, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Q [B, I] and A [R, I] int8, sizes and conf [R] float32, out [B, R]
// float32; all contiguous and 16-byte aligned, I % 16 == 0.  The geometry
// (kernels/rule_match/kernel.py's geometry()): rules_on_m with wg in {1, 2}
// warpgroups (64 rules each) and n in {8, 16, 32, 64} queries a tile, or
// queries on M with wg 1 (64 queries) and n = 32 rules a tile; cs in {1,
// 2, 4, 8} CTAs splitting the item axis.  Any other geometry is refused.
extern "C" int rule_match_int8_launch(const void* Q, const void* A,
                                      const void* sizes, const void* conf,
                                      void* out, int B, int R, int I,
                                      int rules_on_m, int wg, int n, int cs,
                                      void* stream) {
  if (cs != 1 && cs != 2 && cs != 4 && cs != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{Q, A, static_cast<const float*>(sizes),
               static_cast<const float*>(conf), static_cast<float*>(out),
               B, R, I, cs, static_cast<cudaStream_t>(stream)};
  if (rules_on_m && wg == 1) {
    switch (n) {
      case 8: return launch<1, 8, true>(a);
      case 16: return launch<1, 16, true>(a);
      case 32: return launch<1, 32, true>(a);
      case 64: return launch<1, 64, true>(a);
    }
  } else if (rules_on_m && wg == 2) {
    switch (n) {
      case 8: return launch<2, 8, true>(a);
      case 16: return launch<2, 16, true>(a);
      case 32: return launch<2, 32, true>(a);
      case 64: return launch<2, 64, true>(a);
    }
  } else if (!rules_on_m && wg == 1 && n == 32) {
    return launch<1, 32, false>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
