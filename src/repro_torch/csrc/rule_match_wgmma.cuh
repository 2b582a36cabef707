// The rule-match kernel of rule_match_int8.cu and rule_match_packed.cu:
//
//   out[b, r] = [ dot(Q[b], A[r]) == sizes[r] ] * conf[r]
//
// where dot is an int8 product over items (kBits false: Q [B, I] and A
// [R, I] int8, sizes float32) or an AND-popcount over packed bits (kBits
// true: Q [B, W] and A [R, W] int32 words, read as 4W bytes, sizes
// int32).  Both are one integer wgmma a 32-byte step of a row, so
// everything but the instruction and the type of sizes is shared; each
// source's header says what bounds its kernel and why this design.
//
// - wgmma m64nNk32 s8 (or m64nNk256 b1 AND-popc) reads both operands from
//   shared memory by descriptor as rows contiguous in the item axis
//   (K-major), how the antecedents and the queries are stored, so either
//   can be the M operand (64 rows a warpgroup) and the other the N.
// - Loads: one thread issues TMA loads of 128-byte slabs (128-byte
//   swizzle) of both operands onto one mbarrier a slab, all of a CTA's
//   slabs at once when they fit in its ring of 8 stages, so one memory
//   latency is exposed; a longer row cycles the ring, refilled as each
//   slab is consumed.  TMA's zero fill covers ragged B, R and row bytes.
// - A tile's row bytes can be split over a cluster of `cs` CTAs (1, 2, 4
//   or 8).  Each CTA sums its slabs into int32 partials, written to its
//   own shared memory; after a cluster barrier each CTA adds the
//   cluster's partials for its 1/cs share of the tile through distributed
//   shared memory, compares, weights and stores it.  Exact, no atomics.
//   Without a cluster each thread compares, weights and stores its own
//   accumulators, with its rules' sizes and confidences loaded while the
//   slabs land, so only the one trip to memory is exposed.
// - The launch geometry (which operand is M, warpgroups, N, cs) is the
//   caller's.
//
// Q and A are contiguous and 16-byte aligned with rows of a multiple of
// 16 bytes; sizes are -1 on padded rows, which a dot >= 0 never equals.

#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxStages = 8;     // slabs in flight in a CTA's ring
constexpr int kPad = 4;           // ints of padding a partials row

// A CTA's tile: kM rows of the M operand (64 a warpgroup) by N rows of the
// N operand, over its cluster rank's share of the slabs.
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

// sizes are float32 for the int8 product, int32 for the packed bits
template <bool kBits>
using SizeT = typename std::conditional<kBits, int, float>::type;

template <class S>
__device__ __forceinline__ float weight(int dot, S size, float conf) {
  return static_cast<float>(static_cast<S>(dot) == size) * conf;
}

template <int WG, int N, bool kRulesOnM, bool kBits>
__global__ void __launch_bounds__(128 * WG, 1)
rule_match_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_q,
                  const SizeT<kBits>* __restrict__ sizes,
                  const float* __restrict__ conf, float* __restrict__ out,
                  int B, int R, int row_bytes, int stages) {
  using T = Tile<WG, N, kRulesOnM>;
  using S = SizeT<kBits>;
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

  // this rank's slabs of the row
  const int slabs = (row_bytes + kSlab - 1) / kSlab;
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
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(tm_m)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(tm_n)) : "memory");
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < count && i < stages; ++i) issue(i);

  // Without a cluster a thread stores its own accumulators: the sizes and
  // confidences of its rules (2 rows of M, or N / 4 columns) are loaded
  // while the slabs land.  Accumulator e's rule is entry x(e) of them.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr int kMine = kRulesOnM ? 2 : N / 4;
  S my_size[kMine];
  float my_conf[kMine];
  if (cs == 1) {
#pragma unroll
    for (int x = 0; x < kMine; ++x) {
      const int rule = r0 + (kRulesOnM ? wg * 64 + 16 * warp + g + 8 * x
                                       : 8 * (x / 2) + 2 * t + x % 2);
      my_size[x] = rule < R ? sizes[rule] : static_cast<S>(-1);
      my_conf[x] = rule < R ? conf[rule] : 0.0f;
    }
  }

  // ---- products: each warpgroup its 64 rows of M -----------------------
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
      wgmma_step<N, kBits>(acc, smem_desc(a + 32 * kk),
                           smem_desc(b + 32 * kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (i + stages < count) {    // uniform: the ring cycles
      __syncthreads();           // every warpgroup is done with stage s
      if (threadIdx.x == 0) issue(i + stages);
    }
  }

  if (cs == 1) {                 // uniform: the launch's cluster size
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int row = wg * 64 + 16 * warp + g + 8 * ((e % 4) / 2);
      const int col = 8 * (e / 4) + 2 * t + e % 2;
      const int query = q0 + (kRulesOnM ? col : row);
      const int rule = r0 + (kRulesOnM ? row : col);
      const int x = kRulesOnM ? (e % 4) / 2 : 2 * (e / 4) + e % 2;
      if (query < B && rule < R)
        out[static_cast<size_t>(query) * R + rule] =
            weight(acc[e], my_size[x], my_conf[x]);
    }
    return;
  }

  // ---- partials: [queries][rules + kPad] int32 over the drained ring ---
  __syncthreads();
  {
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
      const int4 sz = *reinterpret_cast<const int4*>(sizes + rule);
      const float4 cf = *reinterpret_cast<const float4*>(conf + rule);
      const int bits[4] = {sz.x, sz.y, sz.z, sz.w};
      S s4[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if constexpr (kBits) {
          s4[x] = bits[x];
        } else {
          s4[x] = __int_as_float(bits[x]);
        }
      }
      *reinterpret_cast<float4*>(o) = make_float4(
          weight(dot[0], s4[0], cf.x), weight(dot[1], s4[1], cf.y),
          weight(dot[2], s4[2], cf.z), weight(dot[3], s4[3], cf.w));
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (rule + x < R)
          o[x] = weight(dot[x], sizes[rule + x], conf[rule + x]);
    }
  }
  cluster.sync();                // no rank leaves while others read it
}

struct RuleMatchArgs {
  const void* Q;
  const void* A;
  const void* sizes;
  const float* conf;
  float* out;
  int B, R, row_bytes, cs;
  cudaStream_t stream;
};

template <int WG, int N, bool kRulesOnM, bool kBits>
int launch_tile(const RuleMatchArgs& a) {
  using T = Tile<WG, N, kRulesOnM>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_a, tm_q;
  if (!encode_map(encode, &tm_a, a.A, a.R, a.row_bytes, T::kRules) ||
      !encode_map(encode, &tm_q, a.Q, a.B, a.row_bytes, T::kQueries))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (a.row_bytes + kSlab - 1) / kSlab;
  const int per_cta = (slabs + a.cs - 1) / a.cs;
  const int stages = per_cta < kMaxStages ? (per_cta > 0 ? per_cta : 1)
                                          : kMaxStages;
  const size_t smem = smem_bytes<WG, N, kRulesOnM>(stages);
  auto kernel = rule_match_kernel<WG, N, kRulesOnM, kBits>;
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
  err = cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_q,
                           static_cast<const SizeT<kBits>*>(a.sizes), a.conf,
                           a.out, a.B, a.R, a.row_bytes, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Every geometry of the kernel, as rule_match_int8.cu's launcher takes
// them (rule_match_packed.cu's instantiates only the tiles its geometry()
// picks): rules_on_m with wg in {1, 2} warpgroups (64 rules each) and n
// in {8, 16, 32, 64} queries a tile, or queries on M with wg 1 (64
// queries) and n = 32 rules a tile; cs in {1, 2, 4, 8} CTAs splitting the
// row.  Any other geometry is refused.
template <bool kBits>
int rule_match_launch(const RuleMatchArgs& a, int rules_on_m, int wg,
                      int n) {
  if (a.cs != 1 && a.cs != 2 && a.cs != 4 && a.cs != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rules_on_m && wg == 1) {
    switch (n) {
      case 8: return launch_tile<1, 8, true, kBits>(a);
      case 16: return launch_tile<1, 16, true, kBits>(a);
      case 32: return launch_tile<1, 32, true, kBits>(a);
      case 64: return launch_tile<1, 64, true, kBits>(a);
    }
  } else if (rules_on_m && wg == 2) {
    switch (n) {
      case 8: return launch_tile<2, 8, true, kBits>(a);
      case 16: return launch_tile<2, 16, true, kBits>(a);
      case 32: return launch_tile<2, 32, true, kBits>(a);
      case 64: return launch_tile<2, 64, true, kBits>(a);
    }
  } else if (!rules_on_m && wg == 1 && n == 32) {
    return launch_tile<1, 32, false, kBits>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
