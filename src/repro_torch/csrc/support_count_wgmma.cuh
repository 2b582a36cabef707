// The support-count kernel of support_count_int8.cu and
// support_count_packed.cu:
//
//   out[m] += sum_t [ dot(T[t], C[m]) == sizes[m] ]
//
// where dot is an int8 product over items (kBits false: T [N, I] and C
// [M, I] 0/1 int8) or an AND-popcount over packed bits (kBits true: T [N,
// W] and C [M, W] int32 words, read as 4W bytes); sizes and out [M] int32.
// Both are one integer wgmma a 32-byte step of a row (m64nNk32 s8, or
// m64nNk256 b1 AND-popc), so everything but the instruction is shared;
// each source's header says what bounds its kernel and why this design.
//
// - The transactions are wgmma's M (64 rows a consumer warpgroup, one or
//   two warpgroups a CTA) against a tile of N = 64, 128 or 256 candidates;
//   both operands K-major, as T and C are stored, read by 128-byte-swizzled
//   descriptors (sm90.cuh).  Integer accumulation: exact.
// - A producer warp, one thread of it issuing TMA loads of 128-byte slabs
//   of both operands into a ring of stages, each with a full barrier (the
//   copy's bytes) and an empty one (every consumer warp arrives once its
//   products have read the stage), so loads stay in flight while the
//   tensor cores work; the consumers keep one slab's products in flight
//   behind the next.  TMA's zero fill covers ragged N, M and row bytes:
//   zero bytes add nothing to either dot.
// - Epilogue in registers: each dot is compared with its candidate's size
//   (from shared memory; -1 past M); transaction rows past N are masked,
//   since their zero-filled dot of 0 equals the size of an empty
//   candidate.  A thread keeps its hits two candidates a register; shuffles
//   sum them over the warp's rows, shared-memory atomics over the warps,
//   and one atomicAdd a candidate a CTA adds them to `out` (integer atomics
//   commute: exact).
// - A CTA can walk several transaction tiles (the caller's `tiles`, and
//   past 65,535 rows of CTAs), its producer loading the next tile's slabs
//   while the consumers run the last.
// - The producer issues its first ring of loads before the CTA loads its
//   candidates' sizes, so the two trips to memory overlap.
// - The geometry (warpgroups, N, tiles, stages) is the caller's.
//
// The caller zeroes `out`; T and C are contiguous and 16-byte aligned with
// rows of a multiple of 16 bytes.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int kMaxStages = 8;     // slabs in flight in a CTA's ring
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// A CTA: WG consumer warpgroups of 64 transactions each against N
// candidates, and one producer warp.
template <int WG, int N>
struct Tile {
  static constexpr int kRows = 64 * WG;               // transactions a tile
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr uint32_t kTBytes = kRows * kSlab;
  static constexpr uint32_t kStageBytes = (kRows + N) * kSlab;
  // the 1 KB swizzle alignment, the ring, a full and an empty barrier a
  // stage, the candidates' sizes and hits
  static constexpr size_t smem_bytes(int stages) {
    return 1024 + stages * kStageBytes + 16 * stages + 8 * N;
  }
};

template <int WG, int N, bool kBits>
__global__ void __launch_bounds__(Tile<WG, N>::kThreads, 1)
support_count_kernel(const __grid_constant__ CUtensorMap tm_t,
                     const __grid_constant__ CUtensorMap tm_c,
                     const int* __restrict__ sizes, int* __restrict__ out,
                     int n_tx, int M, int row_bytes, int stages) {
  using T = Tile<WG, N>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* tile = smem + (base - smem_u32(smem));
  const uint32_t ring = stages * T::kStageBytes;
  const uint32_t full = base + ring, empty = full + 8 * stages;
  int* s_sizes = reinterpret_cast<int*>(tile + ring + 16 * stages);
  int* s_hits = s_sizes + N;

  const int c0 = blockIdx.x * N;
  // a row's slabs, and this CTA's transaction tiles
  const int slabs = (row_bytes + kSlab - 1) / kSlab;
  const int t_tiles = (n_tx + T::kRows - 1) / T::kRows;
  const int iters = static_cast<int>(blockIdx.y) < t_tiles
                        ? (t_tiles - 1 - blockIdx.y) / gridDim.y + 1
                        : 0;

  // ---- producer (lane 0 of the last warp): slab i of this CTA into stage
  // i % stages; the first ring's worth goes out before the sizes load
  const bool producer = threadIdx.x == T::kConsumers;
  auto issue = [&](int i) {
    const int s = i % stages;
    const int row0 = (blockIdx.y + (i / slabs) * gridDim.y) * T::kRows;
    const int col = (i % slabs) * kSlab;
    const uint32_t dst = base + s * T::kStageBytes;
    mbar_expect_tx(full + 8 * s, T::kStageBytes);
    tma_load(dst, &tm_t, full + 8 * s, col, row0);
    tma_load(dst + T::kTBytes, &tm_c, full + 8 * s, col, c0);
  };
  if (producer) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < iters * slabs && i < stages; ++i) issue(i);
  }
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    s_sizes[c] = c0 + c < M ? sizes[c0 + c] : -1;   // a dot is >= 0
    s_hits[c] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t hits[N / 8];          // columns 8j + 2t (low half) and + 1
#pragma unroll
  for (int j = 0; j < N / 8; ++j) hits[j] = 0;

  if (warp == 4 * WG) {
    if (producer) {              // the ring cycles as consumers free stages
      for (int i = stages; i < iters * slabs; ++i) {
        mbar_wait(empty + 8 * (i % stages), (i / stages - 1) & 1);
        issue(i);
      }
    }
  } else {
    // ---- consumers: each warpgroup its 64 transactions -----------------
    const int wg = warp / 4;
    int acc[N / 2];
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[e] = 0;
      for (int k = 0; k < slabs; ++k) {
        const int i = it * slabs + k, s = i % stages;
        mbar_wait(full + 8 * s, (i / stages) & 1);
        const uint32_t a = base + s * T::kStageBytes + wg * 64 * kSlab;
        const uint32_t b = base + s * T::kStageBytes + T::kTBytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 32; ++kk)
          wgmma_step<N, kBits>(acc, smem_desc(a + 32 * kk),
                               smem_desc(b + 32 * kk));
        wgmma_commit();
        wgmma_wait<1>();         // the previous slab's products are done
        fence_regs(acc);
        if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
      }
      wgmma_wait_all();
      fence_regs(acc);
      if (slabs > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((it * slabs + slabs - 1) % stages));
      // compare in registers; rows past n_tx are zero-filled, masked
      const int r = (blockIdx.y + it * gridDim.y) * T::kRows + wg * 64 +
                    16 * (warp % 4) + g;
      const bool lo = r < n_tx, hi = r + 8 < n_tx;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int s0 = s_sizes[8 * j + 2 * t];
        const int s1 = s_sizes[8 * j + 2 * t + 1];
        const uint32_t h0 = (lo & (acc[4 * j] == s0)) +
                            (hi & (acc[4 * j + 2] == s0));
        const uint32_t h1 = (lo & (acc[4 * j + 1] == s1)) +
                            (hi & (acc[4 * j + 3] == s1));
        hits[j] += h0 | h1 << 16;
      }
    }
    // a column's 8 row groups g (lane bits 2-4) meet in three shuffles;
    // each half stays below 2**16 (16 hits a tile, under 4,096 tiles)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t v = hits[j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0 && v) {
        const int lo = static_cast<int>(v & 0xFFFFu);
        const int hi = static_cast<int>(v >> 16);
        if (lo) atomicAdd(&s_hits[8 * j + 2 * t], lo);
        if (hi) atomicAdd(&s_hits[8 * j + 2 * t + 1], hi);
      }
    }
  }
  __syncthreads();               // every warp's hits are in s_hits
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    if (c0 + c < M && s_hits[c]) atomicAdd(out + c0 + c, s_hits[c]);
}

struct SupportCountArgs {
  const void* T;
  const void* C;
  const int* sizes;
  int* out;
  int N, M, row_bytes, tiles, stages;   // tiles: transaction tiles a CTA
  cudaStream_t stream;
};

template <int WG, int N, bool kBits>
int launch_tile(const SupportCountArgs& a) {
  using Tl = Tile<WG, N>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_t, tm_c;
  if (!encode_map(encode, &tm_t, a.T, a.N, a.row_bytes, Tl::kRows) ||
      !encode_map(encode, &tm_c, a.C, a.M, a.row_bytes, N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int t_tiles = (a.N + Tl::kRows - 1) / Tl::kRows;
  const int want_y = (t_tiles + a.tiles - 1) / a.tiles;
  const int grid_y = want_y < 65535 ? want_y : 65535;
  const int tiles = (t_tiles + grid_y - 1) / grid_y;   // a CTA walks them
  if (tiles >= 4096) return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = (a.row_bytes + kSlab - 1) / kSlab * tiles;
  // a consumer frees a stage only once the next slab's products are
  // issued, so a CTA that reads more than one slab needs two stages
  int stages = a.stages < kMaxStages ? a.stages : kMaxStages;
  if (stages > per_cta) stages = per_cta;
  if (stages < 2) stages = per_cta > 1 ? 2 : 1;
  const size_t smem = Tl::smem_bytes(stages);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = support_count_kernel<WG, N, kBits>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((a.M + N - 1) / N, grid_y), Tl::kThreads, smem, a.stream>>>(
      tm_t, tm_c, a.sizes, a.out, a.N, a.M, a.row_bytes, stages);
  return static_cast<int>(cudaGetLastError());
}

// wg in {1, 2} consumer warpgroups (64 transactions each), n in {64, 128,
// 256} candidates a tile, and up to a.stages slabs in flight (at most 8
// and as many as a CTA reads, at least 2 where it reads more than one; as
// fit in shared memory).  Any other geometry is refused.
template <bool kBits>
int support_count_launch(const SupportCountArgs& a, int wg, int n) {
  if (wg == 1) {
    switch (n) {
      case 64: return launch_tile<1, 64, kBits>(a);
      case 128: return launch_tile<1, 128, kBits>(a);
      case 256: return launch_tile<1, 256, kBits>(a);
    }
  } else if (wg == 2) {
    switch (n) {
      case 64: return launch_tile<2, 64, kBits>(a);
      case 128: return launch_tile<2, 128, kBits>(a);
      case 256: return launch_tile<2, 256, kBits>(a);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
