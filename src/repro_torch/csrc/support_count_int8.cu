// Int8 tensor-core support counting for Hopper (sm_90a).
//
// Replaces the TPU kernel support_count_pallas
// (src/repro/kernels/support_count/kernel.py:65, its pallas_call at :74),
// which runs the containment test as an int8 matmul on the matrix unit:
//
//   out[m] += sum_t [ sum_i T[t, i] * C[m, i] == sizes[m] ]
//
// T [N, I] and C [M, I] are 0/1 int8, sizes and out [M] int32; exact.
//
// What bounds it.  The mining rounds give it one transaction tile [3,128 x
// 1,024] against the round's candidates: M = 2,176 at k = 2, then 256,
// 128, 128.  At k = 2 the 2*N*M*I int8 operations take 7.0 us at the
// dense 1,979 TOP/s, five times the bytes (one read of T and C); at M =
// 128 the 3.2 MB of T set the bound, about 1 us, so there the launch, one
// trip to memory and filling the card are what count.
//
// Design.
// - wgmma m64nNk32 s8 x s8 -> s32 with the transactions on M (64 rows a
//   consumer warpgroup, one or two warpgroups a CTA) and a tile of N = 64,
//   128 or 256 candidates on N; both operands K-major, as T and C are
//   stored, read by 128-byte-swizzled descriptors (sm90.cuh).  Integer
//   accumulation: exact.
// - A producer warp, one thread of it issuing TMA loads of 128-item slabs
//   of both operands into a ring of stages, each with a full barrier (the
//   copy's bytes) and an empty one (every consumer warp arrives once its
//   products have read the stage), so loads stay in flight while the
//   tensor cores work; the consumers keep one slab's products in flight
//   behind the next.  TMA's zero fill covers ragged N, M and I.
// - Epilogue in registers: each dot is compared with its candidate's size
//   (from shared memory; -1 past M); transaction rows past N are masked,
//   since their zero-filled dot of 0 equals the size of an empty
//   candidate.  A thread keeps its hits two candidates a register; shuffles
//   sum them over the warp's rows, shared-memory atomics over the warps,
//   and one atomicAdd a candidate a CTA adds them to `out` (integer atomics
//   commute: exact).  A CTA walks further transaction tiles past 65,535 of
//   them.
// - Filling the card: a small round takes narrower candidate tiles (M =
//   256 as 2 x 128, M = 128 as 2 x 64: 98 CTAs, every slab of a CTA in
//   flight at once).  Splitting a tile's item axis over a cluster, with
//   the partial dots meeting in distributed shared memory before the
//   compare, lost at those rounds: 0.0115 / 0.0099 ms at M = 256 / 128
//   for its best cluster against 0.0096 / 0.0087 for the narrower tiles
//   (tools/support_count_int8_designs.py as of commit cddde5a, medians of
//   5 rounds, NVIDIA H100 80GB HBM3, 700.00 W), and was taken out.
// - The geometry (warpgroups, N, stages) is the caller's:
//   kernels/support_count/kernel.py's geometry() picks it for each shape.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; each time a
// wrapper call, the zeroing of `out` included): 0.0302 ms at M = 2,176,
// 0.0105 at 256, 0.0092 at 128, against 0.0821, 0.0281 and 0.0251 for
// torch._int_mm plus the compare and sum, and 0.0739 / 0.034 / 0.035 for
// the mma.sync kernel this one replaced.  At k = 2 it runs at 4.3x its
// operations bound: its 225 CTAs read T 9 times and C 25 times from L2,
// 86 MB in all, about 12 KB a million products, more than L2 feeds the
// tensor cores at their rate.  Multicasting a candidate tile over a
// cluster of 2 or 4 transaction tiles (TMA .multicast::cluster, each stage
// released by every CTA's consumers) cut those bytes but ran 1.5-1.9x
// slower at every round, the cluster's CTAs waiting on each other's
// stages, and was dropped.
//
// The caller zeroes `out`; T and C are contiguous and 16-byte aligned with
// I % 16 == 0 (the wrapper asks I % 64 == 0).

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

template <int WG, int N>
__global__ void __launch_bounds__(Tile<WG, N>::kThreads, 1)
support_count_int8_kernel(const __grid_constant__ CUtensorMap tm_t,
                          const __grid_constant__ CUtensorMap tm_c,
                          const int* __restrict__ sizes,
                          int* __restrict__ out, int n_tx, int M, int I,
                          int stages) {
  using T = Tile<WG, N>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* tile = smem + (base - smem_u32(smem));
  const uint32_t ring = stages * T::kStageBytes;
  const uint32_t full = base + ring, empty = full + 8 * stages;
  int* s_sizes = reinterpret_cast<int*>(tile + ring + 16 * stages);
  int* s_hits = s_sizes + N;

  const int c0 = blockIdx.x * N;
  // the item axis's slabs, and this CTA's transaction tiles
  const int slabs = (I + kSlab - 1) / kSlab;
  const int t_tiles = (n_tx + T::kRows - 1) / T::kRows;
  const int iters = static_cast<int>(blockIdx.y) < t_tiles
                        ? (t_tiles - 1 - blockIdx.y) / gridDim.y + 1
                        : 0;

  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    s_sizes[c] = c0 + c < M ? sizes[c0 + c] : -1;   // a dot is >= 0
    s_hits[c] = 0;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t hits[N / 8];          // columns 8j + 2t (low half) and + 1
#pragma unroll
  for (int j = 0; j < N / 8; ++j) hits[j] = 0;

  if (warp == 4 * WG) {
    // ---- producer: slab i of this CTA into stage i % stages -----------
    if (lane == 0) {
      for (int i = 0; i < iters * slabs; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
        const int row0 = (blockIdx.y + (i / slabs) * gridDim.y) * T::kRows;
        const int col = (i % slabs) * kSlab;
        const uint32_t dst = base + s * T::kStageBytes;
        mbar_expect_tx(full + 8 * s, T::kStageBytes);
        tma_load(dst, &tm_t, full + 8 * s, col, row0);
        tma_load(dst + T::kTBytes, &tm_c, full + 8 * s, col, c0);
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
          wgmma_s8<N>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk),
                      1);
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
    // each half stays below 2**16 (16 hits a tile, at most 512 tiles)
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

struct Args {
  const void* T;
  const void* C;
  const int* sizes;
  int* out;
  int N, M, I, stages;
  cudaStream_t stream;
};

template <int WG, int N>
int launch(const Args& a) {
  using Tl = Tile<WG, N>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_t, tm_c;
  if (!encode_map(encode, &tm_t, a.T, a.N, a.I, Tl::kRows) ||
      !encode_map(encode, &tm_c, a.C, a.M, a.I, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int t_tiles = (a.N + Tl::kRows - 1) / Tl::kRows;
  const int grid_y = t_tiles < 65535 ? t_tiles : 65535;
  const int per_cta = (a.I + kSlab - 1) / kSlab *
                      ((t_tiles + grid_y - 1) / grid_y);
  // a consumer frees a stage only once the next slab's products are
  // issued, so a CTA that reads more than one slab needs two stages
  int stages = a.stages < kMaxStages ? a.stages : kMaxStages;
  if (stages > per_cta) stages = per_cta;
  if (stages < 2) stages = per_cta > 1 ? 2 : 1;
  const size_t smem = Tl::smem_bytes(stages);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = support_count_int8_kernel<WG, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((a.M + N - 1) / N, grid_y), Tl::kThreads, smem, a.stream>>>(
      tm_t, tm_c, a.sizes, a.out, a.N, a.M, a.I, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// T [N, I] and C [M, I] int8, sizes and out [M] int32, out zeroed; T and C
// contiguous and 16-byte aligned, I % 16 == 0.  The geometry
// (kernels/support_count/kernel.py's geometry()): wg in {1, 2} consumer
// warpgroups (64 transactions each), n in {64, 128, 256} candidates a
// tile, and up to `stages` slabs in flight (at most 8 and as many as a
// CTA reads, at least 2 where it reads more than one; as fit in shared
// memory).  Any other geometry is refused.
extern "C" int support_count_int8_launch(const void* T, const void* C,
                                         const void* sizes, void* out, int N,
                                         int M, int I, int wg, int n,
                                         int stages, void* stream) {
  const Args a{T, C, static_cast<const int*>(sizes), static_cast<int*>(out),
               N, M, I, stages, static_cast<cudaStream_t>(stream)};
  if (wg == 1) {
    switch (n) {
      case 64: return launch<1, 64>(a);
      case 128: return launch<1, 128>(a);
      case 256: return launch<1, 256>(a);
    }
  } else if (wg == 2) {
    switch (n) {
      case 64: return launch<2, 64>(a);
      case 128: return launch<2, 128>(a);
      case 256: return launch<2, 256>(a);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
