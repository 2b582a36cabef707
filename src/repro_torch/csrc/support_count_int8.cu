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
// Design (the kernel is support_count_wgmma.cuh's, which the packed
// source instantiates with the b1 product).
// - wgmma m64nNk32 s8 x s8 -> s32 with the transactions on M (64 rows a
//   consumer warpgroup, one or two warpgroups a CTA) and a tile of N = 64,
//   128 or 256 candidates on N; both operands K-major, as T and C are
//   stored.  Integer accumulation: exact.
// - A producer warp issues TMA loads of 128-item slabs of both operands
//   into a ring of mbarrier stages, so loads stay in flight while the
//   tensor cores work.  TMA's zero fill covers ragged N, M and I.
// - Epilogue in registers: each dot is compared with its candidate's size,
//   rows past N are masked, and one atomicAdd a candidate a CTA adds the
//   hits to `out` (integer atomics commute: exact).
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

#include "support_count_wgmma.cuh"

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
  const SupportCountArgs a{T, C, static_cast<const int*>(sizes),
                           static_cast<int*>(out), N, M, I, 1, stages,
                           static_cast<cudaStream_t>(stream)};
  return support_count_launch<false>(a, wg, n);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
