// Packed-bit support counting on Hopper's binary tensor cores (sm_90a).
//
// Replaces the TPU kernel support_count_fused_pallas
// (src/repro/kernels/support_count/fused.py:94):
//
//   out[m] += #{ t : sum_w popc(Tw[t, w] & Cw[m, w]) == sizes[m] }
//
// Tw [N, W] and Cw [M, W] are items packed 32 to an int32 word (uint32 bit
// patterns), sizes and out [M] int32; exact.
//
// What bounds it.  The mining rounds give it one transaction tile [3,128 x
// 32 words] against the round's candidates: M = 2,176 at k = 2, then 256,
// 128, 128.  At k = 2 its N*M*W*32 bit AND-popcount-adds take 0.9 us on
// the binary tensor cores (7.86e15 a second, tools/wgmma_rate.cu), and
// the bytes (one read of Tw and Cw, 0.7 MB) less; both are under a
// launch.  So the launch, one trip to memory and the epilogue set the
// time.  On the CUDA cores the same popcounts need 52 us (16 a clock an
// SM), which held the kernel this one replaced
// (tools/support_count_packed_cuda_cores.cu).
//
// Design: the AND-popcount is wgmma m64nNk256 .b1 .and.popc.  A k256 b1
// step reads 32 bytes of a row, as a k32 s8 step does, so the int8
// support-count kernel carries over whole (support_count_wgmma.cuh): a
// producer warp's TMA loads of 128-byte slabs through a ring of mbarrier
// stages, the transactions on M against a tile of candidates on N, and
// the compare, row mask and one atomicAdd a candidate a CTA in the
// epilogue.  Only the instruction and the row's length differ: a row is
// 4W bytes, so at W = 32 a transaction tile is one 128-byte slab and four
// wgmma a warpgroup, with 8x fewer bytes from L2 than the int8 kernel's
// 1,024-byte rows.  At B11's W = 4 TMA zero-fills each 16-byte row to the
// slab; zero bits AND to 0, so the counts stay exact, and rows past N
// stay masked (their dot of 0 is an empty candidate's size).
//
// The tile: 64 transactions by 64 candidates, the narrowest, so that
// many small CTAs (six fit an SM) overlap their loads and epilogues; at k
// = 2 a CTA walks four transaction tiles through a ring of two stages,
// so that one wave streams the next tile while the tensor cores run the
// last (kernels/support_count/fused.py's geometry()).  Chosen over
// (tools/support_count_packed_designs.py, medians of 5-7 rounds, NVIDIA
// H100 80GB HBM3, 700.00 W; each launch beside the zeroing of `out`) at
// M = 2,176 / 256 / 128: this kernel 0.01009 / 0.00613 / 0.00581 ms
// against the CUDA-core kernel it replaced, 0.0694 / 0.0147 / 0.0109, and
// the int8 kernel, 0.0245 / 0.0094 / 0.0086; one 64 x 64 tile a CTA at k
// = 2 0.01207; 128 x 64 tiles 0.01028 / 0.00608 / 0.00598; the int8
// kernel's picks for those rounds (128 x 256, 64 x 128, 64 x 64) 0.01561
// / 0.00655 / 0.00582; deeper rings (3 to 8 stages, 4 or 8 tiles a CTA)
// 0.0103-0.0170 at k = 2; an empty launch 0.0017.  Wider tiles run longer
// epilogues on fewer CTAs an SM.  The tensor cores take under a tenth of
// the time: two launches (the zeroing and this one) take a third, and
// the rest goes with the tiles' 27 MB of L2 reads at k = 2 (each 64 x
// 64 tile loads both operands' slabs afresh, about 4 TB/s).
//
// The caller zeroes `out`; Tw and Cw are contiguous and 16-byte aligned,
// W % 4 == 0.

#include "support_count_wgmma.cuh"

// Tw [N, W] and Cw [M, W] int32 words, sizes and out [M] int32, out
// zeroed.  The geometry (kernels/support_count/fused.py's geometry()):
// tiles of 64 transactions (one consumer warpgroup) by 64 candidates, a
// CTA walking `tiles` transaction tiles (more where the grid would pass
// 65,535 rows of CTAs) through a ring of two slabs (one where it reads
// only one).  tools/support_count_packed_tiles.cu builds the other tiles
// the shared kernel takes.
extern "C" int support_count_packed_launch(const void* Tw, const void* Cw,
                                           const void* sizes, void* out,
                                           int N, int M, int W, int tiles,
                                           void* stream) {
  const SupportCountArgs a{Tw, Cw, static_cast<const int*>(sizes),
                           static_cast<int*>(out), N, M, 4 * W, tiles, 2,
                           static_cast<cudaStream_t>(stream)};
  return launch_tile<1, 64, true>(a);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
