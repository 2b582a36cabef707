// Packed-bit rule matching on Hopper's binary tensor cores (sm_90a).
//
// Replaces the TPU kernel rule_scores_fused_pallas
// (src/repro/kernels/rule_match/fused.py:48, its pallas_call at :59):
//
//   out[b, r] = [ sum_w popc(Qw[b, w] & Aw[r, w]) == sizes[r] ] * conf[r]
//
// Qw [B, W] and Aw [R, W] are items packed 32 to an int32 word, sizes
// int32 (-1 on padded rows, which a count >= 0 never equals), conf and out
// float32.
//
// What bounds it.  At the serving shapes the work is small: a batch of 64
// queries against 896 rules of 32 words is 1.8 M word ANDs, and the bytes
// (Aw once, Qw, sizes, conf, the [B, R] float output) take 0.1-0.2 us at
// 3.35 TB/s.  So the launch and one trip to memory set the time, and the
// kernel is built to expose one memory latency and nothing more.  On CUDA
// cores the popcounts run at 16 a clock an SM; a wide index (64 x 16,384
// rules) needs 8 us of them, so there the arithmetic mattered too.
//
// Design: the AND-popcount is wgmma m64nNk256 .b1 .and.popc, Hopper's
// binary tensor-core product, which sums popc(a & b) over 256 bits of a
// row, exactly this kernel's dot (7.9e15 bit AND-popcount-adds a second
// on the card, 59 times its CUDA cores' popcounts; tools/wgmma_rate.cu).
// A k256 b1 step reads 32 bytes of a row, as a k32 s8 step does, so the
// int8 rule-match kernel's machinery carries over whole
// (rule_match_wgmma.cuh): TMA loads of 128-byte slabs (32 words, the whole
// row at W = 32) onto an mbarrier, 128-byte-swizzled K-major descriptors,
// the row split over a cluster when it spans several slabs, and without a
// cluster each thread comparing, weighting and storing its own
// accumulators, its rules' sizes and confidences loaded while the slabs
// land.  Only the instruction and the int32 sizes differ.  The rules are
// on M, 64 a CTA, and the batch on N; kernels/rule_match/fused.py's
// geometry() picks N and the cluster.
//
// Chosen over (tools/rule_match_packed_designs.py, medians of 9 rounds,
// NVIDIA H100 80GB HBM3, 700.00 W), at [64 x 896], [8 x 896] and [64 x
// 16,384] x 32 words: this kernel 0.00323 / 0.00272 / 0.00405 ms; the
// queries on M (timed from tools/rule_match_packed_layouts.cu) 0.00351 /
// 0.00294 / 0.00609; a CUDA-core design that fills
// the SMs (tools/rule_match_packed_cuda_cores.cu) 0.00363 / 0.00332 /
// 0.01698; the kernel it replaced (a rule a thread, 64 threads a CTA)
// 0.00449 / 0.00415 / 0.01400; an empty launch 0.00189-0.00190.  So what
// is left of the time is the launch and one trip to memory: a CUDA graph
// over a serve's launches, or a top-k fused into the epilogue, are what
// could still move it.
//
// Qw and Aw are contiguous and 16-byte aligned, W % 4 == 0.

#include "rule_match_wgmma.cuh"

// Qw [B, W] and Aw [R, W] int32 words, sizes [R] int32, conf [R] float32,
// out [B, R] float32.  The geometry (kernels/rule_match/fused.py's
// geometry()): the rules on M, 64 a CTA; n in {8, 16, 32, 64} queries a
// tile, and cs in {1, 2, 4, 8} CTAs splitting the 4W bytes of a row.  Any
// other geometry is refused.
extern "C" int rule_match_packed_launch(const void* Qw, const void* Aw,
                                        const void* sizes, const void* conf,
                                        void* out, int B, int R, int W,
                                        int n, int cs, void* stream) {
  const RuleMatchArgs a{Qw, Aw, sizes, static_cast<const float*>(conf),
                        static_cast<float*>(out), B, R, 4 * W, cs,
                        static_cast<cudaStream_t>(stream)};
  if (cs != 1 && cs != 2 && cs != 4 && cs != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 8: return launch_tile<1, 8, true, true>(a);
    case 16: return launch_tile<1, 16, true, true>(a);
    case 32: return launch_tile<1, 32, true, true>(a);
    case 64: return launch_tile<1, 64, true, true>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
