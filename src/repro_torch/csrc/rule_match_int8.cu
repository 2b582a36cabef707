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
// Design: the kernel is rule_match_wgmma.cuh's (wgmma m64nNk32 s8 x s8 ->
// s32 on K-major operands, so either can be M; TMA loads of 128-item
// slabs onto one mbarrier a slab, all of a CTA's slabs at once up to I =
// 1,024; a tile's item axis split over a cluster whose int32 partials meet
// in distributed shared memory), which rule_match_packed.cu runs with the
// b1 AND-popcount in place of the s8 product.  wgmma, not mma.sync,
// because it needs no fragment loads: a warpgroup's 64 x N tile over 128
// items is four instructions.  The launch geometry is
// kernels/rule_match/kernel.py's geometry():
// - two layouts, each the faster at one of serving's two buckets
//   (tools/rule_match_int8_designs.py, medians of 9 rounds, NVIDIA H100
//   80GB HBM3, 700.00 W):
//   * queries on M and 32-rule tiles as N, when the batch is over 32 (a
//     bucket of 64 fills M) and those tiles fit in one wave: 0.00508 ms
//     at [64 x 896 x 1,024], against 0.00526 with the rules on M;
//   * otherwise rules on M and the batch, rounded up to 8, 16, 32 or 64,
//     as N, so that a bucket of 8 fills the instruction with no rows of
//     zeros: 0.00457 ms at [8 x 896 x 1,024], against 0.00517 with the
//     queries on M;
// - filling the card: at the serving shape 28 tiles x a cluster of 4 =
//   112 CTAs each read 24 KB; at bucket 8, 14 x 8 = 112 CTAs read 9 KB
//   each;
// - wide indexes: rules on M, two warpgroups a CTA (128 rules) sharing one
//   query block, so each antecedent byte is read once; 16,384 rules are
//   128 CTAs, one wave.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.0052 ms at
// the serving shape, 0.0047 at bucket 8 and 0.0092 at 16,384 rules,
// against 0.0155, 0.0214 and 0.0240 for torch._int_mm plus the compare
// and weight (the kernel this one replaced: 0.0171-0.0175 at the serving
// shape, 0.0246 at 16,384 rules).  Without a cluster the serving shape
// took 0.0073 ms with the queries on M, 0.0080 with the rules on M, when
// every launch's partials went through shared memory; since the kernel
// stores its accumulators from registers where there is no cluster (a
// change made for rule_match_packed.cu), 16,384 rules take 0.0066.
//
// Left: the launch itself is most of what remains (a CTA reads 9-24 KB,
// the bytes bound is 0.36 us).  A CUDA graph around serving's launches,
// or fusing the top-k into the epilogue so the [B, R] scores never reach
// device memory, are what could still move it.
//
// sizes are integral floats (-1 on padded rows, which a dot >= 0 never
// equals); the compare is exact below 2**24 items.  Q and A are
// contiguous, 16-byte aligned, I % 16 == 0 (the wrapper asks I % 64 == 0).

#include "rule_match_wgmma.cuh"

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
  const RuleMatchArgs a{Q, A, sizes, static_cast<const float*>(conf),
                        static_cast<float*>(out), B, R, I, cs,
                        static_cast<cudaStream_t>(stream)};
  return rule_match_launch<false>(a, rules_on_m, wg, n);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
