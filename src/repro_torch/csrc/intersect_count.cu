// Row-aligned AND-popcount of two tid-slabs (the Eclat primitive), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel intersect_count_pallas
// (src/repro/kernels/support_count/intersect.py:63):
//
//   out[m] = sum_w popc(A[m, w] & B[m, w])
//
// A and B [M, W] are packed tid-list words (uint32 bit patterns), out [M]
// int32; exact.
//
// What bounds it: bytes.  Each word of A and B is read once for one
// AND+popcount+add, so 8*M*W bytes move for M*W popcounts: at the dense
// mine's [128 x 3,200] tile that is 0.98 us at 3.35 TB/s against 0.10 us
// of popcounts; at the whole k = 2 slab [2,176 x 3,200] 16.6 us, and at a
// retail tile [640 x 2,816] 4.3 us.  The AND is row-aligned, with no
// contraction, so the tensor cores do not apply.  At the tile a launch
// (about 1.7 us) is more than the bytes, so what is left to win is the
// latency between the launch and the last byte: every load has to be in
// flight at once, and the row's sum has to meet in few steps.
//
// Design: one owner a row, kRowThreads threads: 512 (a CTA) for a row of
// more than 128 quads, a warp for a shorter one (a 256-thread CTA holds 8
// such rows).  Each thread issues all its 16-byte ld.global.nc loads of a
// chunk of both slabs (neighbouring threads on neighbouring addresses)
// before its first popcount: two of each slab at 512 threads, so a
// dense tile's 3.3 MB are requested at once by 128 CTAs.  The row's
// partial sums meet through redux.sync in each warp and one shared-memory
// step across the warps, and the owner stores the row's int32 once: no
// atomics, no zeroing of `out`, deterministic.  The caller's geometry
// (kernels/support_count/intersect.py's geometry()) picks kRowThreads
// from the row's length.
//
// Chosen over (tools/intersect_count_designs.py, medians of 5-7 rounds,
// NVIDIA H100 80GB HBM3, 700.00 W), at the dense tile [128 x 3,200], the
// whole slab [2,176 x 3,200] and a retail tile [640 x 2,816]: this kernel
// 0.00268 / 0.0206 / 0.00424 ms against its predecessor's (256 threads a
// row, shuffle reductions) 0.00291 / 0.0214 / 0.00433; 1,024 threads a
// row 0.00273 / 0.0207 / 0.00459, 256 with redux.sync 0.00280 / 0.0213 /
// 0.00444, 128 or fewer slower still.  Bulk async copies (cp.async.bulk
// of each CTA's share into a ring of mbarrier stages,
// tools/intersect_count_bulk_copies.cu) lost at every geometry: 0.00363 /
// 0.0225 / 0.00526 at one row a CTA, 0.0050 / 0.0369 / 0.0102 with each
// row split over a cluster of 2 CTAs meeting in distributed shared
// memory, 0.0240 / 0.0065 with several rows a CTA.  The tile's bytes are
// in flight at once either way; a bulk copy completes only when its last
// byte lands, and a cluster's barriers add a round trip.
//
// A and B are contiguous and 16-byte aligned, W % 4 == 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCta = 256;             // threads a CTA, at least

__device__ __forceinline__ int popc_and(uint4 x, uint4 y) {
  return __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
}

template <int kRowThreads>
__global__ void __launch_bounds__(kRowThreads > kCta ? kRowThreads : kCta)
intersect_count_kernel(const uint4* __restrict__ A,
                       const uint4* __restrict__ B, int* __restrict__ out,
                       int M, int Q) {
  constexpr int kBlock = kRowThreads > kCta ? kRowThreads : kCta;
  constexpr int kWarps = kRowThreads / 32;           // warps a row
  // uint4 of each slab a thread loads before its popcounts: a chunk of
  // 1,024 quads (16 KB a slab) at 512 threads, 128 at a warp
  constexpr int kLoads = kRowThreads >= 256 ? 1024 / kRowThreads : 4;
  constexpr int kChunk = kRowThreads * kLoads;
  const int t = threadIdx.x % kRowThreads;
  const int m = blockIdx.x * (kBlock / kRowThreads) + threadIdx.x / kRowThreads;
  int sum = 0;
  if (m < M) {                   // uniform over a row's threads
    const uint4* a = A + static_cast<size_t>(m) * Q;
    const uint4* b = B + static_cast<size_t>(m) * Q;
    for (int q0 = 0; q0 < Q; q0 += kChunk) {
      uint4 x[kLoads], y[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int q = q0 + t + i * kRowThreads;
        x[i] = q < Q ? __ldg(a + q) : make_uint4(0, 0, 0, 0);
        y[i] = q < Q ? __ldg(b + q) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) sum += popc_and(x[i], y[i]);
    }
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  if constexpr (kWarps == 1) {
    if (t == 0 && m < M) out[m] = sum;
  } else {
    __shared__ int partial[kBlock / 32];     // a warp's sum, rows in turn
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = sum;
    __syncthreads();
    if (t < 32) {                // the row's first warp adds its warps'
      const int* mine = partial + threadIdx.x / 32;
      sum = __reduce_add_sync(0xffffffffu, t < kWarps ? mine[t] : 0);
      if (t == 0 && m < M) out[m] = sum;
    }
  }
}

template <int kRowThreads>
int launch(const void* A, const void* B, void* out, int M, int Q,
           cudaStream_t stream) {
  constexpr int kBlock = kRowThreads > kCta ? kRowThreads : kCta;
  constexpr int kRows = kBlock / kRowThreads;
  intersect_count_kernel<kRowThreads><<<(M + kRows - 1) / kRows, kBlock, 0,
                                        stream>>>(
      static_cast<const uint4*>(A), static_cast<const uint4*>(B),
      static_cast<int*>(out), M, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A and B [M, W] int32 words, out [M] int32 (every row written).  The
// geometry (kernels/support_count/intersect.py's geometry()): row_threads
// in {32, 512} threads own a row.  Any other is refused.
extern "C" int intersect_count_launch(const void* A, const void* B, void* out,
                                      int M, int W, int row_threads,
                                      void* stream) {
  const int Q = W / 4;
  auto s = static_cast<cudaStream_t>(stream);
  switch (row_threads) {
    case 32: return launch<32>(A, B, out, M, Q, s);
    case 512: return launch<512>(A, B, out, M, Q, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
