// The bulk-copy design of the intersect kernel, for
// tools/intersect_count_designs.py to time beside the plain-load kernel
// that src/repro_torch/csrc/intersect_count.cu ships:
//
//   out[m] = sum_w popc(A[m, w] & B[m, w])
//
// - One thread of each CTA issues 1-D bulk async copies (cp.async.bulk,
//   no tensor map) of the CTA's share of A and B into shared memory, a
//   chunk of a row a stage, completing on that stage's mbarrier; a share longer than the ring refills each stage
//   once every thread has read it.  The threads AND-popcount the landed
//   stages from shared memory (conflict-free uint4 reads).
// - The split: a CTA takes `rows` consecutive rows, and a cluster of cs
//   CTAs (1, 2 or 4) splits each row's words; with a cluster each rank
//   adds its rows' partials into rank 0's shared memory (distributed
//   shared memory) between two cluster barriers, and rank 0 stores each
//   row once.
//
// It lost to one owner a row fed by plain loads at every shape and
// geometry timed (PERF.md, section 6).  Built with -I src/repro_torch/csrc.

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxChunkQuads = 1024;  // uint4 of A (and of B) a stage
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may use

// `bytes` contiguous bytes of global memory into shared memory (both
// 16-byte aligned, bytes a non-zero multiple of 16), completing them on
// the barrier; the destination is this CTA's own shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int popc_and(uint4 x, uint4 y) {
  return __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
}

// the ring (stages x [A chunk | B chunk]), a barrier a stage, the rows'
// sums
size_t smem_bytes(int rows, int chunk_q, int stages) {
  return static_cast<size_t>(stages) * chunk_q * 32 + 8 * stages + 4 * rows;
}

__global__ void __launch_bounds__(kThreads)
intersect_count_kernel(const uint4* __restrict__ A,
                       const uint4* __restrict__ B, int* __restrict__ out,
                       int M, int Q, int rows, int chunk_q, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint4* ring = reinterpret_cast<const uint4*>(smem);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + stages * chunk_q * 32;
  int* s_sum = reinterpret_cast<int*>(smem + stages * chunk_q * 32 +
                                      8 * stages);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = (blockIdx.x / cs) * rows;
  const int n_rows = min(rows, M - r0);
  // this rank's quads of a row, cut into chunks of at most chunk_q
  const int qb = rank * Q / cs, qe = (rank + 1) * Q / cs;
  const int chunks = (qe - qb + chunk_q - 1) / chunk_q;
  const int units = n_rows * chunks;

  auto issue = [&](int u) {      // unit u (row u / chunks) into a stage
    const int s = u % stages;
    const int q0 = qb + (u % chunks) * chunk_q;
    const uint32_t bytes = 16u * min(chunk_q, qe - q0);
    const size_t at = static_cast<size_t>(r0 + u / chunks) * Q + q0;
    const uint32_t dst = base + s * chunk_q * 32;
    mbar_expect_tx(bars + 8 * s, 2 * bytes);
    bulk_load(dst, A + at, bytes, bars + 8 * s);
    bulk_load(dst + chunk_q * 16, B + at, bytes, bars + 8 * s);
  };
  for (int j = threadIdx.x; j < rows; j += kThreads) s_sum[j] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();               // the barriers and zeroed sums are set
  if (threadIdx.x == 0)
    for (int u = 0; u < units && u < stages; ++u) issue(u);
  // with a cluster, every rank has started (and zeroed its sums) before
  // any adds into rank 0's; the copies are in flight meanwhile
  if (cs > 1) cluster.sync();

  const int lane = threadIdx.x % 32;
  int sum = 0;
  for (int u = 0; u < units; ++u) {
    const int s = u % stages, c = u % chunks;
    const int nq = min(chunk_q, qe - qb - c * chunk_q);
    mbar_wait(bars + 8 * s, (u / stages) & 1);
    const uint4* a = ring + s * 2 * chunk_q;
    const uint4* b = a + chunk_q;
    for (int q = threadIdx.x; q < nq; q += kThreads)
      sum += popc_and(a[q], b[q]);
    if (c == chunks - 1) {       // uniform: the row's last chunk
      sum = warp_sum(sum);
      if (lane == 0 && sum) atomicAdd(s_sum + u / chunks, sum);
      sum = 0;
    }
    if (u + stages < units) {    // uniform: the ring cycles
      __syncthreads();           // every thread is done with stage s
      if (threadIdx.x == 0) issue(u + stages);
    }
  }
  __syncthreads();               // this CTA's sums are in s_sum
  if (cs > 1) {
    if (rank > 0) {
      int* root = cluster.map_shared_rank(s_sum, 0);
      for (int j = threadIdx.x; j < n_rows; j += kThreads)
        if (s_sum[j]) atomicAdd(root + j, s_sum[j]);
    }
    cluster.sync();              // every rank's sums are in rank 0's
  }
  if (rank == 0)
    for (int j = threadIdx.x; j < n_rows; j += kThreads)
      out[r0 + j] = s_sum[j];
}

}  // namespace

// A and B [M, W] int32 words, out [M] int32 (every row written).  The
// geometry: `rows`
// consecutive rows a CTA, a cluster of cs in {1, 2, 4} CTAs splitting each
// row's W / 4 quads (at most one rank a quad), and a ring of `stages`
// chunks (1 to 8) that fits in shared memory.  Any other geometry is
// refused.
extern "C" int intersect_count_bulk_launch(const void* A, const void* B, void* out,
                                      int M, int W, int rows, int cs,
                                      int stages, void* stream) {
  const int Q = W / 4;
  if (M < 1 || Q < 1 || rows < 1 || (cs != 1 && cs != 2 && cs != 4) ||
      cs > Q || stages < 1 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const int share = (Q + cs - 1) / cs;
  const int chunk_q = share < kMaxChunkQuads ? share : kMaxChunkQuads;
  const size_t smem = smem_bytes(rows, chunk_q, stages);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      intersect_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + rows - 1) / rows * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, intersect_count_kernel,
                           static_cast<const uint4*>(A),
                           static_cast<const uint4*>(B),
                           static_cast<int*>(out), M, Q, rows, chunk_q,
                           stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
