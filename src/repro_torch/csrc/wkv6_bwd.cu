// RWKV-6 WKV recurrence (data-dependent decay), backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel and
// trains rwkv by differentiating its lax.scan (src/repro/models/
// rwkv6.py:65-76) with jax.value_and_grad.  This is the gradient of
// wkv6.cu's function
//
//   y_t[m]   = sum_i r_t[i] (S_{t-1}[i][m] + u[i] k_t[i] v_t[m])
//   S_t[i][m] = w_t[i] S_{t-1}[i][m] + k_t[i] v_t[m]      (S_{-1} = s0)
//
// given dy [B, T, H, n] and dS_T [B, H, n, n] (null: zeros).  With dS the
// gradient of S_t, from dS = dS_T, newest step first:
//
//   dr_t[i] = sum_m dy_t[m] S_{t-1}[i][m] + u[i] k_t[i] (dy_t . v_t)
//   dk_t[i] = sum_m dS[i][m] v_t[m] + r_t[i] u[i] (dy_t . v_t)
//   dv_t[m] = sum_i dS[i][m] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[m]
//   dw_t[i] = sum_m dS[i][m] S_{t-1}[i][m]
//   du[i]  += r_t[i] k_t[i] (dy_t . v_t)          (over b and t)
//   dS      = w_t[i] dS[i][m] + r_t[i] dy_t[m]     (now dS_{t-1})
//
// and ds0 = dS at the end; all float32, in the model's [B, T, H, n]
// layout, read as it is.
//
// Bound.  r, k, v, w and dy are read once and dr, dk, dv and dw written
// once: 9 n floats a step and head (s0, dS_T, ds0 and du add O(n^2) a
// head).  The arithmetic is 14 n^2 + 16 n flops a step and head: the
// state's recurrence (k v, and an FMA) and dS's (r dy, and an FMA), an
// FMA each for dr, dk, dv and dw, and the O(n) sums and u terms.  At
// rwkv6-7b's training shape (B 4, T 2,048, H 64, n 64) that is 1.221 GB,
// 0.364 ms at 3.35 TB/s, against 30.6 GFLOP, 0.457 ms at the 67 TFLOP/s
// float32 rate: bound by operations.  The design below also reads the
// forward's checkpoints, 1.07 GB at that shape, so its own traffic is
// 2.29 GB, 0.68 ms at 3.35 TB/s.
//
// Design.  The walk back needs S_{t-1} beside dS_t, newest first.  Running
// the state backwards, S_{t-1} = (S_t - k v) / w_t, is unstable under
// strong decay, so the forward (under training) stores the state entering
// every kWkvChunk-th step, ck [B, H, ceil(T / kWkvChunk), n, n], and this
// kernel takes the chunks in reverse order: it recomputes one chunk's
// states from its checkpoint, then walks the chunk back.
//
// Rows over a cluster.  The rows of one (b, h)'s dS are split over a
// cluster of kCluster CTAs: at n = 64, 2 CTAs of 8 warps, rank c owning
// rows 32 c .. 32 c + 31, so rwkv6-7b's 256 heads are 512 CTAs.  A lane
// holds 8 columns of one row of dS in registers for the whole of T, as two
// runs of 4 (at 4 g and n / 2 + 4 g for its lane group g, so that a
// quarter warp's float4 loads of v and dy cover 32 neighbouring floats;
// on the lanes whose bit 3 is set the two runs trade places, see dv
// below); a row's columns lie across 8 neighbouring lanes and a warp
// holds 4 rows.  Each lane recomputes its 8 columns of the chunk's 8
// states into registers (st[j], fully unrolled): no state goes through
// shared memory.  With launch bounds for 16 warps an SM (128 registers a
// thread) and 86 KB of shared memory a CTA, 2 CTAs share an SM and the
// card holds 132 clusters at once, so the 512 CTAs take two waves of
// 16 warps an SM.  A cluster of 4 (4 warps a CTA, 4 an SM) fits only 124
// SMs with clusters (92 clusters at 3 CTAs an SM), so 1,024 CTAs take
// three waves: tools/wkv6_bwd_designs.py times both.
//
// No barrier a step.  The walk takes the chunk's steps in pairs.  Row i's
// dr (its state part, sum_m dy_t[m] S_{t-1}[i][m]), dk and dw are sums
// over the row's 8 lanes: a pair's six (and two zeros) go through one
// xor butterfly of 3 levels (xor_reduce: each level halves the values a
// lane holds, so 7 shuffles give each of 6 lanes one finished sum), and
// are stored to shared memory indexed by step.  dv sums over the rows: a
// pair's 16 values a lane (2 steps x 8 columns) go through a butterfly
// over the warp's 4 rows, whose first level needs no select because the
// partner lanes hold their runs swapped (12 shuffles), leaving each lane 4
// columns of one step; it sends them with one st.async (16 bytes) to the
// shared memory of the rank that owns those columns, [chunk parity][step]
// [sender rank][warp][32 columns], completing the bytes on that rank's
// mbarrier of the chunk parity.  Nothing waits for another thread during
// the walk.
//
// Once a chunk.  A block barrier (the row sums, and the checkpoint
// copies); a wait on the dv barrier, which completes when every warp of
// the cluster has sent its 4 columns of every step to this rank (16 KB);
// then the rank's outputs: its rows' dr (plus the u term u[i] k_t[i]
// (dy_t . v_t)), dk (plus r_t[i] u[i] (dy_t . v_t)) and dw, and its 32
// columns' dv, the 16 partial sums added in a fixed tree plus
// (sum_i r_t[i] u[i] k_t[i]) dy_t[m].  Then a relaxed cluster barrier:
// arrive after the outputs, wait after the CTA has prepared the next
// chunk, so that no rank sends a chunk's sums into a buffer another rank
// is still reading.  (A release arrive would fence the thread's global
// stores of the outputs too: a MEMBAR a chunk.)  dy . v and sum_i r_t[i]
// u[i] k_t[i], one number each a step, are summed once a chunk by every
// CTA from the full input rows, 32 lanes a step.
//
// Loads.  A chunk's r, k, v, w and dy (5 kWkvChunk rows of n floats, 10 KB
// at n = 64) arrive in one of three buffers by bulk copies that the first
// warp issues a chunk ahead, one a row, each multicast to both CTAs of the
// cluster (each rank issues half of the rows), completing on the buffer's
// mbarrier: each byte is read from L2 once a cluster and no other thread
// spends an instruction on it.  Steps past T are not copied: the prologue
// writes w = 1 and 0 for the rest, so that a step there leaves dS as it
// is and adds 0 to every sum, and the walk needs no test a step.  Each
// lane brings its 8 columns of the next chunk's checkpoint by cp.async
// into a double buffer of its own.
//
// du without atomics.  The thread that writes dr_t[i] also adds r_t[i]
// k_t[i] (dy_t . v_t) into a register, one register for each (step of a
// chunk, row) it owns, over the chunks in a fixed order; at the end the
// CTA adds its 8 step slots of each of its rows in order and writes the
// (b, h)'s du_part [B, H, n] for its rows; a second launch adds du_part
// over b in order.  Every sum is taken in one fixed order and no atomic
// is used, so a call repeats bit for bit.
//
// Smaller heads: n = 32 splits over 2 CTAs of 2 warps (8 rows a warp),
// n = 16 is one CTA of one warp (16 rows of 2 lanes), n = 8 one warp with
// 2 columns a lane (4 lanes a row, all 8 rows; its dv butterfly has no
// select-free level).
//
// Left for later: the shuffles of the two butterflies and the shared
// loads of v and dy (the MIO pipe) set the pace now, with 16 warps an SM
// each waiting on a chain of them; 2 rows x 4 columns a lane would halve
// the loads of v and dy for as many shuffles.  The checkpoints' 1.07 GB
// read is the design's largest single cost in bytes.

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "wkv6.cuh"        // kWkvChunk

namespace cg = cooperative_groups;

// CTAs a cluster at n = 64 (2 or 4), and the warps a multiprocessor the
// compiler must fit at n = 64 (__launch_bounds__: 16 caps a thread at 128
// registers); tools/wkv6_bwd_designs.py builds other settings
#ifndef WKV6_BWD_CLUSTER
#define WKV6_BWD_CLUSTER 2
#endif
#ifndef WKV6_BWD_MIN_WARPS
#define WKV6_BWD_MIN_WARPS 16
#endif

namespace {

constexpr int kCk = kWkvChunk;     // steps a chunk
constexpr int kArrays = 5;         // r, k, v, w, dy
constexpr int kInBufs = 3;         // input buffers: chunk c's in c % 3
constexpr int kSumThreads = 256;   // the du sum's block

// How one (b, h)'s dS [n, n] is split: a lane holds kLaneCols columns of
// one row, a row lies across kRowLanes neighbouring lanes, a warp holds
// kWarpRows rows, a CTA kCtaRows rows, and a cluster of kCluster CTAs all
// n rows.
template <int N> struct Split {
  static constexpr int kLaneCols = N >= 16 ? 8 : 2;
  static constexpr int kRowLanes = N / kLaneCols;     // 8, 4, 2, 4
  static constexpr int kWarpRows = 32 / kRowLanes;    // 4, 8, 16, 8
  static constexpr int kCluster = N == 64 ? WKV6_BWD_CLUSTER
                                  : N == 32 ? 2 : 1;
  static constexpr int kCtaRows = N / kCluster;
  static constexpr int kWarps = kCtaRows / kWarpRows;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCtaCols = N / kCluster;       // dv columns a CTA
  // launch bounds at n = 64 only: the smaller heads (test sizes) keep
  // their registers
  static constexpr int kMinBlocks =
      N == 64 && WKV6_BWD_MIN_WARPS / kWarps > 0 ? WKV6_BWD_MIN_WARPS / kWarps
                                                 : 1;
  // floats of dynamic shared memory: kInBufs input buffers [5][kCk][n];
  // two (by chunk parity) of the dv sums of this CTA's columns that every
  // warp of the cluster sends [kCk][ranks][warps][kCtaCols], and of the
  // rows' sums [3][kCk][kCtaRows] (dr's state part, dk, dw), and of the
  // chunk's checkpoint rows [kCtaRows][n]; u; two of each step's dy . v and
  // of its sum r u k; then the barriers (8 bytes each) that the dv sums
  // (two, by chunk parity) and the input buffers (three) complete on
  static constexpr int kInputs = kArrays * kCk * N;
  static constexpr int kColSums = kCk * kCluster * kWarps * kCtaCols;
  static constexpr int kRowSums = 3 * kCk * kCtaRows;
  static constexpr int kFloats = kInBufs * kInputs + 2 * kColSums +
                                 2 * kRowSums + 2 * kCtaRows * N + N +
                                 4 * kCk;
  static constexpr size_t kSmemBytes = 4 * static_cast<size_t>(kFloats) + 40;
  static_assert(kRowLanes * kLaneCols == N && kWarps * kWarpRows == kCtaRows
                    && kCluster * kCtaRows == N && kWarps >= 1,
                "the split covers dS");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// returns once none of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The two halves of a cluster barrier: arrive, releasing this thread's
// writes to the cluster (a fence that waits for its global stores too), or
// relaxed, ordering nothing; and wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address in CTA `rank` of the cluster of this CTA's shared address a
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrives on the barrier, expecting `bytes` more to complete its phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's phase of this parity has completed, with the
// cluster's writes that completed it visible
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global memory into shared memory at
// dst, completing them on the barrier bar: with kMulticast, into the same
// offsets (dst and bar) of the cluster's CTAs whose bits ctas sets
template <bool kMulticast>
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint16_t ctas) {
  if constexpr (kMulticast) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"(ctas)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// orders this thread's earlier shared-memory writes before later bulk
// copies into the same place
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K floats (2 or 4) into shared memory of a CTA of the cluster (a, from
// cluster_addr), completing their bytes on that CTA's barrier bar
template <int K>
__device__ __forceinline__ void st_async(uint32_t a, const float* x,
                                         uint32_t bar) {
  if constexpr (K == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(a),
        "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(bar)
        : "memory");
  } else {
    static_assert(K == 2, "two or four floats");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
        "[%0], {%1, %2}, [%3];\n" ::"r"(a),
        "f"(x[0]), "f"(x[1]), "r"(bar)
        : "memory");
  }
}

// A lane's kLaneCols columns of a row of n: at 8, two runs of 4 starting
// at lo and hi (lo = 4 g and hi = n / 2 + 4 g for lane group g, swapped
// on the lanes whose bit kRowLanes is set, so that dv's first butterfly
// level needs no select); at 2, one pair at lo = 2 g.
template <int C>
__device__ __forceinline__ void load_cols(const float* row, int lo, int hi,
                                          float (&x)[C]) {
  if constexpr (C == 8) {
    const float4 a = *reinterpret_cast<const float4*>(row + lo);
    const float4 b = *reinterpret_cast<const float4*>(row + hi);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(row + lo);
    x[0] = a.x; x[1] = a.y;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* row, int lo, int hi,
                                           const float (&x)[C]) {
  if constexpr (C == 8) {
    *reinterpret_cast<float4*>(row + lo) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(row + hi) = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    *reinterpret_cast<float2*>(row + lo) = make_float2(x[0], x[1]);
  }
}

// x[0 .. kCnt) summed over the lanes that differ in lane bits kMask,
// 2 kMask, ... below kEnd, in a fixed butterfly.  While a lane holds more
// than one value, a level halves them: the lane whose bit is set keeps the
// upper half, its partner the lower, and each adds the partner's copy of
// the half it keeps (so each sum is formed by one lane); with kSwapped the
// first level's lanes hold their halves swapped already, so every lane
// keeps the lower half and no select is needed.  After that a level adds
// the partner's value to its own (a + b and b + a: both lanes get the same
// bits).  On return x[0 .. xor_kept) holds the sums of values xor_first ..
// xor_first + xor_kept - 1 (of the lane's own order); the lanes that differ
// only in the bits of the adding levels hold the same sums, and each stores
// them (the same bits to the same address), so that no lane branches.
template <int kCnt, int kMask, int kEnd, bool kSwapped = false>
__device__ __forceinline__ void xor_reduce(float* x, int lane) {
  if constexpr (kMask < kEnd) {
    if constexpr (kCnt > 1) {
      constexpr int kHalf = kCnt / 2;
      const bool hi = !kSwapped && (lane & kMask) != 0;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const float keep = hi ? x[kHalf + j] : x[j];
        const float send = hi ? x[j] : x[kHalf + j];
        x[j] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
      }
      xor_reduce<kHalf, 2 * kMask, kEnd>(x, lane);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], kMask);
      xor_reduce<1, 2 * kMask, kEnd>(x, lane);
    }
  }
}

template <int kCnt, int kMask, int kEnd>
__host__ __device__ constexpr int xor_kept() {
  if constexpr (kMask < kEnd && kCnt > 1) {
    return xor_kept<kCnt / 2, 2 * kMask, kEnd>();
  } else {
    return kCnt;
  }
}

template <int kCnt, int kMask, int kEnd, bool kSwapped = false>
__device__ __forceinline__ int xor_first(int lane) {
  if constexpr (kMask < kEnd && kCnt > 1) {
    return ((!kSwapped && (lane & kMask)) ? kCnt / 2 : 0)
           + xor_first<kCnt / 2, 2 * kMask, kEnd>(lane);
  } else {
    return 0;
  }
}

template <int N>
__global__ void __launch_bounds__(Split<N>::kThreads, Split<N>::kMinBlocks)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ dy, const float* __restrict__ u,
                const float* __restrict__ ck, const float* __restrict__ dS_T,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ ds0, float* __restrict__ du_part, int T,
                int H) {
  using Sp = Split<N>;
  constexpr int C = Sp::kLaneCols;
  constexpr int kRL = Sp::kRowLanes;
  constexpr int R = Sp::kCtaRows;
  constexpr int CL = Sp::kCluster;
  constexpr int W = Sp::kWarps;
  constexpr int kThreads = Sp::kThreads;
  constexpr int kCC = Sp::kCtaCols;
  // the chunk's outputs a thread writes: (step, row) for dr, dk and dw,
  // (step, column) for dv
  constexpr int kRowJobs = kCk * R / kThreads;
  constexpr int kColJobs = kCk * kCC / kThreads;
  static_assert(kRowJobs * kThreads == kCk * R &&
                    kColJobs * kThreads == kCk * kCC,
                "outputs split evenly");
  // the per-step sums: kUG lanes sum one step's n products, kU each
  constexpr int kUG = kThreads / kCk;
  constexpr int kU = N / kUG;
  static_assert(kUG >= 2 && kUG <= 32 && kU * kUG == N, "per-step sums");
  // the butterflies of a pair of steps: over a row's kRL lanes, its dr
  // (the state part), dk and dw (and two zeros: 8 values); over the warp's
  // rows, dv (2 C values, the first level select-free where a lane holds 8
  // columns)
  constexpr bool kSwap = C == 8;
  constexpr int kRowKept = xor_kept<8, 1, kRL>();
  constexpr int kColKept = xor_kept<2 * C, kRL, 32>();
  static_assert(kCk % 2 == 0, "the walk takes steps in pairs");

  extern __shared__ __align__(16) float smem[];
  float* in = smem;                                // [3][5][kCk][n]
  float* cols = in + kInBufs * Sp::kInputs;        // [2][kCk][CL][W][kCC]
  float* rows = cols + 2 * Sp::kColSums;           // [2][3][kCk][R]
  float* ckb = rows + 2 * Sp::kRowSums;            // [2][R][n]
  float* su = ckb + 2 * R * N;                     // [n]
  float* svy = su + N;                             // [2][kCk]
  float* sruk = svy + 2 * kCk;                     // [2][kCk]
  const uint32_t full = smem_addr(smem + Sp::kFloats);       // [2] barriers
  const uint32_t inb = full + 16;                              // [3] barriers

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = CL > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int bh = blockIdx.x / CL;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane % kRL;                        // lane group (columns)
  const int rw = lane / kRL;                       // row in the warp
  const int row = warp * Sp::kWarpRows + rw;       // row in the CTA
  const int i = rank * R + row;                    // row of dS
  const bool swapped = kSwap && (lane & kRL) != 0;
  const int lo = C == 8 ? (swapped ? N / 2 + 4 * g : 4 * g) : 2 * g;
  const int hi = swapped ? 4 * g : N / 2 + 4 * g;
  // the first of the butterflies' sums this lane holds
  const int row_first = xor_first<8, 1, kRL>(lane);
  const int col_first = xor_first<2 * C, kRL, 32, kSwap>(lane);
  // A pair's dv values are [run][step of the pair][4] (8 columns) or
  // [step of the pair][2] (2 columns), the pair's later step first.  This
  // lane's kept ones are one step's (the earlier one when col_sp is 1)
  // columns col0 ..; they go to the rank owning them, into its buffer
  // [.][.][this rank][this warp][column - that rank's first]
  const int col_sp = (C == 8 ? col_first / 4 : col_first / 2) % 2;
  const int col0 = lo + (C == 8 ? col_first % 4 : col_first % 2);
  const int owner = col0 / kCC;
  const int col_off = ((rank * W + warp) * kCC + col0 - owner * kCC);
  const size_t stride = static_cast<size_t>(H) * N;         // one step
  const size_t base = static_cast<size_t>(b) * T * stride
                      + static_cast<size_t>(h) * N;         // (b, 0, h, 0)
  const int n_ck = (T + kCk - 1) / kCk;
  const size_t bh_state = static_cast<size_t>(bh) * N * N;
  const float* ck_row = ck + bh_state * n_ck + static_cast<size_t>(i) * N;
  // chunk c's checkpoint, this lane's columns, into its row of ckb's
  // buffer c & 1 (no other lane reads them)
  auto ck_mine = [&](int c) { return ckb + ((c & 1) * R + row) * N; };
  auto fetch_ck = [&](int c) {
    const float* src = ck_row + static_cast<size_t>(c) * N * N;
    float* dst = ck_mine(c);
    if constexpr (C == 8) {
      cp_async16(dst + lo, src + lo, 16);
      cp_async16(dst + hi, src + hi, 16);
    } else {
      cp_async8(dst + lo, src + lo);
    }
    cp_async_commit();
  };

  for (int x = tid; x < N; x += kThreads) su[x] = u[h * N + x];

  float gs[C];                                     // dS[i][the lane's cols]
  if (dS_T != nullptr) {
    load_cols<C>(dS_T + bh_state + static_cast<size_t>(i) * N, lo, hi, gs);
  } else {
#pragma unroll
    for (int e = 0; e < C; ++e) gs[e] = 0.0f;
  }
  float du_acc[kRowJobs];
#pragma unroll
  for (int z = 0; z < kRowJobs; ++z) du_acc[z] = 0.0f;

  // chunk c's r, k, v, w and dy into input buffer c % 3, one bulk copy a
  // row of n floats issued by the first warp, multicast to the cluster:
  // rank q issues the rows x (= 8 array + step) with x % CL == q, and each
  // CTA's barrier of the buffer expects all of them.  Rows past T are not
  // copied (the prologue fills them)
  auto load_inputs = [&](int c) {
    if (warp != 0) return;
    const int steps = min(kCk, T - c * kCk);
    const uint32_t dst = smem_addr(in + (c % kInBufs) * Sp::kInputs);
    const uint32_t bar = inb + 8 * (c % kInBufs);
    if (lane == 0) mbar_expect_tx(bar, 4 * kArrays * steps * N);
    for (int x = lane; x < kArrays * kCk; x += 32) {
      const int a = x / kCk, j = x % kCk;
      if (j < steps && x % CL == rank) {
        const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v
                           : a == 3 ? w : dy;
        bulk_load<(CL > 1)>(
            dst + 4 * x * N,
            src + base + static_cast<size_t>(c * kCk + j) * stride, 4 * N,
            bar, (1u << CL) - 1);
      }
    }
  };
  // waits for chunk c's inputs (its use of its buffer's barrier)
  auto wait_inputs = [&](int c) {
    mbar_wait(inb + 8 * (c % kInBufs), ((n_ck - 1 - c) / kInBufs) & 1);
  };

  // dy_t . v_t and sum_i r_t[i] u[i] k_t[i] for each step of chunk c
  auto step_sums = [&](int c) {
    const float* sr = in + (c % kInBufs) * Sp::kInputs;
    const float* sk = sr + kCk * N;
    const float* sv = sk + kCk * N;
    const float* sdy = sv + 2 * kCk * N;
    const int j = tid / kUG, uc = tid % kUG;
    float sums[2] = {0.0f, 0.0f};                  // dy . v, sum r u k
#pragma unroll
    for (int e = 0; e < kU; ++e) {
      const int x = j * N + uc * kU + e;
      sums[0] += sv[x] * sdy[x];
      sums[1] += sr[x] * su[uc * kU + e] * sk[x];
    }
    // over the step's kUG lanes: the lanes with bit 0 set end with the
    // second sum
    xor_reduce<2, 1, kUG>(sums, lane);
    if (uc < 2) (uc == 0 ? svy : sruk)[(c & 1) * kCk + j] = sums[0];
  };

  // chunk c's states at this lane's columns of row i, from its checkpoint
  // (fetched by fetch_ck): st[j] the state entering step t0 + j (past T,
  // the last one)
  float st[kCk][C];
  auto recompute = [&](int c) {
    const float* sk = in + (c % kInBufs) * Sp::kInputs + kCk * N;
    const float* sv = sk + kCk * N;
    const float* sw = sv + kCk * N;
    float s[C];
    load_cols<C>(ck_mine(c), lo, hi, s);
#pragma unroll
    for (int j = 0; j < kCk; ++j) {
#pragma unroll
      for (int e = 0; e < C; ++e) st[j][e] = s[e];
      if (j + 1 < kCk) {
        const float kk = sk[j * N + i], ww = sw[j * N + i];
        float vc[C];
        load_cols<C>(sv + j * N, lo, hi, vc);
#pragma unroll
        for (int e = 0; e < C; ++e) s[e] = ww * s[e] + kk * vc[e];
      }
    }
  };

  // the input buffers' barriers (armed by load_inputs) and the dv sums'
  // barriers, each armed for the bytes of one chunk: the first two
  // chunks' here, each later one's once its buffer has been read
  constexpr uint32_t kChunkBytes = 4 * kCk * CL * W * kCC;
  if (tid == 0) {
    for (int q = 0; q < kInBufs; ++q) mbar_init(inb + 8 * q, 1);
    if constexpr (CL > 1) {
      mbar_init(full, 1);
      mbar_init(full + 8, 1);
      for (int c = n_ck - 1; c >= 0 && c >= n_ck - 2; --c)
        mbar_expect_tx(full + 8 * (c & 1), kChunkBytes);
    }
  }
  // every rank's barriers are set before any rank sends to them
  if constexpr (CL > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  const uint32_t to_cols = CL > 1 ? cluster_addr(smem_addr(cols), owner) : 0;
  const uint32_t to_full = CL > 1 ? cluster_addr(full, owner) : 0;

  if (n_ck > 0) {
    load_inputs(n_ck - 1);
    if (n_ck > 1) load_inputs(n_ck - 2);
    fetch_ck(n_ck - 1);
    // past T, w is 1 and the rest 0, so that a step there leaves dS as it
    // is and adds 0 to the sums, and the walk needs no test a step
    const int steps = T - (n_ck - 1) * kCk;
    float* tail = in + ((n_ck - 1) % kInBufs) * Sp::kInputs;
    for (int x = tid; x < kArrays * kCk * N; x += kThreads) {
      const int a = x / (kCk * N), j = (x / N) % kCk;
      if (j >= steps) tail[x] = a == 3 ? 1.0f : 0.0f;
    }
    fence_proxy_async();
    cp_async_wait_all();
    wait_inputs(n_ck - 1);
    __syncthreads();               // the first chunk's inputs, its tail, u
    step_sums(n_ck - 1);
    recompute(n_ck - 1);
    if (n_ck > 1) fetch_ck(n_ck - 2);
  }

  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kCk;
    const int steps = min(kCk, T - t0);
    const int par = c & 1;
    const float* sr = in + (c % kInBufs) * Sp::kInputs;
    const float* sk = sr + kCk * N;
    const float* sv = sk + kCk * N;
    const float* sw = sv + kCk * N;
    const float* sdy = sw + kCk * N;
    float* col_s = cols + par * Sp::kColSums;
    float* row_s = rows + par * Sp::kRowSums;
    const uint32_t to_col_s = to_cols + 4 * par * Sp::kColSums;

    // the walk back through chunk c, a pair of steps at a time (the later
    // step first): no thread waits for another, and no lane branches
    // (steps past T change nothing that is written out)
#pragma unroll
    for (int jp = kCk / 2 - 1; jp >= 0; --jp) {
      // x: this lane's parts of row i's dr (the state part), dk and dw of
      // the pair's steps, [step of the pair][3], and two zeros; pvp: its
      // dv parts, [run][step of the pair][4] or [step of the pair][2]
      float x[8];
      float pvp[2 * C];
#pragma unroll
      for (int sp = 0; sp < 2; ++sp) {
        const int j = 2 * jp + 1 - sp;
        const float rr = sr[j * N + i], kk = sk[j * N + i];
        const float ww = sw[j * N + i];
        float vc[C], yc[C];
        load_cols<C>(sv + j * N, lo, hi, vc);
        load_cols<C>(sdy + j * N, lo, hi, yc);
        x[3 * sp] = x[3 * sp + 1] = x[3 * sp + 2] = 0.0f;
#pragma unroll
        for (int e = 0; e < C; ++e) {
          x[3 * sp] += yc[e] * st[j][e];
          x[3 * sp + 1] += gs[e] * vc[e];
          x[3 * sp + 2] += gs[e] * st[j][e];
          pvp[C == 8 ? (e / 4) * 8 + sp * 4 + e % 4 : sp * C + e] =
              gs[e] * kk;
          gs[e] = ww * gs[e] + rr * yc[e];
        }
      }
      // dr, dk and dw over the row's kRL lanes: each of the pair's six
      // sums is stored by the lanes that end with it (the zeros' lanes
      // store nothing)
      x[6] = x[7] = 0.0f;
      xor_reduce<8, 1, kRL>(x, lane);
#pragma unroll
      for (int q = 0; q < kRowKept; ++q) {
        const int val = row_first + q;             // 3 (step of pair) + p
        if (val < 6)
          row_s[((val % 3) * kCk + 2 * jp + 1 - val / 3) * R + row] = x[q];
      }
      // dv over the warp's rows, to the rank that owns the columns
      xor_reduce<2 * C, kRL, 32, kSwap>(pvp, lane);
      constexpr int kStep = CL * W * kCC;          // floats a step
      const int jd = 2 * jp + 1 - col_sp;
      if constexpr (CL > 1) {
        st_async<kColKept>(to_col_s + 4 * (jd * kStep + col_off), pvp,
                           to_full + 8 * par);
      } else {
#pragma unroll
        for (int q = 0; q < kColKept; ++q)
          col_s[jd * kStep + col_off + q] = pvp[q];
      }
    }

    // chunk c - 1's inputs (this thread's copies) have landed; after the
    // block barrier they, this chunk's row sums and its step sums are
    // visible to the CTA; after the barrier's phase for chunk c, every
    // rank's dv sums of this rank's columns are.  Then it is re-armed for
    // chunk c - 2, whose sums no rank sends before every rank has passed
    // the cluster barrier below (in chunk c - 1).
    cp_async_wait_all();
    __syncthreads();
    if constexpr (CL > 1) {
      mbar_wait(full + 8 * par, ((n_ck - 1 - c) >> 1) & 1);
      if (tid == 0 && c >= 2) mbar_expect_tx(full + 8 * par, kChunkBytes);
    }

    // this rank's outputs of chunk c
    const float* vy_s = svy + par * kCk;
    const float* ruk_s = sruk + par * kCk;
    const size_t out = base + static_cast<size_t>(t0) * stride;
#pragma unroll
    for (int z = 0; z < kRowJobs; ++z) {
      const int x = tid + z * kThreads;
      const int j = x / R, ro = x % R;
      if (j < steps) {
        const int ii = rank * R + ro;
        const float vy = vy_s[j];
        const float ri = sr[j * N + ii], ki = sk[j * N + ii];
        const size_t o = out + static_cast<size_t>(j) * stride + ii;
        dr[o] = row_s[j * R + ro] + su[ii] * ki * vy;
        dk[o] = row_s[(kCk + j) * R + ro] + ri * su[ii] * vy;
        dw[o] = row_s[(2 * kCk + j) * R + ro];
        du_acc[z] += ri * ki * vy;
      }
    }
#pragma unroll
    for (int z = 0; z < kColJobs; ++z) {
      const int x = tid + z * kThreads;
      const int j = x / kCC, m = rank * kCC + x % kCC;
      if (j < steps) {
        float acc = ruk_s[j] * sdy[j * N + m];
        const float* sums = col_s + j * CL * W * kCC + x % kCC;
#pragma unroll
        for (int q = 0; q < CL * W; ++q) acc += sums[q * kCC];
        dv[out + static_cast<size_t>(j) * stride + m] = acc;
      }
    }

    // Every rank has read its dv sums of chunk c before any rank sends
    // chunk c - 2's into the same buffers (in the walk after next): a
    // relaxed cluster barrier, whose wait comes after the CTA prepares
    // chunk c - 1.  Buffer (c - 2) % 3 was last read by chunk c + 1's
    // outputs, finished before the block barrier above.
    if constexpr (CL > 1) cluster_arrive_relaxed();
    if (c > 0) {
      if (c > 1) load_inputs(c - 2);
      wait_inputs(c - 1);
      step_sums(c - 1);
      recompute(c - 1);
      if (c > 1) fetch_ck(c - 2);
    }
    if constexpr (CL > 1) cluster_wait();
  }

  store_cols<C>(ds0 + bh_state + static_cast<size_t>(i) * N, lo, hi, gs);
  // every thread is done with the row sums, whose buffer now takes du's
  // step slots [kCk][R]
  __syncthreads();
#pragma unroll
  for (int z = 0; z < kRowJobs; ++z) rows[tid + z * kThreads] = du_acc[z];
  __syncthreads();
  for (int x = tid; x < R; x += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kCk; ++j) s += rows[j * R + x];
    du_part[static_cast<size_t>(bh) * N + rank * R + x] = s;
  }
}

// du[h, i] = sum over b of du_part[b, h, i], in order of b
__global__ void __launch_bounds__(kSumThreads)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                   int B, int HN) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= HN) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += du_part[static_cast<size_t>(b) * HN + i];
  du[i] = s;
}

// the walk back's launch configuration for `ctas` CTAs (a multiple of the
// cluster), after allowing its dynamic shared memory
template <int N>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int ctas, cudaStream_t s) {
  using Sp = Split<N>;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sp::kSmemBytes));
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas);
  cfg->blockDim = dim3(Sp::kThreads);
  cfg->dynamicSmemBytes = Sp::kSmemBytes;
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Sp::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* dy, const void* u, const void* ck, const void* dS_T,
           void* dr, void* dk, void* dv, void* dw, void* ds0, void* du,
           void* du_part, int B, int T, int H, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<N>(&cfg, attr, B * H * Split<N>::kCluster, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &cfg, wkv6_bwd_kernel<N>, static_cast<const float*>(r),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(dy),
      static_cast<const float*>(u), static_cast<const float*>(ck),
      static_cast<const float*>(dS_T), static_cast<float*>(dr),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dw), static_cast<float*>(ds0),
      static_cast<float*>(du_part), T, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hn = H * N;
  wkv6_bwd_du_kernel<<<(hn + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                       s>>>(static_cast<const float*>(du_part),
                            static_cast<float*>(du), B, hn);
  return static_cast<int>(cudaGetLastError());
}

// out[0..6]: the walk back's registers a thread, static and dynamic shared
// memory a CTA (bytes), threads a CTA, CTAs a cluster, CTAs a
// multiprocessor (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// clusters resident on the whole card at once (cudaOccupancyMaxActive
// Clusters)
template <int N>
int occupancy(int* out) {
  using Sp = Split<N>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<N>(&cfg, attr, Sp::kCluster, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, wkv6_bwd_kernel<N>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wkv6_bwd_kernel<N>, Sp::kThreads, Sp::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveClusters(&clusters, wkv6_bwd_kernel<N>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(Sp::kSmemBytes);
  out[3] = Sp::kThreads;
  out[4] = Sp::kCluster;
  out[5] = per_sm;
  out[6] = clusters;
  return 0;
}

}  // namespace

// Two launches on ``stream``: the walk back, then du's sum over b.  n must
// be one of 8, 16, 32, 64 (the wrapper checks); B * H > 0; any T >= 0.
// r, k, v, w, dy, dr, dk, dv, dw: [B, T, H, n]; u, du: [H, n]; ck: [B, H,
// ceil(T / kWkvChunk), n, n], the forward's checkpoints; dS_T (null:
// zeros), ds0: [B, H, n, n]; du_part: [B, H, n] scratch; all float32,
// contiguous, 16-byte aligned.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* dy, const void* u,
                               const void* ck, const void* dS_T, void* dr,
                               void* dk, void* dv, void* dw, void* ds0,
                               void* du, void* du_part, int B, int T, int H,
                               int N, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
#define WKV6_BWD_CASE(n)                                                    \
  case n:                                                                   \
    return launch<n>(r, k, v, w, dy, u, ck, dS_T, dr, dk, dv, dw, ds0, du, \
                     du_part, B, T, H, s);
    WKV6_BWD_CASE(8)
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
#undef WKV6_BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The walk back's occupancy at head size N into out[0..6] (see occupancy
// above); returns a cudaError_t.
extern "C" int wkv6_bwd_occupancy(int N, int* out) {
  switch (N) {
    case 8: return occupancy<8>(out);
    case 16: return occupancy<16>(out);
    case 32: return occupancy<32>(out);
    case 64: return occupancy<64>(out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
