// Selective scan (the Mamba/Hymba SSM recurrence), backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel and
// differentiates its lax.scan (src/repro/models/ssm.py:109-120) with
// jax.value_and_grad.  This is the gradient of selective_scan.cu's
// function
//
//   h_t = a_t * h_{t-1} + b_t,   y_t[d] = sum_n C_t[n] * h_t[d, n]
//
// given dy [B, T, D] and dh_last [B, D, N] (null: zeros):
//
//   g_t    = a_{t+1} * g_{t+1} + dy_t[d] * C_t[n]   (g_{T-1}: + dh_last)
//   da_t   = g_t * h_{t-1}          (h_{-1} = h0)
//   db_t   = g_t
//   dC_t[n] = sum_d dy_t[d] * h_t[d, n]
//   dh0    = a_0 * g_0
//
// all float32; a, b, da, db are [B, T, D, N], C and dC [B, T, N].
//
// Bound: bytes.  a and b are read once and da and db written once, four
// passes over [B, T, D, N] for about eight flops an element.  At
// hymba-1.5b's training shape (B 4, T 2,048, D 3,200, N 16) one such
// float32 tensor is 1,677,721,600 bytes, so the four passes are 6.71 GB,
// 2.00 ms at 3.35 TB/s; dy and C add about 0.03 ms, and the 3.4 GFLOP take
// 0.05 ms of float32 arithmetic.
//
// Design.  The walk back needs h_{t-1} at every step, newest first.  The
// forward (under training) stores h at the start of every chunk of
// kScanChunk steps (hck [B, ceil(T / kScanChunk), D, N], 1/16 of a pass).
// As in the forward, one thread owns one (b, d, n) lane, n innermost, so a
// warp's loads and stores of a, b, da, db are 128 coalesced bytes.  A
// thread takes the chunks in reverse order: it loads the chunk's a, b, dy
// and C into registers (all loads in flight before the first use),
// recomputes the chunk's h from its checkpoint in registers, then walks
// the chunk back carrying g, writing da and db as it goes.  So a and b are
// read once, da and db written once, and h never reaches device memory:
// the four passes of the bound, plus the checkpoints.
//
// dC sums over D = 3,200 channels without atomics.  At each step the lanes
// of one n in a warp meet in xor-shuffles (offsets N..16), each warp puts
// its N sums in shared memory, and after the chunk the block adds its
// warps' sums in warp order into its own slice of a workspace, part [B,
// blocks, T, N].  A second launch adds the blocks' slices in block order.
// Every sum is taken in one fixed order, so a call repeats bit for bit.
//
// Ragged edges: steps past T in the last chunk load a = 1, b = 0 and are
// skipped on the way back (t is uniform across a block); lanes past D*N
// (when D*N is not a multiple of the block) load nothing, contribute 0,
// and still reach every shuffle and barrier.  Offsets into [B, T, D, N]
// are 64-bit.  Overlapped loads through TMA, a scan split along T, and the
// fused form that reads dt, A, B and u in place of a and b are later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "selective_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kScanChunk;
constexpr int kSumThreads = 256;     // the second launch's block

int blocks_per_row(int D, int N) { return (D * N + kThreads - 1) / kThreads; }

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ C,
                          const float* __restrict__ hck,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, float* __restrict__ part,
                          int T, int D) {
  __shared__ float red[kChunk][kWarps][N];     // each warp's dC sums
  const int DN = D * N;
  const int lane = blockIdx.x * kThreads + threadIdx.x;   // d * N + n
  const int bi = blockIdx.y;
  const bool valid = lane < DN;
  const int n = lane % N;
  const int d = lane / N;
  const int warp = threadIdx.x / 32;
  const int wl = threadIdx.x % 32;
  const size_t state = static_cast<size_t>(bi) * DN + lane;
  const size_t seq = static_cast<size_t>(bi) * T;         // row (bi, t=0)
  const int n_ck = (T + kChunk - 1) / kChunk;
  const float* pa = a + seq * DN + lane;
  const float* pb = b + seq * DN + lane;
  float* pda = da + seq * DN + lane;
  float* pdb = db + seq * DN + lane;
  const float* pck = hck + static_cast<size_t>(bi) * n_ck * DN + lane;
  const float* pdy = dy + seq * D + d;
  const float* pc = C + seq * N + n;
  // this block's [T, N] slice of the dC workspace
  float* pp = part + (static_cast<size_t>(bi) * gridDim.x + blockIdx.x) *
                         static_cast<size_t>(T) * N;

  // a_{t+1} * g_{t+1}, dh_last at t = T - 1
  float carry = (valid && dh_last) ? dh_last[state] : 0.0f;
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    float ra[kChunk], rh[kChunk], rdy[kChunk], rc[kChunk];
    {
      float rb[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int t = t0 + j;
        if (valid && t < T) {
          const size_t off = static_cast<size_t>(t) * DN;
          ra[j] = __ldcs(pa + off);    // read once: stream past the caches
          rb[j] = __ldcs(pb + off);
          rdy[j] = __ldg(pdy + static_cast<size_t>(t) * D);
          rc[j] = __ldg(pc + static_cast<size_t>(t) * N);
        } else {
          ra[j] = 1.0f;
          rb[j] = 0.0f;
          rdy[j] = 0.0f;
          rc[j] = 0.0f;
        }
      }
      float h = valid ? __ldcs(pck + static_cast<size_t>(c) * DN) : 0.0f;
      rh[0] = h;                       // rh[j] = h_{t0+j-1} until shifted
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        h = fmaf(ra[j], h, rb[j]);
        if (j + 1 < kChunk) rh[j + 1] = h;
      }
      // rh[j] holds h_{t0+j-1}; h holds h_{t0+kChunk-1}
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j) {
        const int t = t0 + j;
        if (t < T) {                   // uniform across the block
          const float hp = rh[j];
          const float ht = (j + 1 < kChunk) ? rh[j + 1] : h;
          const float g = fmaf(rdy[j], rc[j], carry);
          if (valid) {
            const size_t off = static_cast<size_t>(t) * DN;
            __stcs(pda + off, g * hp);
            __stcs(pdb + off, g);
          }
          float s = rdy[j] * ht;       // 0 on lanes past D*N
#pragma unroll
          for (int o = 16; o >= N; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (wl < N) red[j][warp][wl] = s;
          carry = ra[j] * g;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int j = i / N;
      const int t = t0 + j;
      if (t < T) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[j][w][i % N];
        pp[static_cast<size_t>(t) * N + i % N] = s;
      }
    }
    __syncthreads();
  }
  if (valid) dh0[state] = carry;
}

// dC[bi, t, n] = sum over the blocks of part[bi, block, t, n], in block
// order: one thread an element of dC.
__global__ void __launch_bounds__(kSumThreads)
selective_scan_bwd_dc_kernel(const float* __restrict__ part,
                             float* __restrict__ dC, int B, int TN,
                             int blocks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= static_cast<size_t>(B) * TN) return;
  const size_t bi = i / TN;
  const size_t r = i % TN;
  const float* p = part + bi * blocks * static_cast<size_t>(TN) + r;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += p[static_cast<size_t>(k) * TN];
  dC[i] = s;
}

template <int N>
int launch(const void* a, const void* b, const void* C, const void* hck,
           const void* dy, const void* dh_last, void* da, void* db, void* dC,
           void* dh0, void* part, int B, int T, int D, cudaStream_t s) {
  const int blocks = blocks_per_row(D, N);
  selective_scan_bwd_kernel<N><<<dim3(blocks, B), kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(C), static_cast<const float*>(hck),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last),
      static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dh0), static_cast<float*>(part), T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * T * N;
  const unsigned grid = static_cast<unsigned>((n + kSumThreads - 1) /
                                              kSumThreads);
  selective_scan_bwd_dc_kernel<<<grid, kSumThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dC), B, T * N,
      blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the dC workspace ``part`` that a call at this shape needs.
extern "C" long long selective_scan_bwd_workspace(int B, int T, int D,
                                                  int N) {
  return static_cast<long long>(B) * blocks_per_row(D, N) * T * N;
}

// Two launches on ``stream``: the walk back, then dC's sum over blocks.
// T > 0, B*D*N > 0, N divides 32 (the wrapper checks); dh_last may be null.
extern "C" int selective_scan_bwd_launch(
    const void* a, const void* b, const void* C, const void* hck,
    const void* dy, const void* dh_last, void* da, void* db, void* dC,
    void* dh0, void* part, int B, int T, int D, int N, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
#define SCAN_BWD_CASE(n)                                                  \
  case n:                                                                 \
    return launch<n>(a, b, C, hck, dy, dh_last, da, db, dC, dh0, part, B, \
                     T, D, s);
    SCAN_BWD_CASE(1)
    SCAN_BWD_CASE(2)
    SCAN_BWD_CASE(4)
    SCAN_BWD_CASE(8)
    SCAN_BWD_CASE(16)
    SCAN_BWD_CASE(32)
#undef SCAN_BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
