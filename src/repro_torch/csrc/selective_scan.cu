// Selective scan (the Mamba/Hymba SSM recurrence), forward only, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel selective_scan_pallas
// (src/repro/kernels/selective_scan/kernel.py):
//
//   h_t = a_t * h_{t-1} + b_t          (elementwise over [D, N])
//   y_t[d] = sum_n C_t[n] * h_t[d, n]
//
// with h_{-1} = h0, returning y [B, T, D] and h_last = h_{T-1} [B, D, N], all
// float32.  a, b are [B, T, D, N], C is [B, T, N], h0 [B, D, N], contiguous.
// For training, a non-null hck [B, ceil(T / kScanChunk), D, N] also gets the
// state entering each chunk of kScanChunk steps (hck[:, 0] = h0), from
// which selective_scan_bwd.cu recomputes h; serving passes null and moves
// no more bytes.
//
// Bound: bytes.  Every value of a and b is read once for one multiply-add,
// so the kernel moves 2*B*T*D*N*4 bytes for 4*B*T*D*N flops.  At
// hymba-1.5b's prefill shape (B 4, T 2,048, D 3,200, N 16) that is 3.46 GB
// in all, 1.03 ms at 3.35 TB/s, against 0.03 ms of float32 arithmetic.
//
// Design.  The TPU kernel cuts T into chunks and expands each chunk into a
// masked-exponent pairwise form so that the recurrence fills the TPU's
// vector unit.  The card has no need of that: the B*D*N lanes of the
// recurrence are independent (204,800 at the shape above, enough to fill
// 132 SMs), so one thread owns one (b, d, n) lane, keeps h in a register
// and walks T in order.  n is the innermost index, so the 32 threads of a
// warp read 32 consecutive floats of a and of b at each step: coalesced
// 128-byte loads.  Each thread loads kSteps steps of a, b and C ahead into
// registers before it uses them, so many loads are in flight per thread and
// the memory system, not the latency of one load, sets the pace.  The sum
// over n meets in log2(N) xor-shuffles among the N lanes of one d (N
// divides 32, so those lanes never straddle a warp), and the lane with
// n == 0 stores y.  h0 is read and h_last written once per lane.
//
// Lanes past B*D*N (when D*N is not a multiple of the block) still walk the
// loop, with their loads and stores masked, so every lane of a warp
// reaches every shuffle.  Overlapped loads through TMA, and a fused form
// that reads dt, A, B and u in place of the materialised a and b (which
// carry 97% of the bytes), are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "selective_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = kScanChunk;   // steps of a, b, C loaded ahead

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ C,
                      const float* __restrict__ h0,
                      float* __restrict__ y,
                      float* __restrict__ h_last,
                      float* __restrict__ hck, int T, int D) {
  const int DN = D * N;
  const int lane = blockIdx.x * kThreads + threadIdx.x;   // d * N + n
  const int bi = blockIdx.y;
  const bool valid = lane < DN;
  const int n = lane % N;
  const int d = lane / N;
  const size_t state = static_cast<size_t>(bi) * DN + lane;
  const size_t seq = static_cast<size_t>(bi) * T;         // row (bi, t=0)
  const float* pa = a + seq * DN + lane;
  const float* pb = b + seq * DN + lane;
  const float* pc = C + seq * N + n;
  float* py = y + seq * D + d;
  const size_t n_ck = (static_cast<size_t>(T) + kSteps - 1) / kSteps;
  float* pck = hck ? hck + static_cast<size_t>(bi) * n_ck * DN + lane
                   : nullptr;

  float h = valid ? h0[state] : 0.0f;
  for (int t0 = 0; t0 < T; t0 += kSteps) {
    if (pck && valid) pck[static_cast<size_t>(t0 / kSteps) * DN] = h;
    float ra[kSteps], rb[kSteps], rc[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int t = t0 + j;
      if (valid && t < T) {
        const size_t off = static_cast<size_t>(t) * DN;
        ra[j] = __ldcs(pa + off);      // read once: stream past the caches
        rb[j] = __ldcs(pb + off);
        rc[j] = __ldg(pc + static_cast<size_t>(t) * N);
      } else {
        ra[j] = 1.0f;
        rb[j] = 0.0f;
        rc[j] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      h = fmaf(ra[j], h, rb[j]);
      float s = rc[j] * h;
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int t = t0 + j;
      if (valid && n == 0 && t < T) py[static_cast<size_t>(t) * D] = s;
    }
  }
  if (valid) h_last[state] = h;
}

template <int N>
int launch(const void* a, const void* b, const void* C, const void* h0,
           void* y, void* h_last, void* hck, int B, int T, int D,
           cudaStream_t s) {
  const dim3 grid((D * N + kThreads - 1) / kThreads, B);
  selective_scan_kernel<N><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(C), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last),
      static_cast<float*>(hck), T, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N must divide 32 (the wrapper checks); any other N is refused.  hck may
// be null (serving).
extern "C" int selective_scan_launch(const void* a, const void* b,
                                     const void* C, const void* h0, void* y,
                                     void* h_last, void* hck, int B, int T,
                                     int D, int N, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(a, b, C, h0, y, h_last, hck, B, T, D, s);
    case 2: return launch<2>(a, b, C, h0, y, h_last, hck, B, T, D, s);
    case 4: return launch<4>(a, b, C, h0, y, h_last, hck, B, T, D, s);
    case 8: return launch<8>(a, b, C, h0, y, h_last, hck, B, T, D, s);
    case 16: return launch<16>(a, b, C, h0, y, h_last, hck, B, T, D, s);
    case 32: return launch<32>(a, b, C, h0, y, h_last, hck, B, T, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
