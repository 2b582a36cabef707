// RWKV-6 WKV recurrence (data-dependent decay), forward only, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel wkv6_pallas (src/repro/kernels/rwkv6_wkv/kernel.py):
//
//   y_t[m]   = sum_i r_t[i] * S[i][m] + v_t[m] * sum_i r_t[i] * u[i] * k_t[i]
//   S[i][m] <- w_t[i] * S[i][m] + k_t[i] * v_t[m]
//
// for every (batch b, head h), from S = s0[b, h], returning y [B, T, H, n]
// and S_final [B, H, n, n], all float32.  r, k, v and w are [B, T, H, n]
// (the model's layout, read as it is), u is [H, n] and s0 [B, H, n, n]
// with S[i][m] at i * n + m; all contiguous.  The u term is the oracle's
// sum_i r_t[i] * u[i] * k_t[i] * v_t[m] with the O(n) factor taken out,
// as the TPU kernel takes it out.
//
// Bound: bytes.  Each step of each head does 5*n*n flops (k*v and an FMA
// for the state, an FMA for y) plus 5*n for the u term, on 5*n floats
// moved (r, k, v, w read, y written).  At rwkv6-7b's prefill shape (B 4,
// T 2,048, H 64, n 64) that is 10.9 GFLOP, 0.163 ms at the 67 TFLOP/s
// float32 rate, against 679.5 MB, 0.203 ms at 3.35 TB/s.
//
// Design.  The TPU kernel cuts T into chunks and expands each chunk into
// a masked-exponent pairwise form, so that T sequential [n, n] updates
// become dense [c, .] products for the TPU's matrix unit.  The card needs
// none of that: column m of the state, S[:, m], evolves on its own, and
// its update needs r_t, k_t, w_t (indexed by the row i) and the single
// value v_t[m].  So one block of n threads owns one (b, h); thread m holds
// S[:, m] in n registers for the whole of T and walks the steps in order,
// in exact float32.  No chunks means any T works (a ragged T, T = 1,
// T = 0) and decays of any size need no clamping.
//
// Loads.  Each round stages kSteps steps of r, k and w (the n values that
// every thread reads) in shared memory, where all threads read the same
// address at once (a broadcast) as float4.  Thread m keeps its own v_t[m]
// in a register.  The next round's values are loaded into registers right
// after the round's barrier, so they are in flight while the current
// round's steps run, and stored into the other of two shared buffers at
// the start of the next round: one barrier a round suffices, because a
// buffer is rewritten only after every thread has passed the barrier that
// follows its last use.  At that store thread m also forms
// r_t[m] * u[m] * k_t[m], and a warp-shuffle sum (one partial per warp in
// shared memory) gives each step's u term once for the block.  Per state
// element a step then costs three instructions (k*v, the state's FMA,
// y's FMA); the sum over i for y uses two accumulators to halve its
// dependent chain, and the n state updates are independent.
//
// Later work: more threads per (b, h) with the rows of S split across
// them (256 blocks of 2 warps leave most of each SM's schedulers idle at
// the prefill's shape), and the tensor cores for the chunked form.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 8;            // steps staged per round

__device__ __forceinline__ void wkv_term(float r, float k, float w, float v,
                                         float& s, float& acc) {
  const float kv = k * v;
  acc += r * s;
  s = w * s + kv;
}

template <int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_final, int T,
            int H) {
  __shared__ __align__(16) float sr[2][kSteps][N];
  __shared__ __align__(16) float sk[2][kSteps][N];
  __shared__ __align__(16) float sw[2][kSteps][N];
  constexpr int kWarps = (N + 31) / 32;
  constexpr unsigned kLanes = N >= 32 ? 0xffffffffu : (1u << N) - 1u;
  __shared__ float sd[2][kSteps][kWarps];  // per-warp sums of r * u * k

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m = threadIdx.x;
  const size_t stride = static_cast<size_t>(H) * N;        // one step
  const size_t first = static_cast<size_t>(b) * T * stride
                       + static_cast<size_t>(h) * N + m;   // (b, 0, h, m)

  float S[N];
  const float* ps0 = s0 + static_cast<size_t>(bh) * N * N + m;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = ps0[i * N];
  const float um = u[h * N + m];

  float nr[kSteps], nk[kSteps], nv[kSteps], nw[kSteps];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int t = t0 + j;
      if (t < T) {
        const size_t off = first + static_cast<size_t>(t) * stride;
        nr[j] = __ldcs(r + off);       // read once: stream past the caches
        nk[j] = __ldcs(k + off);
        nv[j] = __ldcs(v + off);
        nw[j] = __ldcs(w + off);
      } else {
        nr[j] = nk[j] = nv[j] = 0.0f;
        nw[j] = 1.0f;
      }
    }
  };

  load(0);
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += kSteps, buf ^= 1) {
    float cv[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      sr[buf][j][m] = nr[j];
      sk[buf][j][m] = nk[j];
      sw[buf][j][m] = nw[j];
      cv[j] = nv[j];
      float d = nr[j] * um * nk[j];
#pragma unroll
      for (int o = (N < 32 ? N : 32) / 2; o > 0; o /= 2)
        d += __shfl_xor_sync(kLanes, d, o);
      if ((m & 31) == 0) sd[buf][j][m / 32] = d;
    }
    __syncthreads();
    if (t0 + kSteps < T) load(t0 + kSteps);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (t0 + j < T) {
        const float4* R = reinterpret_cast<const float4*>(sr[buf][j]);
        const float4* K = reinterpret_cast<const float4*>(sk[buf][j]);
        const float4* W = reinterpret_cast<const float4*>(sw[buf][j]);
        const float vm = cv[j];
        float diag = 0.0f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) diag += sd[buf][j][q];
        float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 r4 = R[q], k4 = K[q], w4 = W[q];
          wkv_term(r4.x, k4.x, w4.x, vm, S[4 * q + 0], y0);
          wkv_term(r4.y, k4.y, w4.y, vm, S[4 * q + 1], y1);
          wkv_term(r4.z, k4.z, w4.z, vm, S[4 * q + 2], y0);
          wkv_term(r4.w, k4.w, w4.w, vm, S[4 * q + 3], y1);
        }
        y[first + static_cast<size_t>(t0 + j) * stride] =
            (y0 + y1) + vm * diag;
      }
    }
  }

  float* pS = s_final + static_cast<size_t>(bh) * N * N + m;
#pragma unroll
  for (int i = 0; i < N; ++i) pS[i * N] = S[i];
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_final, int B,
           int T, int H, cudaStream_t s) {
  wkv6_kernel<N><<<B * H, N, 0, s>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_final), T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n must be one of the template sizes (the wrapper checks); any other n is
// refused.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_final, int B, int T, int H, int N,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return launch<8>(r, k, v, w, u, s0, y, s_final, B, T, H, s);
    case 16: return launch<16>(r, k, v, w, u, s0, y, s_final, B, T, H, s);
    case 32: return launch<32>(r, k, v, w, u, s0, y, s_final, B, T, H, s);
    case 64: return launch<64>(r, k, v, w, u, s0, y, s_final, B, T, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
