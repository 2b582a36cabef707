// The WKV-6 backward as one block a (b, h): the design that
// src/repro_torch/csrc/wkv6_bwd.cu replaced, kept so that
// tools/wkv6_bwd_designs.py can time the two side by side.  It has the
// same C entry point (wkv6_bwd_launch) and no occupancy query.
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
// float32 rate: bound by operations.
//
// Design.  The walk back needs S_{t-1} beside dS_t, newest first.  Running
// the state backwards, S_{t-1} = (S_t - k v) / w_t, is unstable under
// strong decay, so the forward (under training) stores the state entering
// every kWkvChunk-th step, ck [B, H, ceil(T / kWkvChunk), n, n], and this
// kernel takes the chunks in reverse order: it recomputes one chunk's
// states from its checkpoint into shared memory, then walks the chunk back.
// One block owns one (b, h) and keeps dS in registers for the whole of T,
// each thread the same 8 rows x 4 columns of it as wkv6.cu's forward keeps
// of S (rows 4 (G q + rg) + e, q < 2, e < 4, of columns 4 cg .. 4 cg + 3,
// the G = n / 8 row groups of a column group neighbouring lanes; n^2 / 32
// threads).  A thread stores and reads back only its own tile of each
// recomputed state (as float4s, [step][8][thread], so a warp's accesses are
// contiguous), kWkvChunk * 32 floats a thread: 128 KB of the block's
// shared memory at n = 64.
//
// Each step a thread forms its tile's partial sums of dr, dk and dw (over
// its 4 columns, for its 8 rows) and of dv (over its 8 rows, for its 4
// columns), stores them to shared memory, and updates its tile of dS.  After
// one block barrier the block adds the column groups' (dr, dk, dw) and the
// row groups' (dv) partial sums in a fixed order, adds the u terms, and
// writes the step's four rows of n values.  The partial sums are double
// buffered by step, so one barrier a step suffices.  dy . v and
// sum_i r u k, one number each a step, are summed once a chunk by groups of
// lanes with shuffles, as the forward sums its u term.
//
// Loads.  A chunk's r, k, v, w and dy (5 kWkvChunk n floats) arrive by
// cp.async into one of two buffers while the block walks the chunk before
// it; steps past T arrive as zeros and are skipped.
//
// du without atomics.  The thread that writes dr_t[i] also adds r_t[i]
// k_t[i] (dy_t . v_t) into a register, over the steps in a fixed order, and
// writes the (b, h) sum to du_part [B, H, n]; a second launch adds du_part
// over b in order.  Every sum is taken in one fixed order, so a call
// repeats bit for bit.
//
// Left for later: with 176 KB of shared memory at n = 64 one block fits an
// SM, so rwkv6-7b's 256 (b, h) take two waves of four warps each; the
// per-step reduction through shared memory and its barrier set the pace.
// A register-resident reduction (shuffles within a column group's warp)
// and a shorter chunk that lets two blocks share an SM are the next steps.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "wkv6.cuh"        // kWkvChunk

namespace {

constexpr int kCk = kWkvChunk;     // steps a chunk
constexpr int kArrays = 5;         // r, k, v, w, dy
constexpr int kSumThreads = 256;   // the du sum's block

// A thread's tile of dS: 8 rows (2 quads of 4) x 4 columns, as wkv6.cu's.
template <int N> struct Tiling {
  static constexpr int kRowGroups = N / 8;                 // G
  static constexpr int kColGroups = N / 4;                 // CG
  static constexpr int kThreads = kRowGroups * kColGroups;  // n^2 / 32
  static constexpr int kColRow = N + 4;  // a row of dv's partial sums
  // the floats of dynamic shared memory: the chunk's states, two input
  // buffers, two buffers of (dr, dk, dw) partial sums [3][CG][n] and of
  // dv's [G][n + 4], and u
  static constexpr int kStates = kCk * 32 * kThreads;
  static constexpr int kInputs = kArrays * kCk * N;
  static constexpr int kRowSums = 3 * kColGroups * N;
  static constexpr int kColSums = kRowGroups * kColRow;
  static constexpr size_t kSmemBytes =
      4 * (static_cast<size_t>(kStates) + 2 * kInputs + 2 * kRowSums +
           2 * kColSums + N);
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

// returns once at most `Pending` of this thread's groups are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void unpack(const float4 x, float* out) {
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

template <int N>
__global__ void __launch_bounds__(Tiling<N>::kThreads)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ dy, const float* __restrict__ u,
                const float* __restrict__ ck, const float* __restrict__ dS_T,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ ds0, float* __restrict__ du_part, int T,
                int H) {
  using Tl = Tiling<N>;
  constexpr int G = Tl::kRowGroups;
  constexpr int CG = Tl::kColGroups;
  constexpr int kThreads = Tl::kThreads;
  constexpr int kColRow = Tl::kColRow;
  constexpr unsigned kLanes =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1u;
  // a step's outputs (dr, dk, dw by row, dv by column), kJobs a thread
  constexpr int kJobs = 4 * N / kThreads;
  static_assert(kJobs * kThreads == 4 * N, "outputs split evenly");
  // the per-step sums: kUG lanes sum one step's n products, kU each
  constexpr int kUG = kThreads >= kCk ? kThreads / kCk : 1;
  constexpr int kU = N / kUG;
  static_assert(kUG <= 32 && kU * kUG == N, "per-step sums split");

  extern __shared__ __align__(16) float smem[];
  float4* st = reinterpret_cast<float4*>(smem);   // [kCk][8][kThreads]
  float* in = smem + Tl::kStates;                  // [2][5][kCk][n]
  float* rows = in + 2 * Tl::kInputs;              // [2][3][CG][n]
  float* cols = rows + 2 * Tl::kRowSums;           // [2][G][n + 4]
  float* su = cols + 2 * Tl::kColSums;             // [n]
  __shared__ float s_vy[kCk], s_ruk[kCk];          // dy.v, sum r u k

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int cg = tid / G, rg = tid % G;           // column group, row group
  const int m0 = 4 * cg;                          // first of 4 columns
  const size_t stride = static_cast<size_t>(H) * N;         // one step
  const size_t base = static_cast<size_t>(b) * T * stride
                      + static_cast<size_t>(h) * N;         // (b, 0, h, 0)
  const int n_ck = (T + kCk - 1) / kCk;
  const size_t bh_state = static_cast<size_t>(bh) * N * N;

  for (int i = tid; i < N; i += kThreads) su[i] = u[h * N + i];

  // g[4 q + e][c]: dS at row 4 (G q + rg) + e, column m0 + c
  float g[8][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * (G * q + rg) + e;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (dS_T != nullptr)
        x = *reinterpret_cast<const float4*>(dS_T + bh_state + row * N + m0);
      unpack(x, g[4 * q + e]);
    }
  float du_acc[kJobs];
#pragma unroll
  for (int z = 0; z < kJobs; ++z) du_acc[z] = 0.0f;

  // chunk c's r, k, v, w and dy into input buffer c & 1, zeros past T
  auto prefetch = [&](int c) {
    float* dst = in + (c & 1) * Tl::kInputs;
    constexpr int kVec = N / 4;
#pragma unroll
    for (int a = 0; a < kArrays; ++a) {
      const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w
                                                                       : dy;
      for (int x = tid; x < kCk * kVec; x += kThreads) {
        const int j = x / kVec, q = x % kVec;
        const int t = c * kCk + j;
        const bool ok = t < T;
        cp_async16(dst + (a * kCk + j) * N + 4 * q,
                   ok ? src + base + static_cast<size_t>(t) * stride + 4 * q
                      : src,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  if (n_ck > 0) prefetch(n_ck - 1);
  for (int c = n_ck - 1; c >= 0; --c) {
    // every thread is done with chunk c + 1: its input buffer (now chunk
    // c - 1's), its partial sums and its per-step sums
    __syncthreads();
    if (c > 0) {
      prefetch(c - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // chunk c's inputs are visible
    const int t0 = c * kCk;
    const int steps = min(kCk, T - t0);
    const float* sr = in + (c & 1) * Tl::kInputs;
    const float* sk = sr + kCk * N;
    const float* sv = sk + kCk * N;
    const float* sw = sv + kCk * N;
    const float* sdy = sw + kCk * N;

    // dy_t . v_t and sum_i r_t[i] u[i] k_t[i] for each step of the chunk
    for (int j = tid / kUG; j < kCk; j += kThreads / kUG) {
      const int uc = tid % kUG;
      float vy = 0.0f, ruk = 0.0f;
#pragma unroll
      for (int e = 0; e < kU; ++e) {
        const int i = j * N + uc * kU + e;
        vy += sv[i] * sdy[i];
        ruk += sr[i] * su[uc * kU + e] * sk[i];
      }
#pragma unroll
      for (int o = kUG / 2; o > 0; o /= 2) {
        vy += __shfl_xor_sync(kLanes, vy, o);
        ruk += __shfl_xor_sync(kLanes, ruk, o);
      }
      if (uc == 0) {
        s_vy[j] = vy;
        s_ruk[j] = ruk;
      }
    }

    // the chunk's states S_{t0-1} .. S_{t0+steps-2}, this thread's tile of
    // each into st[j]
    {
      float s[8][4];
      const float* pc = ck + bh_state * n_ck + static_cast<size_t>(c) * N * N;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          unpack(*reinterpret_cast<const float4*>(
                     pc + (4 * (G * q + rg) + e) * N + m0),
                 s[4 * q + e]);
      for (int j = 0; j < steps; ++j) {
        float4* dst = st + j * 8 * kThreads + tid;
#pragma unroll
        for (int f = 0; f < 8; ++f)
          dst[f * kThreads] = make_float4(s[f][0], s[f][1], s[f][2], s[f][3]);
        if (j + 1 == steps) break;
        float kq[8], wq[8], vc[4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          unpack(*reinterpret_cast<const float4*>(sk + j * N
                                                  + 4 * (G * q + rg)),
                 kq + 4 * q);
          unpack(*reinterpret_cast<const float4*>(sw + j * N
                                                  + 4 * (G * q + rg)),
                 wq + 4 * q);
        }
        unpack(*reinterpret_cast<const float4*>(sv + j * N + m0), vc);
#pragma unroll
        for (int f = 0; f < 8; ++f)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            s[f][cc] = wq[f] * s[f][cc] + kq[f] * vc[cc];
      }
    }

    // the walk back through the chunk
    for (int j = steps - 1; j >= 0; --j) {
      const int t = t0 + j;
      float rq[8], kq[8], wq[8], vc[4], yc[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i4 = j * N + 4 * (G * q + rg);
        unpack(*reinterpret_cast<const float4*>(sr + i4), rq + 4 * q);
        unpack(*reinterpret_cast<const float4*>(sk + i4), kq + 4 * q);
        unpack(*reinterpret_cast<const float4*>(sw + i4), wq + 4 * q);
      }
      unpack(*reinterpret_cast<const float4*>(sv + j * N + m0), vc);
      unpack(*reinterpret_cast<const float4*>(sdy + j * N + m0), yc);
      float pr[8], pk[8], pw[8], pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float4* src = st + j * 8 * kThreads + tid;
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        float sp[4];
        unpack(src[f * kThreads], sp);
        pr[f] = pk[f] = pw[f] = 0.0f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          pr[f] += yc[cc] * sp[cc];
          pw[f] += g[f][cc] * sp[cc];
          pk[f] += g[f][cc] * vc[cc];
          pv[cc] += g[f][cc] * kq[f];
          g[f][cc] = wq[f] * g[f][cc] + rq[f] * yc[cc];
        }
      }
      float* pr_s = rows + (j & 1) * Tl::kRowSums;
      float* pv_s = cols + (j & 1) * Tl::kColSums;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i4 = cg * N + 4 * (G * q + rg);
        *reinterpret_cast<float4*>(pr_s + i4) = make_float4(
            pr[4 * q], pr[4 * q + 1], pr[4 * q + 2], pr[4 * q + 3]);
        *reinterpret_cast<float4*>(pr_s + CG * N + i4) = make_float4(
            pk[4 * q], pk[4 * q + 1], pk[4 * q + 2], pk[4 * q + 3]);
        *reinterpret_cast<float4*>(pr_s + 2 * CG * N + i4) = make_float4(
            pw[4 * q], pw[4 * q + 1], pw[4 * q + 2], pw[4 * q + 3]);
      }
      *reinterpret_cast<float4*>(pv_s + rg * kColRow + m0) =
          make_float4(pv[0], pv[1], pv[2], pv[3]);
      __syncthreads();             // the step's partial sums are stored

      // the step's outputs: x < n dr, then dk, then dw, then dv
      const float vy = s_vy[j];
      const size_t out = base + static_cast<size_t>(t) * stride;
#pragma unroll
      for (int z = 0; z < kJobs; ++z) {
        const int x = tid + z * kThreads;
        if (x < 3 * N) {
          const int part = x / N, i = x % N;
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < CG; ++q) acc += pr_s[(part * CG + q) * N + i];
          const float ri = sr[j * N + i], ki = sk[j * N + i];
          if (part == 0) {
            dr[out + i] = acc + su[i] * ki * vy;
            du_acc[z] += ri * ki * vy;
          } else if (part == 1) {
            dk[out + i] = acc + ri * su[i] * vy;
          } else {
            dw[out + i] = acc;
          }
        } else {
          const int m = x - 3 * N;
          float acc = s_ruk[j] * sdy[j * N + m];
#pragma unroll
          for (int q = 0; q < G; ++q) acc += pv_s[q * kColRow + m];
          dv[out + m] = acc;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = 4 * q + e;
      *reinterpret_cast<float4*>(ds0 + bh_state
                                 + (4 * (G * q + rg) + e) * N + m0) =
          make_float4(g[f][0], g[f][1], g[f][2], g[f][3]);
    }
#pragma unroll
  for (int z = 0; z < kJobs; ++z) {
    const int x = tid + z * kThreads;
    if (x < N) du_part[static_cast<size_t>(bh) * N + x] = du_acc[z];
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

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* dy, const void* u, const void* ck, const void* dS_T,
           void* dr, void* dk, void* dv, void* dw, void* ds0, void* du,
           void* du_part, int B, int T, int H, cudaStream_t s) {
  constexpr size_t smem = Tiling<N>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<N><<<B * H, Tiling<N>::kThreads, smem, s>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(dy), static_cast<const float*>(u),
      static_cast<const float*>(ck), static_cast<const float*>(dS_T),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw),
      static_cast<float*>(ds0), static_cast<float*>(du_part), T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hn = H * N;
  wkv6_bwd_du_kernel<<<(hn + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                       s>>>(static_cast<const float*>(du_part),
                            static_cast<float*>(du), B, hn);
  return static_cast<int>(cudaGetLastError());
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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
