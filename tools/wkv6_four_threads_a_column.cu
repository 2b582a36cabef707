// RWKV-6 WKV recurrence (data-dependent decay), forward only, for Hopper
// (sm_90a): a design that was tried and not shipped.
//
// This is the first design of the Hopper wkv6 kernel: four threads a state
// column, y's partial sums closed by shuffles every step.  The kernel the
// port ships is src/repro_torch/csrc/wkv6.cu (8 x 4 register tiles, y
// reduced once a stage); tools/wkv6_designs.py builds this file beside it,
// with the same C entry point, and times both.  Like that kernel it
// computes the function of the TPU kernel wkv6_pallas
// (src/repro/kernels/rwkv6_wkv/kernel.py:87):
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
// value v_t[m].  No chunks means any T works (a ragged T, T = 1, T = 0)
// and decays of any size need no clamping.
//
// Threads.  One block of P * n threads owns one (b, h): P threads a
// column (P = 4 at n = 16, 32, 64; P = 2 at n = 8, so that every thread
// owns at least 4 rows), each holding n / P rows of S[:, m] in registers
// for the whole of T.  A column's P threads are neighbouring lanes of one
// warp, so y's partial sums close with log2(P) xor-shuffles.  Thread p
// owns the rows 4 (P j + p) + e (e < 4): its float4 reads of r, k and w in
// shared memory are one broadcast across the warp's columns and P
// distinct 16-byte words across p, so they never conflict.  At the
// prefill's shape that is 2,048 warps (about 4 a scheduler, against 1 with
// one thread a column) and 48 state instructions a step for each thread.
//
// Loads.  r, k, v and w are read as [B, T, H*n] tensors by TMA, a box of
// 16 steps x n values (one (b, h)'s next 16 steps) each, into a ring of 4
// stages with one mbarrier a stage; one thread issues every load, 3 stages
// ahead of the one being consumed (about 12 MB in flight across the card
// at the prefill's shape).  Steps past T arrive as zeros and are skipped.
// The u term, sum_i r_t[i] u[i] k_t[i], is summed once a step for the
// block: as a stage arrives, each group of n*P/16 lanes sums one step's
// products with shuffles into shared memory, before the block barrier
// that also frees the previous stage for its refill.

#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 16;           // steps a stage
constexpr int kStages = 4;           // stages in the ring

// threads a state column
template <int N> struct Split { static constexpr int P = N >= 16 ? 4 : 2; };

template <int N>
constexpr size_t smem_bytes() {
  // 128 bytes to align the ring, 4 arrays a stage
  return 128 + static_cast<size_t>(kStages) * 4 * kSteps * N * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing its bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wkv_term(float r, float k, float w, float v,
                                         float& s, float& acc) {
  const float kv = k * v;
  acc += r * s;
  s = w * s + kv;
}

template <int N>
__global__ void __launch_bounds__(N * Split<N>::P)
wkv6_kernel(const __grid_constant__ CUtensorMap tm_r,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_final, int T,
            int H) {
  constexpr int P = Split<N>::P;
  constexpr int kThreads = N * P;
  constexpr int kQuads = N / P / 4;              // float4 rows a thread
  constexpr unsigned kLanes =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1u;
  constexpr int kBox = kSteps * N;               // floats of one array
  constexpr uint32_t kStageBytes = 4 * kBox * 4;
  // the u term: G lanes sum one step's n products, kU rows each
  constexpr int G = kThreads / kSteps;
  constexpr int kU = N / G;
  static_assert(G >= 1 && G <= 32 && kU % 4 == 0, "u-term split");

  extern __shared__ unsigned char wkv_smem[];
  __shared__ float sd[kStages][kSteps];          // u term a step
  __shared__ __align__(8) uint64_t bars[kStages];
  const uint32_t ring = (smem_u32(wkv_smem) + 127) & ~127u;
  const float* stage0 = reinterpret_cast<const float*>(
      wkv_smem + (ring - smem_u32(wkv_smem)));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int m = tid / P, p = tid % P;
  const size_t stride = static_cast<size_t>(H) * N;        // one step
  const size_t first = static_cast<size_t>(b) * T * stride
                       + static_cast<size_t>(h) * N + m;   // (b, 0, h, m)

  float S[4 * kQuads];         // rows 4 (P j + p) + e of column m
  const float* ps0 = s0 + static_cast<size_t>(bh) * N * N + m;
#pragma unroll
  for (int j = 0; j < kQuads; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[4 * j + e] = ps0[(4 * (P * j + p) + e) * N];
  const int uj = tid / G, uc = tid % G;          // u-term step and rows
  float ur[kU];
#pragma unroll
  for (int e = 0; e < kU; ++e) ur[e] = u[h * N + uc * kU + e];

  const int n_stages = (T + kSteps - 1) / kSteps;
  auto issue = [&](int i) {      // steps [16 i, 16 i + 16) into i % kStages
    const int s = i % kStages;
    const uint32_t dst = ring + s * kStageBytes;
    const uint32_t bar = smem_u32(&bars[s]);
    mbar_expect_tx(bar, kStageBytes);
    tma_load(dst, &tm_r, bar, h * N, i * kSteps, b);
    tma_load(dst + kBox * 4, &tm_k, bar, h * N, i * kSteps, b);
    tma_load(dst + 2 * kBox * 4, &tm_v, bar, h * N, i * kSteps, b);
    tma_load(dst + 3 * kBox * 4, &tm_w, bar, h * N, i * kSteps, b);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < n_stages && i < kStages; ++i) issue(i);

  for (int i = 0; i < n_stages; ++i) {
    const int s = i % kStages;
    mbar_wait(smem_u32(&bars[s]), (i / kStages) & 1);
    const float* sr = stage0 + s * 4 * kBox;
    const float* sk = sr + kBox;
    const float* sv = sk + kBox;
    const float* sw = sv + kBox;
    {  // the u term of this stage's steps
      const float* rr = sr + uj * N + uc * kU;
      const float* kk = sk + uj * N + uc * kU;
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < kU; ++e) d += rr[e] * ur[e] * kk[e];
#pragma unroll
      for (int o = G / 2; o > 0; o /= 2) d += __shfl_xor_sync(kLanes, d, o);
      if (uc == 0) sd[s][uj] = d;
    }
    // sd is visible, and every thread is done with stage i - 1
    __syncthreads();
    if (tid == 0 && i >= 1 && i - 1 + kStages < n_stages)
      issue(i - 1 + kStages);

    const int steps = min(kSteps, T - i * kSteps);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j < steps) {
        const float4* R4 = reinterpret_cast<const float4*>(sr + j * N);
        const float4* K4 = reinterpret_cast<const float4*>(sk + j * N);
        const float4* W4 = reinterpret_cast<const float4*>(sw + j * N);
        const float vm = sv[j * N + m];
        float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const float4 r4 = R4[P * q + p], k4 = K4[P * q + p],
                       w4 = W4[P * q + p];
          wkv_term(r4.x, k4.x, w4.x, vm, S[4 * q + 0], y0);
          wkv_term(r4.y, k4.y, w4.y, vm, S[4 * q + 1], y1);
          wkv_term(r4.z, k4.z, w4.z, vm, S[4 * q + 2], y0);
          wkv_term(r4.w, k4.w, w4.w, vm, S[4 * q + 3], y1);
        }
        float yv = y0 + y1;
#pragma unroll
        for (int o = 1; o < P; o *= 2) yv += __shfl_xor_sync(kLanes, yv, o);
        if (p == 0)
          y[first + static_cast<size_t>(i * kSteps + j) * stride] =
              yv + vm * sd[s][j];
      }
    }
  }

  float* pS = s_final + static_cast<size_t>(bh) * N * N + m;
#pragma unroll
  for (int j = 0; j < kQuads; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pS[(4 * (P * j + p) + e) * N] = S[4 * j + e];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point query so the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a [B, T, H, n] float32 tensor read as [B, T, H*n] in boxes of one head's
// n values x kSteps steps; steps past T read as zeros
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
                int T, int H, int n) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * n,
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 4ull * H * n;
  const cuuint64_t strides[2] = {row, row * T};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(n), kSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_final, int B,
           int T, int H, cudaStream_t s) {
  // T = 0: no map is read (they stay zeroed) and S_final = s0
  CUtensorMap maps[4] = {};
  if (T > 0) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    const void* src[4] = {r, k, v, w};
    for (int a = 0; a < 4; ++a)
      if (!encode_map(encode, &maps[a], src[a], B, T, H, N))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<N><<<B * H, N * Split<N>::P, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_final), T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n must be one of the template sizes (the wrapper checks); any other n is
// refused.  r, k, v, w, y: [B, T, H, n]; u: [H, n]; s0, s_final:
// [B, H, n, n]; all float32, contiguous, 16-byte aligned.
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
