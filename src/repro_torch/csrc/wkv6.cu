// RWKV-6 WKV recurrence (data-dependent decay), forward, for Hopper
// (sm_90a).  Its gradient is wkv6_bwd.cu.
//
// Replaces the TPU kernel wkv6_pallas
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
// Threads.  One block owns one (b, h) and keeps S in registers for the
// whole of T, each thread a tile of 8 rows x 4 columns: rows 4 (G j + rg)
// + e (j < 2, e < 4) of columns 4 cg .. 4 cg + 3, where the G = n / 8 row
// groups rg of a column group cg are neighbouring lanes.  n * n / 32
// threads: 128 (4 warps) at n = 64, down to 2 at n = 8.  A thread reads
// its rows of r, k and w as float4s (the row groups of a quarter warp hit
// 8 distinct bank groups) and uses each value for 4 columns.  That matters
// because shared memory delivers 128 bytes a clock to registers, broadcast
// or not: with one column a thread (the kernel this one replaces, and a
// first version of this one with 4 threads a column) every thread reads
// all of r, k and w each step, 12 n^2 bytes a step and head, and that set
// the time; the 8 x 4 tile reads 3.5 n^2.  At the prefill's shape
// (tools/wkv6_designs.py, NVIDIA H100 80GB HBM3, 700.00 W) this tile took
// 0.393 ms; larger tiles, 8 x 8 and 16 x 4 (157 and 168 registers, half
// the warps), 0.722 and 0.743; smaller ones, 4 x 4 and 4 x 8, which add
// more reduction than they save, 0.520 and 0.549; four threads a column
// (tools/wkv6_four_threads_a_column.cu) 0.941, and the kernel this one
// replaced 0.882.
//
// y.  Each step a thread sums r_t[i] S[i][m] over its 8 rows and stores
// its 4 column sums as one float4 into a shared buffer [step][row group]
// [n + 4] (the padding keeps those stores conflict-free); after the stage
// the block adds the G row groups and the u term and writes y as float4
// rows, 256 contiguous bytes a step at n = 64.  Reducing each step by
// warp shuffles instead (as the four-threads design does) puts dependent
// shuffle rounds on every step's path.
//
// Loads.  r, k, v and w are read as [B, T, H*n] tensors by TMA, a box of
// 16 steps x n values (one (b, h)'s next 16 steps) each, into a ring of 3
// stages with one mbarrier a stage; one thread issues every load, 2
// stages ahead of the one being consumed (2 or 4 stages took 0.405 and
// 0.407 ms, 8 or 32 steps a stage 0.443 and 0.749, in the same run as
// above).  Steps past T arrive as zeros and are skipped.  The u term,
// sum_i r_t[i] u[i] k_t[i], is summed once a step for the block: as a
// stage arrives, each group of lanes sums one step's products with
// shuffles into shared memory, before the block barrier that also frees
// the previous stage for its refill.  A full stage's 16 steps are
// straight-line code, so the compiler overlaps them.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.396-0.398
// ms at the prefill's shape, 2.0x the byte bound (the kernel this one
// replaced: 0.889 ms); 32 launches take 12.7 ms of a 343-345 ms rwkv6-7b
// prefill.
//
// Checkpoints.  Under training (wkv6_launch_checkpoints with a non-null
// ck) each thread also stores its tile of the state entering every
// kWkvChunk-th step into ck [B, H, ceil(T / kWkvChunk), n, n], which
// wkv6_bwd.cu walks back from: 1/kWkvChunk of the state's size a step,
// 1.07 GB at the prefill's shape.  Serving passes null and stores nothing.
//
// Left: 3 float32 instructions an element and step are the floor of this
// form, and with the prefill's 256 heads over 132 SMs only 8 warps an SM
// issue them; what remains is issue and latency, not bytes.  The chunked
// form on the tensor cores (the TPU kernel's idea, without its clamped
// exponents) is the next step, and the time-mix passes around the kernel
// (3.9 ms a layer) matter more to the prefill than the kernel does.

#include "sm90.cuh"        // mbarriers, cuTensorMapEncodeTiled
#include "wkv6.cuh"        // kWkvChunk

namespace {

// The ring and the tile as shipped; tools/wkv6_designs.py builds this
// file with other values (-D) to time them against these.
#ifndef WKV6_STEPS
#define WKV6_STEPS 16
#endif
#ifndef WKV6_STAGES
#define WKV6_STAGES 3
#endif
#ifndef WKV6_QUADS
#define WKV6_QUADS 2
#endif
#ifndef WKV6_COLS
#define WKV6_COLS 4
#endif

constexpr int kSteps = WKV6_STEPS;     // steps a stage
constexpr int kStages = WKV6_STAGES;   // stages in the ring

// A thread's tile of S: 4 kQuads rows x kCols columns (a multiple of 4),
// each at most n.  Its column group is shared by n / (4 kQuads) threads
// (kRowGroups), neighbouring lanes of one warp.
template <int N> struct Tiling {
  static constexpr int kQuads = WKV6_QUADS < N / 4 ? WKV6_QUADS : N / 4;
  static constexpr int kCols = WKV6_COLS < N ? WKV6_COLS : N;
  static_assert(kCols % 4 == 0, "columns come as float4s");
  static constexpr int kRowGroups = N / (4 * kQuads);
  static constexpr int kThreads = (N / kCols) * kRowGroups;
};

// floats a row of the partials buffer: n + 4, so that the 8 lanes of a
// quarter warp storing 8 row groups' float4s hit 8 distinct bank groups
template <int N> constexpr int kPartialRow = N + 4;

template <int N>
constexpr size_t smem_bytes() {
  // 128 bytes to align the ring, 4 arrays a stage, then y's partial sums
  // [kSteps][row groups][kPartialRow]
  return 128 + static_cast<size_t>(kStages) * 4 * kSteps * N * 4
         + static_cast<size_t>(kSteps) * Tiling<N>::kRowGroups
               * kPartialRow<N> * 4;
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

template <int N>
__global__ void __launch_bounds__(Tiling<N>::kThreads)
wkv6_kernel(const __grid_constant__ CUtensorMap tm_r,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_final,
            float* __restrict__ ck, int T, int H) {
  constexpr int G = Tiling<N>::kRowGroups;
  constexpr int kQ = Tiling<N>::kQuads;
  constexpr int C = Tiling<N>::kCols;
  constexpr int kRow = kPartialRow<N>;
  constexpr int kThreads = Tiling<N>::kThreads;
  constexpr unsigned kLanes =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1u;
  constexpr int kBox = kSteps * N;               // floats of one array
  constexpr uint32_t kStageBytes = 4 * kBox * 4;
  // the u term: kUG lanes sum one step's n products, kU rows each
  constexpr int kUG = kThreads >= kSteps ? kThreads / kSteps : 1;
  constexpr int kU = N / kUG;
  static_assert(kUG <= 32 && kU % 4 == 0, "u-term split");

  extern __shared__ unsigned char wkv_smem[];
  __shared__ float sd[kStages][kSteps];          // u term a step
  __shared__ __align__(8) uint64_t bars[kStages];
  const uint32_t ring = (smem_u32(wkv_smem) + 127) & ~127u;
  const float* stage0 = reinterpret_cast<const float*>(
      wkv_smem + (ring - smem_u32(wkv_smem)));
  float* partial = const_cast<float*>(stage0) + kStages * 4 * kBox;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int cg = tid / G, rg = tid % G;          // column group, row group
  const int m0 = C * cg;                         // first of C columns
  const size_t stride = static_cast<size_t>(H) * N;        // one step
  float* y_bh = y + static_cast<size_t>(b) * T * stride
               + static_cast<size_t>(h) * N;               // (b, 0, h, 0)

  // S[4 j + e][c] is state row 4 (G j + rg) + e, column m0 + c
  float S[4 * kQ][C];
  const float* ps0 = s0 + static_cast<size_t>(bh) * N * N + m0;
#pragma unroll
  for (int j = 0; j < kQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            ps0 + (4 * (G * j + rg) + e) * N + c);
        S[4 * j + e][c] = x.x; S[4 * j + e][c + 1] = x.y;
        S[4 * j + e][c + 2] = x.z; S[4 * j + e][c + 3] = x.w;
      }
  // this thread's tile of S into an [n, n] state at dst
  auto store_state = [&](float* dst) {
    float* pS = dst + m0;
#pragma unroll
    for (int j = 0; j < kQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < C; c += 4)
          *reinterpret_cast<float4*>(pS + (4 * (G * j + rg) + e) * N + c) =
              make_float4(S[4 * j + e][c], S[4 * j + e][c + 1],
                          S[4 * j + e][c + 2], S[4 * j + e][c + 3]);
  };
  const int n_ck = (T + kWkvChunk - 1) / kWkvChunk;
  float* ck_bh =
      ck ? ck + static_cast<size_t>(bh) * n_ck * N * N : nullptr;
  const int uc = tid % kUG;                      // u-term rows
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
    // the u term of this stage's steps
    for (int j = tid / kUG; j < kSteps; j += kThreads / kUG) {
      const float* rr = sr + j * N + uc * kU;
      const float* kk = sk + j * N + uc * kU;
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < kU; ++e) d += rr[e] * ur[e] * kk[e];
#pragma unroll
      for (int o = kUG / 2; o > 0; o /= 2)
        d += __shfl_xor_sync(kLanes, d, o);
      if (uc == 0) sd[s][j] = d;
    }
    // sd is visible, and every thread is done with stage i - 1 and its y
    __syncthreads();
    if (tid == 0 && i >= 1 && i - 1 + kStages < n_stages)
      issue(i - 1 + kStages);

    // one step: the state update and y's partial sums over this thread's
    // tile, stored for the stage's reduction
    auto step = [&](int j) {
      const float4* R4 = reinterpret_cast<const float4*>(sr + j * N);
      const float4* K4 = reinterpret_cast<const float4*>(sk + j * N);
      const float4* W4 = reinterpret_cast<const float4*>(sw + j * N);
      const float4* V4 = reinterpret_cast<const float4*>(sv + j * N + m0);
      if (ck != nullptr) {       // uniform: training stores checkpoints
        const int t = i * kSteps + j;
        if (t % kWkvChunk == 0)
          store_state(ck_bh + static_cast<size_t>(t / kWkvChunk) * N * N);
      }
      float v[C], a[C];
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 x = V4[c / 4];
        v[c] = x.x; v[c + 1] = x.y; v[c + 2] = x.z; v[c + 3] = x.w;
        a[c] = a[c + 1] = a[c + 2] = a[c + 3] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 r4 = R4[G * q + rg], k4 = K4[G * q + rg],
                     w4 = W4[G * q + rg];
        const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kq[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float& st = S[4 * q + e][c];
            const float kv = kq[e] * v[c];
            a[c] += rq[e] * st;
            st = wq[e] * st + kv;
          }
      }
      float* pp = partial + (j * G + rg) * kRow + m0;
#pragma unroll
      for (int c = 0; c < C; c += 4)
        *reinterpret_cast<float4*>(pp + c) =
            make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
    };
    const int steps = min(kSteps, T - i * kSteps);
    if (steps == kSteps) {       // straight-line, so steps can overlap
#pragma unroll
      for (int j = 0; j < kSteps; ++j) step(j);
    } else {
      for (int j = 0; j < steps; ++j) step(j);
    }
    __syncthreads();             // the stage's partial sums are stored

    // y of the stage: the row groups' partial sums plus the u term, as
    // float4 rows of n values a step
    for (int x = tid; x < steps * (N / 4); x += kThreads) {
      const int j = x / (N / 4), m4 = 4 * (x % (N / 4));
      float4 acc = *reinterpret_cast<const float4*>(sv + j * N + m4);
      const float d = sd[s][j];
      acc.x *= d; acc.y *= d; acc.z *= d; acc.w *= d;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(partial + (j * G + g) * kRow + m4);
        acc.x += p4.x; acc.y += p4.y; acc.z += p4.z; acc.w += p4.w;
      }
      *reinterpret_cast<float4*>(
          y_bh + static_cast<size_t>(i * kSteps + j) * stride + m4) = acc;
    }
  }

  store_state(s_final + static_cast<size_t>(bh) * N * N);
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
           const void* u, const void* s0, void* y, void* s_final, void* ck,
           int B, int T, int H, cudaStream_t s) {
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
  wkv6_kernel<N><<<B * H, Tiling<N>::kThreads, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_final), static_cast<float*>(ck), T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n must be one of the template sizes (the wrapper checks); any other n is
// refused.  r, k, v, w, y: [B, T, H, n]; u: [H, n]; s0, s_final:
// [B, H, n, n]; ck: null, or [B, H, ceil(T / kWkvChunk), n, n] for the
// states entering every kWkvChunk-th step; all float32, contiguous, 16-byte
// aligned.
extern "C" int wkv6_launch_checkpoints(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* s0,
                                       void* y, void* s_final, void* ck,
                                       int B, int T, int H, int N,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return launch<8>(r, k, v, w, u, s0, y, s_final, ck, B, T, H, s);
    case 16: return launch<16>(r, k, v, w, u, s0, y, s_final, ck, B, T, H, s);
    case 32: return launch<32>(r, k, v, w, u, s0, y, s_final, ck, B, T, H, s);
    case 64: return launch<64>(r, k, v, w, u, s0, y, s_final, ck, B, T, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward alone, with no checkpoints (the entry point that
// tools/wkv6_designs.py times designs through).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_final, int B, int T, int H, int N,
                           void* stream) {
  return wkv6_launch_checkpoints(r, k, v, w, u, s0, y, s_final, nullptr, B,
                                 T, H, N, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
