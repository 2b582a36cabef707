// Causal GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py):
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, g]) v[b, j, g]
//
// over the live keys j <= i (and j > i - window when window > 0), with
// g = h / (H / KV) the query head's kv head and scale = 1/sqrt(hd).
//
// Layout: q and out are [B, S, H, hd], k and v [B, S, KV, hd], contiguous,
// the model's own layout, so no transposes are needed around the call.
// Scores, softmax statistics and the output accumulator are float32; the
// output is written in the input type.
//
// Bound: operations.  At gemma3-1b's prefill shape (B 4, S 2,048, H 4,
// KV 1, hd 256) a global layer does 4*B*H*hd*sum_i(live keys) = 3.4e10
// flops on 42 MB of q, k, v and out: 35 us at the bf16 tensor-core peak
// against 13 us for the bytes.  Like the TPU kernel, both kernels here keep
// the [S, S] score matrix out of device memory.
//
// Shared design.  One block per (b*h, 64-query tile).  The query tile is
// staged once in shared memory; the block then walks, in order, only the
// KV tiles that hold a live key for some query of its tile, staging each K
// and V tile in shared memory.  Tiles that are fully masked (past the
// causal diagonal, or before the window of the tile's first query) are
// never loaded, as the TPU kernel's pl.when skips them.  A row's running
// max m and sum l, and the rescale of its accumulators, stay in the
// registers of the threads that own the row.  Probabilities enter the P.V
// product rounded to the input type, as the TPU kernel's p.astype(v.dtype)
// does, while l sums them unrounded.
//
// bf16 (the model's type): tensor cores through mma.sync m16n8k16 (bf16
// in, float32 accumulate), 4 warps of 16 query rows each.  A warp's S tile
// stays in its mma accumulators: the 4 lanes of a quad hold one row's
// scores, so a row's max and sum meet in two xor-shuffles, and the
// accumulator layout of two adjacent 8-key tiles is exactly the operand
// layout of one 16-key step of P.V, so P never leaves registers.  V is
// staged transposed so both products read their B operand as 32-bit pairs.
// Shared-memory rows are padded by 8 elements (16 bytes) so the 8 rows a
// fragment load touches fall in different banks.  wgmma and TMA, with a
// pipelined producer, are later work.
//
// float32 (the comparisons): CUDA cores, exact float32 products.  A 16 x
// 16 thread grid owns 4 query rows per thread, scores against the key
// columns tx, tx+16, ... (a row's max and sum meet in four xor-shuffles
// within a half-warp) and the same rows' output columns tx, tx+16, ...;
// probabilities pass through shared memory; Q and K rows have an odd
// pitch (hd + 1 floats) so the two half-warps' rows fall in different
// banks.
//
// Shared memory at hd 256: 71 KB (bf16) and 140 KB (float32), past the
// 48 KB default: the launcher raises the block's dynamic limit each time.
//
// NEG_INF is -1e30, not -inf, as in the TPU kernel: a row with no live
// key in its first tile then holds m = -1e30 and p = 1 for a while, and
// the first live key's correction factor exp(-1e30 - m) = 0 wipes that
// out.  The diagonal is always live, so every row ends with a real max.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool live_key(int kj, int qi, int window) {
  return kj <= qi && (window <= 0 || kj > qi - window);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;     // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int HD, int BK>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((kBQ + BK) * (HD + 8) + HD * (BK + 8));
}

template <int HD, int BK>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S, int H,
                           int KV, int window, float scale) {
  constexpr int kQP = HD + 8;          // Q and K row pitch (elements)
  constexpr int kVP = BK + 8;          // transposed V row pitch
  constexpr int kNT = BK / 8;          // 8-key tiles of S
  constexpr int kDT = HD / 8;          // 8-column tiles of the output
  constexpr int kVec = 8;              // bf16 per 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBQ][kQP]
  __nv_bfloat16* Ks = Qs + kBQ * kQP;                       // [BK][kQP]
  __nv_bfloat16* Vt = Ks + BK * kQP;                        // [HD][kVP]

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x % 32;
  const int quad = lane / 4;           // the fragment's row (and row + 8)
  const int pair = lane % 4;           // the fragment's column pair
  const int row0 = (threadIdx.x / 32) * 16 + quad;   // row in the tile
  const size_t q_pitch = static_cast<size_t>(H) * HD;
  const size_t kv_pitch = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * S * KV + g) * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * S * KV + g) * HD;
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * S * H + h) * HD;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int e = threadIdx.x; e < kBQ * HD / kVec; e += kMmaThreads) {
    const int r = e / (HD / kVec), c = e % (HD / kVec) * kVec;
    *reinterpret_cast<uint4*>(Qs + r * kQP + c) =
        q0 + r < S ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_pitch
                                                     + c)
                   : zero;
  }

  float o[kDT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int tile_end = q_last / BK;
  const int tile_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int t = tile_begin; t <= tile_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();          // every warp is done with the last K and V
    for (int e = threadIdx.x; e < BK * HD / kVec; e += kMmaThreads) {
      const int r = e / (HD / kVec), c = e % (HD / kVec) * kVec;
      *reinterpret_cast<uint4*>(Ks + r * kQP + c) =
          k0 + r < S ? *reinterpret_cast<const uint4*>(
                           kb + (k0 + r) * kv_pitch + c)
                     : zero;
    }
    // V transposed: neighbouring threads take neighbouring keys, so their
    // 2-byte stores share words instead of banks
    for (int e = threadIdx.x; e < BK * HD / kVec; e += kMmaThreads) {
      const int r = e % BK, c = e / BK * kVec;
      uint4 raw = k0 + r < S ? *reinterpret_cast<const uint4*>(
                                   vb + (k0 + r) * kv_pitch + c)
                             : zero;
      const auto* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) Vt[(c + i) * kVP + r] = vals[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and BK keys
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      const __nv_bfloat16* qa = Qs + row0 * kQP + kk + 2 * pair;
      const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * kQP),
                             ld_pair(qa + 8), ld_pair(qa + 8 * kQP + 8)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const __nv_bfloat16* kf = Ks + (nt * 8 + quad) * kQP + kk + 2 * pair;
        const uint32_t bfrag[2] = {ld_pair(kf), ld_pair(kf + 8)};
        mma_bf16(s[nt], a, bfrag);
      }
    }

    // online softmax; accumulator i of tile nt is row row0 + 8 * (i / 2),
    // key k0 + 8 * nt + 2 * pair + i % 2
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = q0 + row0 + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * half + j];
          x = live_key(k0 + 8 * nt + 2 * pair + j, qi, window) ? x * scale
                                                                : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * half + j];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m[half] - m_new);
      l[half] = l[half] * corr + sum;
      m[half] = m_new;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][2 * half] *= corr;
        o[dt][2 * half + 1] *= corr;
      }
    }

    // O += P V: two adjacent 8-key accumulator tiles are one 16-key
    // operand, rounded to bf16
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {pack_pair(s[2 * kc][0], s[2 * kc][1]),
                             pack_pair(s[2 * kc][2], s[2 * kc][3]),
                             pack_pair(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_pair(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const __nv_bfloat16* vf = Vt + (dt * 8 + quad) * kVP + 16 * kc
                                  + 2 * pair;
        const uint32_t bfrag[2] = {ld_pair(vf), ld_pair(vf + 8)};
        mma_bf16(o[dt], a, bfrag);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + row0 + 8 * half;
    if (qi < S) {
      const float denom = fmaxf(l[half], 1e-30f);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(ob + qi * q_pitch + dt * 8 + 2 * pair) =
            pack_pair(o[dt][2 * half] / denom, o[dt][2 * half + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: exact products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;     // 16 x 16
constexpr int kRows = kBQ / 16;      // query rows per thread

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, int BK>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 1) + BK * (HD + 1) + BK * HD + kBQ * (BK + 1));
}

template <int HD, int BK>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int H, int KV,
                           int window, float scale) {
  constexpr int kQP = HD + 1;          // Q and K row pitch (odd)
  constexpr int kPP = BK + 1;          // P row pitch
  constexpr int kKC = BK / 16;         // key columns per thread
  constexpr int kDC = HD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][kQP]
  float* Ks = Qs + kBQ * kQP;          // [BK][kQP]
  float* Vs = Ks + BK * kQP;           // [BK][HD]
  float* Ps = Vs + BK * HD;            // [kBQ][kPP]

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t q_pitch = static_cast<size_t>(H) * HD;   // one position
  const size_t kv_pitch = static_cast<size_t>(KV) * HD;
  const float* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const float* kb = k + (static_cast<size_t>(b) * S * KV + g) * HD;
  const float* vb = v + (static_cast<size_t>(b) * S * KV + g) * HD;
  float* ob = out + (static_cast<size_t>(b) * S * H + h) * HD;

  for (int e = threadIdx.x; e < kBQ * HD; e += kF32Threads) {
    const int r = e / HD, d = e % HD;
    Qs[r * kQP + d] = q0 + r < S ? qb[(q0 + r) * q_pitch + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[r][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int tile_end = q_last / BK;
  const int tile_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int t = tile_begin; t <= tile_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();          // the last tile's Vs and Ps reads are done
    for (int e = threadIdx.x; e < BK * HD; e += kF32Threads) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < S;
      Ks[r * kQP + d] = in ? kb[(k0 + r) * kv_pitch + d] : 0.f;
      Vs[r * HD + d] = in ? vb[(k0 + r) * kv_pitch + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kKC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKC; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = Qs[(ty * kRows + r) * kQP + d];
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        const float kv = Ks[(tx + 16 * c) * kQP + d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r][c] = fmaf(qv[r], kv, s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + ty * kRows + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        s[r][c] = live_key(k0 + tx + 16 * c, qi, window) ? s[r][c] * scale
                                                         : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        Ps[(ty * kRows + r) * kPP + tx + 16 * c] = p;
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + half_warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[r][j] *= corr;
    }
    __syncthreads();          // Ps is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = Ps[(ty * kRows + r) * kPP + kk];
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    if (qi < S) {
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < kDC; ++j)
        ob[qi * q_pitch + tx + 16 * j] = acc[r][j] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, S, H, KV, window;
  float scale;
  cudaStream_t stream;
};

template <int HD, int BK>
int launch_bf16(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<HD, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<HD, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  flash_attention_mma_kernel<HD, BK><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.S, a.H, a.KV, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK>
int launch_f32(const Args& a) {
  constexpr size_t smem = f32_smem_bytes<HD, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<HD, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  flash_attention_f32_kernel<HD, BK><<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.S, a.H,
      a.KV, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [B, S, H, hd]; k, v: [B, S, KV, hd]; all contiguous, one dtype
// (is_bf16 ? bf16, 16-byte aligned : float32); H % KV == 0; hd in
// {16, 32, 64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int window,
                                      float scale, int is_bf16,
                                      void* stream) {
  const Args a{q, k, v, out, B, S, H, KV, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    switch (hd) {
      case 16: return launch_bf16<16, 64>(a);
      case 32: return launch_bf16<32, 64>(a);
      case 64: return launch_bf16<64, 64>(a);
      case 128: return launch_bf16<128, 64>(a);
      case 256: return launch_bf16<256, 32>(a);
    }
  } else {
    switch (hd) {
      case 16: return launch_f32<16, 64>(a);
      case 32: return launch_f32<32, 64>(a);
      case 64: return launch_f32<64, 64>(a);
      case 128: return launch_f32<128, 32>(a);
      case 256: return launch_f32<256, 32>(a);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
