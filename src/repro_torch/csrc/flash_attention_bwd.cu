// Causal GQA flash attention, backward, for Hopper (sm_90a).
//
// The reference has no Pallas backward: it trains by differentiating its
// plain chunked attention with jax.value_and_grad
// (src/repro/launch/steps.py, src/repro/models/attention.py), whose
// checkpointed chunk body recomputes P in backward.  The port runs the
// forward kernel (flash_attention.cu) on the card, so its gradient is this
// kernel: the gradient of
//
//   out[b, i, h] = sum_j P_ij v[b, j, g],  P_ij = softmax_j(scale * s_ij),
//   s_ij = q[b, i, h] . k[b, j, g]
//
// over the live keys j <= i (and j > i - window when window > 0), with
// g = h / (H / KV) and scale = 1/sqrt(hd).  From the forward's output O and
// its log-normaliser lse [B, H, S] (float32):
//
//   P  = exp(scale * s - lse)      recomputed, never stored in device memory
//   D  = rowsum(dO o O)            pass 1 (flash_bwd_dot_kernel)
//   dV = P^T dO,  dK = scale * dS^T Q,  dS = P o (dO V^T - D)
//                                  pass 2 (flash_bwd_dkdv_*kernel)
//   dQ = scale * dS K              pass 3 (flash_bwd_dq_*kernel)
//
// A kv head's dK and dV sum over its H/KV query heads.  P enters dV rounded
// to the input type, as it enters P.V in the forward.
//
// Determinism: no atomics.  Pass 2 gives each block one KV tile of one kv
// head and walks its group's query heads and their live query tiles in a
// fixed order, with dK and dV in registers; pass 3 gives each block one
// query tile of one head and walks its live KV tiles in order.  Each
// output element is written once, by one thread, after a sum in a fixed
// order, so repeats are bit-identical.  The price is S and dP computed
// twice (passes 2 and 3): 14 * B * H * hd * live flops against the 10 the
// gradient needs.
//
// Bound: operations.  At gemma3-1b's training shape (B 4, S 2,048, H 4,
// KV 1, hd 256) the gradient is 8.6e10 flops at window 0 (87 us at the
// bf16 tensor-core peak) and 3.7e10 at window 512.  Like the forward, the
// kernel never loads a tile that the causal mask or the window removes
// entirely: pass 2 walks only the query tiles that see its keys, pass 3
// only the KV tiles its queries see.
//
// Two routes, as the forward has them:
//
// bf16 (every model call): the tensor cores through mma.sync, described
//   at flash_bwd_dkdv_mma_kernel below.
//
// float32 (the comparisons' exact twin): the CUDA cores, every product a
//   float32 FMA.  A 16 x 16 thread grid: in pass 2 thread (ty, tx) owns keys
//   ty + 16 r of its tile and output columns tx + 16 j, and its S^T and
//   dP^T scores are those keys against queries tx + 16 c; pass 3 swaps
//   the roles of queries and keys.  Rows in shared memory have an odd
//   pitch (hd + 1 floats), so the 16 rows a half-warp reads fall in
//   different banks.  Tiles (keys x queries): 64 x 64 at hd <= 128,
//   32 x 32 at hd 256 (140 KB of shared memory).

#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // 16 x 16

__device__ __forceinline__ bool live_key(int kj, int qi, int window) {
  return kj <= qi && (window <= 0 || kj > qi - window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the input type and back (P as the forward's P.V sees it)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// tile geometry: BK keys and BQ queries a tile
template <int HD> struct BwdTile {
  static constexpr int BK = 64, BQ = 64;
};
template <> struct BwdTile<256> {
  static constexpr int BK = 32, BQ = 32;
};

template <int HD>
constexpr size_t bwd_smem_bytes() {
  // two tiles of rows of each side, two score tiles, lse and D
  constexpr int BK = BwdTile<HD>::BK, BQ = BwdTile<HD>::BQ;
  return sizeof(float) * (2 * (BK + BQ) * (HD + 1) + 2 * BK * (BQ + 1) +
                          2 * BQ);
}

// rows of a [B, S, heads, HD] tensor for one (b, head), starting at row0,
// into shared memory as float with pitch HD + 1; rows past S are zeros
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t pitch, int row0, int S) {
  for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] =
        row0 + r < S ? to_f(src[static_cast<size_t>(row0 + r) * pitch + d])
                     : 0.f;
  }
}

// ---------------------------------------------------------------------------
// pass 1: D = rowsum(dO o O), one warp a (b, i, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                     float* __restrict__ D, int rows, int S, int H, int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;             // uniform over the warp
  const T* o = out + static_cast<size_t>(row) * hd;
  const T* g = dout + static_cast<size_t>(row) * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bi = row / H;      // row = (b * S + i) * H + h
    const int b = bi / S, i = bi % S;
    D[(static_cast<size_t>(b) * H + h) * S + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// pass 2: dK and dV, one block a (KV tile, b, kv head)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int KV, int window,
                      float scale) {
  constexpr int BK = BwdTile<HD>::BK, BQ = BwdTile<HD>::BQ;
  constexpr int kP = HD + 1;           // row pitch (odd)
  constexpr int kSP = BQ + 1;          // score-tile pitch
  constexpr int kR = BK / 16;          // keys a thread
  constexpr int kC = BQ / 16;          // queries a thread (scores)
  constexpr int kD = HD / 16;          // output columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][kP]
  float* Vs = Ks + BK * kP;            // [BK][kP]
  float* Qs = Vs + BK * kP;            // [BQ][kP]
  float* Gs = Qs + BQ * kP;            // dO, [BQ][kP]
  float* Ps = Gs + BQ * kP;            // P rounded to T, [BK][kSP]
  float* Ss = Ps + BK * kSP;           // dS, [BK][kSP]
  float* Ls = Ss + BK * kSP;           // lse of the query tile, [BQ]
  float* Ds = Ls + BQ;                 // D of the query tile, [BQ]

  const int b = blockIdx.y / KV;
  const int g = blockIdx.y % KV;
  const int k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int rep = H / KV;
  const size_t kv_pitch = static_cast<size_t>(KV) * HD;   // one position
  const size_t q_pitch = static_cast<size_t>(H) * HD;

  stage_rows<T, HD, BK>(Ks, k + (static_cast<size_t>(b) * S * KV + g) * HD,
                        kv_pitch, k0, S);
  stage_rows<T, HD, BK>(Vs, v + (static_cast<size_t>(b) * S * KV + g) * HD,
                        kv_pitch, k0, S);

  float acc_k[kR][kD], acc_v[kR][kD];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kD; ++j) acc_k[r][j] = acc_v[r][j] = 0.f;

  // the query tiles that see a key of this tile: qi >= k0 and, with a
  // window, qi < (last key) + window
  const int k_last = min(k0 + BK, S) - 1;
  const int qt_begin = k0 / BQ;
  const int qt_end =
      (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / BQ;

  for (int hr = 0; hr < rep; ++hr) {
    const int h = g * rep + hr;
    const T* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
    const T* gb = dout + (static_cast<size_t>(b) * S * H + h) * HD;
    const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* db = D + (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt_begin; qt <= qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();          // the last tile's Qs, Gs, Ps, Ss reads done
      stage_rows<T, HD, BQ>(Qs, qb, q_pitch, q0, S);
      stage_rows<T, HD, BQ>(Gs, gb, q_pitch, q0, S);
      for (int e = threadIdx.x; e < BQ; e += kThreads) {
        Ls[e] = q0 + e < S ? lb[q0 + e] : 0.f;
        Ds[e] = q0 + e < S ? db[q0 + e] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this thread's keys and queries
      float st[kR][kC], dpt[kR][kC];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) st[r][c] = dpt[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[kR], vv[kR], qv[kC], gv[kC];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          kv[r] = Ks[(ty + 16 * r) * kP + d];
          vv[r] = Vs[(ty + 16 * r) * kP + d];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          qv[c] = Qs[(tx + 16 * c) * kP + d];
          gv[c] = Gs[(tx + 16 * c) * kP + d];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            st[r][c] = fmaf(kv[r], qv[c], st[r][c]);
            dpt[r][c] = fmaf(vv[r], gv[c], dpt[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int kk = ty + 16 * r, qq = tx + 16 * c;
          const int qi = q0 + qq;
          const float p = qi < S && live_key(k0 + kk, qi, window)
                              ? expf(st[r][c] * scale - Ls[qq])
                              : 0.f;
          Ps[kk * kSP + qq] = round_to<T>(p);
          Ss[kk * kSP + qq] = p * (dpt[r][c] - Ds[qq]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float gq[kD], qd[kD];
#pragma unroll
        for (int j = 0; j < kD; ++j) {
          gq[j] = Gs[qq * kP + tx + 16 * j];
          qd[j] = Qs[qq * kP + tx + 16 * j];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float pr = Ps[(ty + 16 * r) * kSP + qq];
          const float sr = Ss[(ty + 16 * r) * kSP + qq];
#pragma unroll
          for (int j = 0; j < kD; ++j) {
            acc_v[r][j] = fmaf(pr, gq[j], acc_v[r][j]);
            acc_k[r][j] = fmaf(sr, qd[j], acc_k[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj < S) {
      const size_t base = (static_cast<size_t>(b) * S + kj) * kv_pitch +
                          static_cast<size_t>(g) * HD;
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        dk[base + tx + 16 * j] = from_f<T>(acc_k[r][j] * scale);
        dv[base + tx + 16 * j] = from_f<T>(acc_v[r][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: dQ, one block a (query tile, b, h)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq, int S,
                    int H, int KV, int window, float scale) {
  constexpr int BK = BwdTile<HD>::BK, BQ = BwdTile<HD>::BQ;
  constexpr int kP = HD + 1;
  constexpr int kSP = BK + 1;
  constexpr int kR = BQ / 16;          // queries a thread
  constexpr int kC = BK / 16;          // keys a thread (scores)
  constexpr int kD = HD / 16;          // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][kP]
  float* Gs = Qs + BQ * kP;            // dO, [BQ][kP]
  float* Ks = Gs + BQ * kP;            // [BK][kP]
  float* Vs = Ks + BK * kP;            // [BK][kP]
  float* Ss = Vs + BK * kP;            // dS, [BQ][kSP]
  float* Ls = Ss + BQ * kSP;           // [BQ]
  float* Ds = Ls + BQ;                 // [BQ]

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t kv_pitch = static_cast<size_t>(KV) * HD;
  const size_t q_pitch = static_cast<size_t>(H) * HD;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + g) * HD;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + g) * HD;

  stage_rows<T, HD, BQ>(Qs, q + (static_cast<size_t>(b) * S * H + h) * HD,
                        q_pitch, q0, S);
  stage_rows<T, HD, BQ>(Gs, dout + (static_cast<size_t>(b) * S * H + h) * HD,
                        q_pitch, q0, S);
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = D + (static_cast<size_t>(b) * H + h) * S;
  for (int e = threadIdx.x; e < BQ; e += kThreads) {
    Ls[e] = q0 + e < S ? lb[q0 + e] : 0.f;
    Ds[e] = q0 + e < S ? db[q0 + e] : 0.f;
  }

  float acc[kR][kD];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kD; ++j) acc[r][j] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int t_end = q_last / BK;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // the last tile's Ks and Ss reads are done
    stage_rows<T, HD, BK>(Ks, kb, kv_pitch, k0, S);
    stage_rows<T, HD, BK>(Vs, vb, kv_pitch, k0, S);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's queries and keys
    float sc[kR][kC], dp[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kR], gv[kR], kv[kC], vv[kC];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        qv[r] = Qs[(ty + 16 * r) * kP + d];
        gv[r] = Gs[(ty + 16 * r) * kP + d];
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        kv[c] = Ks[(tx + 16 * c) * kP + d];
        vv[c] = Vs[(tx + 16 * c) * kP + d];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
          dp[r][c] = fmaf(gv[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int qq = ty + 16 * r, kk = tx + 16 * c;
        const int qi = q0 + qq;
        const float p = qi < S && live_key(k0 + kk, qi, window)
                            ? expf(sc[r][c] * scale - Ls[qq])
                            : 0.f;
        Ss[qq * kSP + kk] = p * (dp[r][c] - Ds[qq]);
      }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kd[kD];
#pragma unroll
      for (int j = 0; j < kD; ++j) kd[j] = Ks[kk * kP + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float sr = Ss[(ty + 16 * r) * kSP + kk];
#pragma unroll
        for (int j = 0; j < kD; ++j) acc[r][j] = fmaf(sr, kd[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi < S) {
      T* dst = dq + (static_cast<size_t>(b) * S + qi) * q_pitch +
               static_cast<size_t>(h) * HD;
#pragma unroll
      for (int j = 0; j < kD; ++j)
        dst[tx + 16 * j] = from_f<T>(acc[r][j] * scale);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: passes 2 and 3 on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
//
// Four warps a block, each owning 16 rows: 16 keys of a 64-key tile in
// pass 2, 16 queries of a 64-query tile in pass 3.  A warp's S^T and dP^T
// (pass 2) or S and dP (pass 3) stay in its mma accumulators: the score's
// row is the fragment's row, so lse and D are read per column (pass 2) or
// per row (pass 3), and the accumulator layout of two adjacent 8-column
// tiles is the A operand of one 16-deep step, so P^T and dS^T (pass 2) or
// dS (pass 3) enter the next products from registers, rounded to bf16 (P
// as the forward rounds it; dS as a bf16 backward rounds it).  The other
// operand of those products is staged transposed (Q and dO in pass 2, K
// in pass 3), so every B fragment is a 32-bit pair.  A block accumulates
// DC <= 128 output columns (hd 256 runs two column blocks, recomputing
// the scores once more) so that its accumulators stay in registers.
// Shared-memory rows are padded by 8 elements so the 8 rows a fragment
// load touches fall in different banks.

constexpr int kMmaRows = 64;         // rows a block: 4 warps x 16
constexpr int kMmaThreads = 128;
constexpr int kMmaCols = 32;         // the other side's tile: 4 x 8

template <int HD>
constexpr int kMmaDC = HD < 128 ? HD : 128;     // output columns a block

template <int HD>
constexpr size_t mma_smem_bytes() {
  // two [64][hd + 8] tiles, two [32][hd + 8] tiles, two transposed
  // [DC][32 + 8] tiles (pass 3 uses one), lse and D of 64 rows
  return sizeof(__nv_bfloat16) *
             (2 * (kMmaRows + kMmaCols) * (HD + 8) +
              2 * kMmaDC<HD> * (kMmaCols + 8)) +
         sizeof(float) * 2 * kMmaRows;
}

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

// ROWS rows of a [B, S, heads, HD] bf16 tensor from row0 into shared memory
// with pitch HD + 8, 16 bytes a load; rows past S are zeros
template <int HD, int ROWS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t pitch, int row0, int S) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = threadIdx.x; e < ROWS * HD / 8; e += kMmaThreads) {
    const int r = e / (HD / 8), c = e % (HD / 8) * 8;
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) =
        row0 + r < S ? *reinterpret_cast<const uint4*>(
                           src + static_cast<size_t>(row0 + r) * pitch + c)
                     : zero;
  }
}

// columns c0 .. c0 + DC of ROWS rows, transposed: dst[col][row], pitch
// ROWS + 8; neighbouring threads take neighbouring rows, so their 2-byte
// stores share words instead of banks
template <int DC, int ROWS>
__device__ __forceinline__ void stage_bf16_t(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             size_t pitch, int row0, int S,
                                             int c0) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = threadIdx.x; e < ROWS * DC / 8; e += kMmaThreads) {
    const int r = e % ROWS, c = e / ROWS * 8;
    const uint4 raw =
        row0 + r < S
            ? *reinterpret_cast<const uint4*>(
                  src + static_cast<size_t>(row0 + r) * pitch + c0 + c)
            : zero;
    const auto* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * (ROWS + 8) + r] = vals[i];
  }
}

// the A fragment of rows r0 .. r0 + 15, columns kk .. kk + 15 of a
// row-major tile with pitch P
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int kk, int quad, int pair) {
  const __nv_bfloat16* p = tile + (r0 + quad) * P + kk + 2 * pair;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * P);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * P + 8);
}

// the B fragment of n-columns n0 .. n0 + 7, k-rows kk .. kk + 15, from a
// tile stored [n][k] with pitch P
template <int P>
__device__ __forceinline__ void load_b(uint32_t (&b)[2],
                                       const __nv_bfloat16* tile, int n0,
                                       int kk, int quad, int pair) {
  const __nv_bfloat16* p = tile + (n0 + quad) * P + kk + 2 * pair;
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// pass 2, bf16: dK and dV of DC columns, one block a (64-key tile, b, kv
// head, column block)
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int S, int H,
                          int KV, int window, float scale) {
  constexpr int BK = kMmaRows, BQ = kMmaCols, DC = kMmaDC<HD>;
  constexpr int P = HD + 8, PT = BQ + 8;
  constexpr int kNT = BQ / 8;          // 8-query tiles of S^T
  constexpr int kDT = DC / 8;          // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BK][P]
  __nv_bfloat16* Vs = Ks + BK * P;                         // [BK][P]
  __nv_bfloat16* Qs = Vs + BK * P;                         // [BQ][P]
  __nv_bfloat16* Gs = Qs + BQ * P;                         // dO, [BQ][P]
  __nv_bfloat16* Qt = Gs + BQ * P;                         // [DC][PT]
  __nv_bfloat16* Gt = Qt + DC * PT;                        // [DC][PT]
  auto* Ls = reinterpret_cast<float*>(Gt + DC * PT);       // [BQ]
  float* Ds = Ls + BQ;                                     // [BQ]

  const int b = blockIdx.y / KV, g = blockIdx.y % KV;
  const int k0 = blockIdx.x * BK;
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, pair = lane % 4;
  const int r0 = 16 * warp;            // this warp's keys in the tile
  const int rep = H / KV;
  const size_t kv_pitch = static_cast<size_t>(KV) * HD;
  const size_t q_pitch = static_cast<size_t>(H) * HD;

  stage_bf16<HD, BK>(Ks, k + (static_cast<size_t>(b) * S * KV + g) * HD,
                     kv_pitch, k0, S);
  stage_bf16<HD, BK>(Vs, v + (static_cast<size_t>(b) * S * KV + g) * HD,
                     kv_pitch, k0, S);

  float acc_k[kDT][4], acc_v[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;

  const int k_last = min(k0 + BK, S) - 1;
  const int qt_begin = k0 / BQ;
  const int qt_end =
      (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / BQ;

  for (int hr = 0; hr < rep; ++hr) {
    const int h = g * rep + hr;
    const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
    const __nv_bfloat16* gb =
        dout + (static_cast<size_t>(b) * S * H + h) * HD;
    const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* db = D + (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt_begin; qt <= qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();          // every warp is done with the last tile
      stage_bf16<HD, BQ>(Qs, qb, q_pitch, q0, S);
      stage_bf16<HD, BQ>(Gs, gb, q_pitch, q0, S);
      stage_bf16_t<DC, BQ>(Qt, qb, q_pitch, q0, S, c0);
      stage_bf16_t<DC, BQ>(Gt, gb, q_pitch, q0, S, c0);
      for (int e = threadIdx.x; e < BQ; e += kMmaThreads) {
        Ls[e] = q0 + e < S ? lb[q0 + e] : 0.f;
        Ds[e] = q0 + e < S ? db[q0 + e] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries
      float st[kNT][4], dpt[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t ak[4], av[4];
        load_a<P>(ak, Ks, r0, kk, quad, pair);
        load_a<P>(av, Vs, r0, kk, quad, pair);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t bq[2], bg[2];
          load_b<P>(bq, Qs, 8 * nt, kk, quad, pair);
          load_b<P>(bg, Gs, 8 * nt, kk, quad, pair);
          mma_bf16(st[nt], ak, bq);
          mma_bf16(dpt[nt], av, bg);
        }
      }
      // P^T and dS^T; accumulator i of tile nt is key r0 + quad + 8 (i / 2),
      // query 8 nt + 2 pair + i % 2
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + r0 + quad + 8 * (i / 2);
          const int qq = 8 * nt + 2 * pair + i % 2;
          const int qi = q0 + qq;
          const float p = qi < S && live_key(kj, qi, window)
                              ? expf(st[nt][i] * scale - Ls[qq])
                              : 0.f;
          dpt[nt][i] = p * (dpt[nt][i] - Ds[qq]);
          st[nt][i] = p;
        }
      // dV += P^T dO, dK += dS^T Q, 16 queries a step
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        const uint32_t ap[4] = {
            pack_pair(st[2 * kc][0], st[2 * kc][1]),
            pack_pair(st[2 * kc][2], st[2 * kc][3]),
            pack_pair(st[2 * kc + 1][0], st[2 * kc + 1][1]),
            pack_pair(st[2 * kc + 1][2], st[2 * kc + 1][3])};
        const uint32_t as[4] = {
            pack_pair(dpt[2 * kc][0], dpt[2 * kc][1]),
            pack_pair(dpt[2 * kc][2], dpt[2 * kc][3]),
            pack_pair(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
            pack_pair(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          uint32_t bg[2], bq[2];
          load_b<PT>(bg, Gt, 8 * dt, 16 * kc, quad, pair);
          load_b<PT>(bq, Qt, 8 * dt, 16 * kc, quad, pair);
          mma_bf16(acc_v[dt], ap, bg);
          mma_bf16(acc_k[dt], as, bq);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = k0 + r0 + quad + 8 * half;
    if (kj < S) {
      const size_t base = (static_cast<size_t>(b) * S + kj) * kv_pitch +
                          static_cast<size_t>(g) * HD + c0 + 2 * pair;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        *reinterpret_cast<uint32_t*>(dk + base + 8 * dt) =
            pack_pair(acc_k[dt][2 * half] * scale,
                      acc_k[dt][2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * dt) =
            pack_pair(acc_v[dt][2 * half], acc_v[dt][2 * half + 1]);
      }
    }
  }
}

// pass 3, bf16: dQ of DC columns, one block a (64-query tile, b, h, column
// block)
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D,
                        __nv_bfloat16* __restrict__ dq, int S, int H, int KV,
                        int window, float scale) {
  constexpr int BQ = kMmaRows, BK = kMmaCols, DC = kMmaDC<HD>;
  constexpr int P = HD + 8, PT = BK + 8;
  constexpr int kNT = BK / 8;          // 8-key tiles of S
  constexpr int kDT = DC / 8;          // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][P]
  __nv_bfloat16* Gs = Qs + BQ * P;                         // dO, [BQ][P]
  __nv_bfloat16* Ks = Gs + BQ * P;                         // [BK][P]
  __nv_bfloat16* Vs = Ks + BK * P;                         // [BK][P]
  __nv_bfloat16* Kt = Vs + BK * P;                         // [DC][PT]
  auto* Ls = reinterpret_cast<float*>(Kt + 2 * DC * PT);   // [BQ]
  float* Ds = Ls + BQ;                                     // [BQ]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, pair = lane % 4;
  const int r0 = 16 * warp;            // this warp's queries in the tile
  const size_t kv_pitch = static_cast<size_t>(KV) * HD;
  const size_t q_pitch = static_cast<size_t>(H) * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * S * KV + g) * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * S * KV + g) * HD;

  stage_bf16<HD, BQ>(Qs, q + (static_cast<size_t>(b) * S * H + h) * HD,
                     q_pitch, q0, S);
  stage_bf16<HD, BQ>(Gs, dout + (static_cast<size_t>(b) * S * H + h) * HD,
                     q_pitch, q0, S);
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = D + (static_cast<size_t>(b) * H + h) * S;
  for (int e = threadIdx.x; e < BQ; e += kMmaThreads) {
    Ls[e] = q0 + e < S ? lb[q0 + e] : 0.f;
    Ds[e] = q0 + e < S ? db[q0 + e] : 0.f;
  }

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int t_end = q_last / BK;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // every warp is done with the last tile
    stage_bf16<HD, BK>(Ks, kb, kv_pitch, k0, S);
    stage_bf16<HD, BK>(Vs, vb, kv_pitch, k0, S);
    stage_bf16_t<DC, BK>(Kt, kb, kv_pitch, k0, S, c0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 queries x BK keys
    float sc[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t aq[4], ag[4];
      load_a<P>(aq, Qs, r0, kk, quad, pair);
      load_a<P>(ag, Gs, r0, kk, quad, pair);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bk[2], bv[2];
        load_b<P>(bk, Ks, 8 * nt, kk, quad, pair);
        load_b<P>(bv, Vs, 8 * nt, kk, quad, pair);
        mma_bf16(sc[nt], aq, bk);
        mma_bf16(dp[nt], ag, bv);
      }
    }
    // dS; accumulator i of tile nt is query r0 + quad + 8 (i / 2), key
    // 8 nt + 2 pair + i % 2
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = r0 + quad + 8 * (i / 2);
        const int qi = q0 + qq;
        const int kj = k0 + 8 * nt + 2 * pair + i % 2;
        const float p = qi < S && live_key(kj, qi, window)
                            ? expf(sc[nt][i] * scale - Ls[qq])
                            : 0.f;
        dp[nt][i] = p * (dp[nt][i] - Ds[qq]);
      }
    // dQ += dS K, 16 keys a step
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t as[4] = {
          pack_pair(dp[2 * kc][0], dp[2 * kc][1]),
          pack_pair(dp[2 * kc][2], dp[2 * kc][3]),
          pack_pair(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
          pack_pair(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t bk[2];
        load_b<PT>(bk, Kt, 8 * dt, 16 * kc, quad, pair);
        mma_bf16(acc[dt], as, bk);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + quad + 8 * half;
    if (qi < S) {
      __nv_bfloat16* dst = dq + (static_cast<size_t>(b) * S + qi) * q_pitch +
                           static_cast<size_t>(h) * HD + c0 + 2 * pair;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(dst + 8 * dt) =
            pack_pair(acc[dt][2 * half] * scale,
                      acc[dt][2 * half + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* D;
  int B, S, H, KV, window;
  float scale;
  cudaStream_t stream;
};

// pass 1, one warp a row
template <typename T>
int launch_dot(const Args& a, int hd) {
  const int rows = a.B * a.S * a.H;
  const int per_block = kThreads / 32;
  flash_bwd_dot_kernel<T><<<(rows + per_block - 1) / per_block, kThreads, 0,
                            a.stream>>>(static_cast<const T*>(a.out),
                                        static_cast<const T*>(a.dout), a.D,
                                        rows, a.S, a.H, hd);
  return static_cast<int>(cudaGetLastError());
}

// passes 2 and 3 on the CUDA cores
template <typename T, int HD>
int launch(const Args& a) {
  constexpr int BK = BwdTile<HD>::BK, BQ = BwdTile<HD>::BQ;
  constexpr size_t smem = bwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const dim3 grid_kv((a.S + BK - 1) / BK, a.B * a.KV);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.D, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.S, a.H, a.KV, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((a.S + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.D, static_cast<T*>(a.dq), a.S, a.H, a.KV,
      a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// passes 2 and 3 on the tensor cores (bf16)
template <int HD>
int launch_mma(const Args& a) {
  constexpr int DC = kMmaDC<HD>;
  constexpr size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  const dim3 grid_kv((a.S + kMmaRows - 1) / kMmaRows, a.B * a.KV, HD / DC);
  flash_bwd_dkdv_mma_kernel<HD><<<grid_kv, kMmaThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.D, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.H, a.KV, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((a.S + kMmaRows - 1) / kMmaRows, a.B * a.H, HD / DC);
  flash_bwd_dq_mma_kernel<HD><<<grid_q, kMmaThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.D, static_cast<bf16*>(a.dq), a.S, a.H, a.KV,
      a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// passes 2 and 3: bf16 on the tensor cores, float32 on the CUDA cores
template <typename T, int HD>
int launch_passes(const Args& a) {
  if constexpr (sizeof(T) == 2)
    return launch_mma<HD>(a);
  else
    return launch<T, HD>(a);
}

template <typename T>
int launch_hd(const Args& a, int hd) {
  int err = launch_dot<T>(a, hd);
  if (err) return err;
  switch (hd) {
    case 16: return launch_passes<T, 16>(a);
    case 32: return launch_passes<T, 32>(a);
    case 64: return launch_passes<T, 64>(a);
    case 128: return launch_passes<T, 128>(a);
    case 256: return launch_passes<T, 256>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out, dout, dq: [B, S, H, hd]; k, v, dk, dv: [B, S, KV, hd]; all
// contiguous, one dtype (is_bf16 ? bf16 : float32); lse: float32
// [B, H, S] from the forward; D: float32 [B, H, S] scratch.  H % KV == 0;
// hd in {16, 32, 64, 128, 256}.  Three launches on the stream: D, then dK
// and dV, then dQ.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv, void* D,
    int B, int S, int H, int KV, int hd, int window, float scale, int is_bf16,
    void* stream) {
  const Args a{q,  k,  v,  out, dout, static_cast<const float*>(lse),
               dq, dk, dv, static_cast<float*>(D),
               B,  S,  H,  KV,  window, scale,
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch_hd<__nv_bfloat16>(a, hd) : launch_hd<float>(a, hd);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
