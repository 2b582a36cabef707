// Causal GQA flash attention, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference has no Pallas backward: it trains
// by differentiating its chunked attention with jax.value_and_grad
// (src/repro/models/attention.py:98, through src/repro/launch/steps.py),
// whose checkpointed chunk body recomputes P in backward.  The port runs
// the forward kernel (flash_attention.cu) on the card, so its gradient is
// this kernel: the gradient of
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
// to the input type, as it enters P.V in the forward; dS enters dK and dQ
// rounded likewise on the tensor-core routes.
//
// Bound: operations.  The gradient needs 10 * B * H * hd * live flops (S,
// dP, dV, dK, dQ: five products of 2 * hd flops a live pair).  At
// gemma3-1b's training shape (B 4, S 2,048, H 4, KV 1, hd 256) that is
// 8.6e10 flops at window 0 (87 us at the bf16 tensor-core peak) and 3.8e10
// at window 512 (38 us).  Passes 2 and 3 each compute S and dP, so the
// kernels do 14 * B * H * hd * live.  Like the forward, no pass loads a
// tile that the causal mask or the window removes entirely: pass 2 walks
// only the query tiles that see its keys, pass 3 only the KV tiles its
// queries see.
//
// Determinism: no atomics.  Pass 2 gives each block one key tile of one
// (b, kv head) and walks its group's query heads and their live query
// tiles in a fixed order, with dK and dV in registers; pass 3 gives each
// block one query tile of one (b, h) and walks its live KV tiles in order.
// Each output element is written once, by one thread, after a sum in a
// fixed order, so repeats are bit-identical.
//
// Three routes, as the forward has them:
//
// bf16 at hd 64, 128, 256 (every model call): the Hopper kernels below
//   (flash_bwd_dkdv_hopper_kernel, flash_bwd_dq_hopper_kernel).  What
//   they do about the mma.sync design they replace:
//   - latency: a producer warpgroup that keeps 40 registers a thread and
//     two consumer warpgroups at 232 (pass 3 at hd 64 and 128: 24, and
//     three at 160), so each SM holds 8 or 12 consumer warps at every head
//     size (the mma.sync kernels had 4 at hd 256);
//   - staging: every tile arrives by TMA into a ring of shared-memory
//     stages (two or three) with full and empty mbarriers, issued by the
//     producer's first warp while the consumers compute on the last stage;
//     the consumers never stage or transpose by hand, and no
//     __syncthreads() stands between a tile's arrival and its products.
//     Pass 2's producer lanes also bring each query tile's lse (times
//     log2 e) and D into the stage, and arrive at its full barrier;
//   - tiles: every product is wgmma over 64 rows a warpgroup: S^T = K Q^T
//     and dP^T = V dO^T (pass 2) or S = Q K^T and dP = dO V^T (pass 3) with
//     both operands in shared memory, K-major; dV += P^T dO, dK += dS^T Q
//     and dQ += dS K with A from registers (the score accumulators rounded
//     to bf16 in place are the A operand) and B read MN-major through the
//     descriptor, never transposed by hand;
//   - arithmetic: at hd 256 the two float32 accumulators of 64 keys x 256
//     columns would take 256 registers a thread, so pass 2's two consumer
//     warpgroups share one 64-key tile: one computes S^T and P^T and holds
//     dV, the other dP^T and dS^T and holds dK, P^T passing between them
//     through 16 KB of shared memory (float32, thread for thread, full and
//     empty mbarriers).  S and dP are computed once a tile, so no pass
//     repeats a product for want of registers (the mma.sync kernels ran hd
//     256 as two 128-column blocks, recomputing both);
//   - masking: only the tiles that cross the diagonal or the window's edge
//     for some row of a warpgroup run the per-element mask; the others go
//     straight to P = exp2(s * scale * log2 e - lse * log2 e), one FMA and
//     one ex2 a score;
//   - balance: pass 3 issues its heaviest query tiles first, as the
//     forward does, and pass 2 its first key tiles (those that see the
//     most queries) first.
//   Tiles (a block's rows x streamed rows x stages, consumer warpgroups;
//   shared memory), chosen by timing the training shapes
//   (tools/flash_bwd_designs.py): pass 2 at hd 64 128 keys x 128 queries
//   x 3, two (132 KB); hd 128 128 x 64 x 2, two (130 KB); hd 256 64 x 64
//   x 2, two sharing the keys (210 KB); pass 3 at hd 64 192 queries x 64
//   keys x 3, three (97 KB); hd 128 192 x 64 x 2, three (161 KB); hd 256
//   128 x 32 x 2, two (193 KB: 64-key tiles would not fit beside Q and
//   dO).  One block an SM throughout.
//
// bf16 at hd 16 and 32 (the smoke configurations): mma.sync, described at
//   flash_bwd_dkdv_mma_kernel below; too narrow for 64-column TMA slabs,
//   as in the forward.
//
// float32 (the comparisons' exact twin): the CUDA cores, every product a
//   float32 FMA.  A 16 x 16 thread grid: in pass 2 thread (ty, tx) owns keys
//   ty + 16 r of its tile and output columns tx + 16 j, and its S^T and
//   dP^T scores are those keys against queries tx + 16 c; pass 3 swaps
//   the roles of queries and keys.  Rows in shared memory have an odd
//   pitch (hd + 1 floats), so the 16 rows a half-warp reads fall in
//   different banks.  Tiles (keys x queries): 64 x 64 at hd <= 128,
//   32 x 32 at hd 256 (140 KB of shared memory).

#include "attention_sm90.cuh"   // TMA maps and loads, descriptors, bf16 wgmma

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
// pass 1: D = rowsum(dO o O), 16 bytes a thread a step
// ---------------------------------------------------------------------------

// threads that share a (b, i, h) row of hd elements: a power of 2, <= 32
template <typename T>
__host__ __device__ constexpr int dot_lanes(int hd) {
  return hd / (16 / static_cast<int>(sizeof(T))) < 32
             ? hd / (16 / static_cast<int>(sizeof(T)))
             : 32;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                     float* __restrict__ D, int rows, int S, int H, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  const int lanes = dot_lanes<T>(hd);
  const int lane = threadIdx.x % 32;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / lanes;
  const int sub = lane % lanes;
  float acc = 0.f;
  if (row < rows) {
    const T* o = out + static_cast<size_t>(row) * hd;
    const T* g = dout + static_cast<size_t>(row) * hd;
    for (int c = sub * kVec; c < hd; c += lanes * kVec) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + c);
      const uint4 b = *reinterpret_cast<const uint4*>(g + c);
      const T* av = reinterpret_cast<const T*>(&a);
      const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc = fmaf(to_f(av[e]), to_f(bv[e]), acc);
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) {
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
// bf16 at hd 16 and 32: passes 2 and 3 on mma.sync m16n8k16
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
// in pass 3), so every B fragment is a 32-bit pair.  Shared-memory rows are padded by 8 elements so the 8 rows a fragment
// load touches fall in different banks.

constexpr int kMmaRows = 64;         // rows a block: 4 warps x 16
constexpr int kMmaThreads = 128;
constexpr int kMmaCols = 32;         // the other side's tile: 4 x 8

template <int HD>
constexpr size_t mma_smem_bytes() {
  // two [64][hd + 8] tiles, two [32][hd + 8] tiles, two transposed
  // [hd][32 + 8] tiles (pass 3 uses one), lse and D of 64 rows
  return sizeof(__nv_bfloat16) *
             (2 * (kMmaRows + kMmaCols) * (HD + 8) +
              2 * HD * (kMmaCols + 8)) +
         sizeof(float) * 2 * kMmaRows;
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// ROWS rows of HD columns, transposed: dst[col][row], pitch ROWS + 8;
// neighbouring threads take neighbouring rows, so their 2-byte stores
// share words instead of banks
template <int HD, int ROWS>
__device__ __forceinline__ void stage_bf16_t(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             size_t pitch, int row0, int S) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = threadIdx.x; e < ROWS * HD / 8; e += kMmaThreads) {
    const int r = e % ROWS, c = e / ROWS * 8;
    const uint4 raw =
        row0 + r < S
            ? *reinterpret_cast<const uint4*>(
                  src + static_cast<size_t>(row0 + r) * pitch + c)
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

// pass 2, bf16: dK and dV, one block a (64-key tile, b, kv head)
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
  constexpr int BK = kMmaRows, BQ = kMmaCols;
  constexpr int P = HD + 8, PT = BQ + 8;
  constexpr int kNT = BQ / 8;          // 8-query tiles of S^T
  constexpr int kDT = HD / 8;          // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BK][P]
  __nv_bfloat16* Vs = Ks + BK * P;                         // [BK][P]
  __nv_bfloat16* Qs = Vs + BK * P;                         // [BQ][P]
  __nv_bfloat16* Gs = Qs + BQ * P;                         // dO, [BQ][P]
  __nv_bfloat16* Qt = Gs + BQ * P;                         // [HD][PT]
  __nv_bfloat16* Gt = Qt + HD * PT;                        // [HD][PT]
  auto* Ls = reinterpret_cast<float*>(Gt + HD * PT);       // [BQ]
  float* Ds = Ls + BQ;                                     // [BQ]

  const int b = blockIdx.y / KV, g = blockIdx.y % KV;
  const int k0 = blockIdx.x * BK;
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
      stage_bf16_t<HD, BQ>(Qt, qb, q_pitch, q0, S);
      stage_bf16_t<HD, BQ>(Gt, gb, q_pitch, q0, S);
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
                          static_cast<size_t>(g) * HD + 2 * pair;
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

// pass 3, bf16: dQ, one block a (64-query tile, b, h)
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
  constexpr int BQ = kMmaRows, BK = kMmaCols;
  constexpr int P = HD + 8, PT = BK + 8;
  constexpr int kNT = BK / 8;          // 8-key tiles of S
  constexpr int kDT = HD / 8;          // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][P]
  __nv_bfloat16* Gs = Qs + BQ * P;                         // dO, [BQ][P]
  __nv_bfloat16* Ks = Gs + BQ * P;                         // [BK][P]
  __nv_bfloat16* Vs = Ks + BK * P;                         // [BK][P]
  __nv_bfloat16* Kt = Vs + BK * P;                         // [HD][PT]
  auto* Ls = reinterpret_cast<float*>(Kt + 2 * HD * PT);   // [BQ]
  float* Ds = Ls + BQ;                                     // [BQ]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
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
    stage_bf16_t<HD, BK>(Kt, kb, kv_pitch, k0, S);
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
                           static_cast<size_t>(h) * HD + 2 * pair;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(dst + 8 * dt) =
            pack_pair(acc[dt][2 * half] * scale,
                      acc[dt][2 * half + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 128, 256: TMA ring, a producer warp, wgmma
// ---------------------------------------------------------------------------
//
// Both passes run 384 threads a block: a producer warpgroup that gives up
// its registers (setmaxnreg) and whose first warp issues every copy, and
// two consumer warpgroups of 64 rows each.  Tiles arrive by TMA from
// tensor maps over the [B, S, heads, hd] tensors (64-column slabs, 128-byte
// swizzle, rows past S as zeros) into a ring of stages with a full and an
// empty mbarrier each; every consumer warp arrives at the empty one when
// its products of the stage are done.  Products are wgmma m64nNk16:
// scores with both operands in shared memory (K-major), gradients with A
// from registers (the score accumulators rounded to bf16 in place) and B
// read MN-major through the descriptor.  Only the tiles that cross the
// diagonal or the window's edge for some row of a warpgroup run the
// per-element mask.

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// C consumer warpgroups beside the producer warpgroup, and the registers
// a thread of each keeps after setmaxnreg: at most 65,536 a block
template <int C, int ProducerRegs, int ConsumerRegs>
struct WarpgroupTiling {
  static constexpr int kConsumers = C, kThreads = 128 * (1 + C);
  static constexpr int kProducerRegs = ProducerRegs;
  static constexpr int kConsumerRegs = ConsumerRegs;
  static_assert(128 * (ProducerRegs + C * ConsumerRegs) <= 65536);
};
template <int C> struct Warpgroups;
template <> struct Warpgroups<2> : WarpgroupTiling<2, 40, 232> {};
template <> struct Warpgroups<3> : WarpgroupTiling<3, 24, 160> {};

// pass 2: consumer warpgroups, queries a streamed tile and stages in the
// ring.  kSplit: two consumer warpgroups take the same 64 keys, one
// holding dV and the other dK (hd 256, where the two float32 accumulators
// of 64 x 256 would take 256 registers a thread); else each owns 64 keys
// and holds both.
template <bool Split, int C, int Q, int Stages>
struct DkdvTiling : Warpgroups<C> {
  static_assert(!Split || C == 2);
  static constexpr bool kSplit = Split;
  static constexpr int BK = Split ? 64 : 64 * C;     // keys a block
  static constexpr int BQ = Q, kStages = Stages;
};
template <int HD> struct DkdvTile;
template <> struct DkdvTile<64> : DkdvTiling<false, 2, 128, 3> {};
template <> struct DkdvTile<128> : DkdvTiling<false, 2, 64, 2> {};
template <> struct DkdvTile<256> : DkdvTiling<true, 2, 64, 2> {};

// pass 3: consumer warpgroups of 64 query rows, keys a streamed tile and
// stages in the ring
template <int C, int K, int Stages>
struct DqTiling : Warpgroups<C> {
  static constexpr int kRows = 64 * C, BK = K, kStages = Stages;
};
template <int HD> struct DqTile;
template <> struct DqTile<64> : DqTiling<3, 64, 3> {};
template <> struct DqTile<128> : DqTiling<3, 64, 2> {};
template <> struct DqTile<256> : DqTiling<2, 32, 2> {};

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  using T = DkdvTile<HD>;
  // 1 KB to align the base to the swizzle atom; K and V; Q and dO a stage;
  // lse and D a stage; P^T passed between the warpgroups (split); the
  // barriers: K and V, full and empty a stage, the exchange's two
  return 1024 + 2 * (2 * T::BK * HD + 2 * T::kStages * T::BQ * HD) +
         4 * 2 * T::kStages * T::BQ + (T::kSplit ? 4 * 128 * T::BQ / 2 : 0) +
         8 * (1 + 2 * T::kStages + 2);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  using T = DqTile<HD>;
  // the aligning 1 KB; Q and dO; K and V a stage; the barriers: Q and dO,
  // full and empty a stage
  return 1024 + 2 * (2 * T::kRows * HD + 2 * T::kStages * T::BK * HD) +
         8 * (1 + 2 * T::kStages);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d (+)= A . B^T over HD: A (64 rows) and B (N rows) K-major in shared
// memory, each in HD / 64 slabs of its tile's ARows and BRows rows
template <int HD, int ARows, int BRows, int NA>
__device__ __forceinline__ void mma_ss(float (&d)[NA], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(d, smem_desc(a + (kk / 4) * ARows * kSlab + col, 16, 1024),
             smem_desc(b + (kk / 4) * BRows * kSlab + col, 16, 1024),
             kk > 0);
  }
}

// d += A . B: A from registers in K / 16 fragments of 16 columns, B
// [K rows x N] in shared memory in slabs of Rows rows, read MN-major
template <int K, int Rows, int NA>
__device__ __forceinline__ void mma_rs(float (&d)[NA],
                                       const uint32_t (&a)[K / 16][4],
                                       uint32_t b) {
#pragma unroll
  for (int c = 0; c < K / 16; ++c)
    wgmma_rs(d, a[c], smem_desc(b + c * 16 * kSlab, Rows * kSlab, 1024));
}

// an accumulator of N columns as the A operand of a product over those
// columns: two adjacent 8-column blocks are one 16-deep fragment, rounded
// to bf16
template <int N>
__device__ __forceinline__ void as_operand(uint32_t (&a)[N / 16][4],
                                           const float (&x)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[c][r] = pack_pair(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
}

// pass 2's mask on S^T [64 keys x N queries]: accumulator 4j + 2 half + e
// is key kw0 + 16 warp + quad + 8 half against query q0 + 8j + 2 pair + e,
// dead where q - k < 0 or, with a window, q - k >= window
template <int N>
__device__ __forceinline__ void mask_keys(float (&st)[N / 2], int q0,
                                          int kw0, int warp, int quad,
                                          int pair, int window) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int d0 = q0 - kw0 - 16 * warp - quad - 8 * half + 2 * pair;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + 8 * j + e;
        if (d < 0 || (window > 0 && d >= window))
          st[4 * j + 2 * half + e] = kNegInf;
      }
  }
}

// pass 3's mask on S [64 queries x N keys], as the forward's: key k0 + c
// (c = 8j + 2 pair + e) is live for query qi when c <= qi - k0 and, with a
// window, c > qi - k0 - window
template <int N>
__device__ __forceinline__ void mask_queries(float (&sc)[N / 2], int row,
                                             int k0, int pair, int window) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int hi = row + 8 * half - k0 - 2 * pair;
    const int lo = window > 0 ? hi - window : -(1 << 30);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + e > hi || 8 * j + e <= lo)
          sc[4 * j + 2 * half + e] = kNegInf;
  }
}

// what a pass-2 consumer warpgroup holds: dK and dV of its own 64 keys,
// or (split) dV or dK of the block's 64
enum Role { kBoth, kDvOnly, kDkOnly };

// Shared memory of pass 2: K and V of the block's keys, then the ring of
// Q and dO tiles, then each stage's lse * log2(e) and D (BQ floats each),
// then (split) P^T as the dV warpgroup hands it to the dK one, thread for
// thread (the two accumulators have one layout), then the barriers.
struct DkdvSmem {
  uint32_t k, v, q, g, kv_bar, full, empty, x_full, x_empty;
  const float* stats;
  float* xchg;
};

template <int HD, int R>
__device__ __forceinline__ void dkdv_consumer(
    const DkdvSmem& sm, int wgc, int b, int g, int k0, int rep,
    int qt_begin, int qt_end, int S, int KV, int window, float scale,
    float scale_log2, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv) {
  using T = DkdvTile<HD>;
  constexpr int BK = T::BK, BQ = T::BQ, kStages = T::kStages;
  constexpr uint32_t kQBytes = 2 * BQ * HD;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, pair = lane % 4;
  const int kw0 = k0 + (R == kBoth ? 64 * wgc : 0);    // this warpgroup's
  const int kw_last = min(kw0 + 63, S - 1);            // < kw0 if none
  const uint32_t rows = (kw0 - k0) * kSlab;            // its rows' offset

  float acc_k[HD / 2], acc_v[HD / 2];
  zero_acc(acc_k);
  zero_acc(acc_v);
  mbar_wait(sm.kv_bar, 0);
  int i = 0, x = 0;               // stage uses, and live tiles passed on
  for (int hr = 0; hr < rep; ++hr) {
    for (int qt = qt_begin; qt <= qt_end; ++qt, ++i) {
      const int s = i % kStages;
      const int q0 = qt * BQ;
      const int q_hi = min(q0 + BQ, S) - 1;
      // uniform over the warpgroup: does a key of it see a query here,
      // and does any pair need the per-element mask
      const bool live = kw0 <= kw_last && kw0 <= q_hi &&
                        (window <= 0 || q0 - kw_last < window);
      const bool masked =
          q0 < kw0 + 63 || (window > 0 && q0 + BQ - 1 - kw0 >= window);
      const uint32_t q_t = sm.q + s * kQBytes, g_t = sm.g + s * kQBytes;
      const float* ls = sm.stats + s * 2 * BQ;      // lse * log2(e)
      const float* ds = ls + BQ;                     // D
      mbar_wait(sm.full + 8 * s, (i / kStages) & 1);
      if (live) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries
        float st[BQ / 2], dpt[BQ / 2];
        if constexpr (R != kDkOnly) {
          zero_acc(st);
          fence_regs(st);
        }
        if constexpr (R != kDvOnly) {
          zero_acc(dpt);
          fence_regs(dpt);
        }
        wgmma_fence();
        if constexpr (R != kDkOnly) mma_ss<HD, BK, BQ>(st, sm.k + rows, q_t);
        if constexpr (R != kDvOnly) mma_ss<HD, BK, BQ>(dpt, sm.v + rows, g_t);
        wgmma_commit();
        wgmma_wait_all();

        // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)), 0 where dead
        if constexpr (R != kDkOnly) {
          fence_regs(st);
          if (masked) mask_keys<BQ>(st, q0, kw0, warp, quad, pair, window);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 l =
                *reinterpret_cast<const float2*>(ls + 8 * j + 2 * pair);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float* p = st + 4 * j + 2 * half;
              p[0] = fast_exp2(fmaf(p[0], scale_log2, -l.x));
              p[1] = fast_exp2(fmaf(p[1], scale_log2, -l.y));
            }
          }
        }
        if constexpr (R == kDvOnly) {
          if (x > 0) mbar_wait(sm.x_empty, (x - 1) & 1);
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) sm.xchg[e * 128 + tid] = st[e];
          mbar_arrive(sm.x_full);
        }
        // dS^T = P^T o (dP^T - D), P^T from the other warpgroup (split)
        if constexpr (R != kDvOnly) {
          fence_regs(dpt);
          if constexpr (R == kDkOnly) mbar_wait(sm.x_full, x & 1);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 d =
                *reinterpret_cast<const float2*>(ds + 8 * j + 2 * pair);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 4 * j + e;
              const float p = R == kDkOnly ? sm.xchg[c * 128 + tid] : st[c];
              dpt[c] = p * (dpt[c] - (e % 2 ? d.y : d.x));
            }
          }
          if constexpr (R == kDkOnly) mbar_arrive(sm.x_empty);
        }
        ++x;

        // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
        uint32_t ap[BQ / 16][4], as[BQ / 16][4];
        if constexpr (R != kDkOnly) {
          as_operand<BQ>(ap, st);
          fence_regs(acc_v);
        }
        if constexpr (R != kDvOnly) {
          as_operand<BQ>(as, dpt);
          fence_regs(acc_k);
        }
        wgmma_fence();
        if constexpr (R != kDkOnly) mma_rs<BQ, BQ>(acc_v, ap, g_t);
        if constexpr (R != kDvOnly) mma_rs<BQ, BQ>(acc_k, as, q_t);
        wgmma_commit();
        wgmma_wait_all();
        if constexpr (R != kDkOnly) fence_regs(acc_v);
        if constexpr (R != kDvOnly) fence_regs(acc_k);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + 8 * s);   // the stage is free
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = kw0 + 16 * warp + quad + 8 * half;
    if (kj < S) {
      const size_t base =
          ((static_cast<size_t>(b) * S + kj) * KV + g) * HD + 2 * pair;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if constexpr (R != kDvOnly)
          *reinterpret_cast<uint32_t*>(dk + base + 8 * j) =
              pack_pair(acc_k[4 * j + 2 * half] * scale,
                        acc_k[4 * j + 2 * half + 1] * scale);
        if constexpr (R != kDkOnly)
          *reinterpret_cast<uint32_t*>(dv + base + 8 * j) =
              pack_pair(acc_v[4 * j + 2 * half], acc_v[4 * j + 2 * half + 1]);
      }
    }
  }
}

// pass 2, bf16 at hd 64-256: dK and dV, one block a (b, kv head, key
// tile); the key tiles that see the most queries (the first) are issued
// first
template <int HD>
__global__ void __launch_bounds__(DkdvTile<HD>::kThreads, 1)
flash_bwd_dkdv_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_g,
                             const float* __restrict__ lse,
                             const float* __restrict__ D,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int S, int H,
                             int KV, int window, float scale,
                             float scale_log2) {
  using T = DkdvTile<HD>;
  constexpr int BK = T::BK, BQ = T::BQ, kStages = T::kStages;
  constexpr int kSlabs = HD / kSlabCols;
  constexpr uint32_t kKVBytes = 2 * BK * HD;       // K or V
  constexpr uint32_t kQBytes = 2 * BQ * HD;        // Q or dO, a stage
  extern __shared__ __align__(1024) unsigned char dkdv_smem[];
  const uint32_t raw = smem_u32(dkdv_smem);
  DkdvSmem sm;
  sm.k = (raw + 1023) & ~1023u;
  sm.v = sm.k + kKVBytes;
  sm.q = sm.v + kKVBytes;                          // + stage * kQBytes
  sm.g = sm.q + kStages * kQBytes;
  const uint32_t stats = sm.g + kStages * kQBytes;
  const uint32_t xchg = stats + kStages * 2 * BQ * 4;
  sm.kv_bar = xchg + (T::kSplit ? 4 * 128 * BQ / 2 : 0);
  sm.full = sm.kv_bar + 8;                         // + 8 * stage
  sm.empty = sm.full + 8 * kStages;
  sm.x_full = sm.empty + 8 * kStages;
  sm.x_empty = sm.x_full + 8;
  float* stats_p = reinterpret_cast<float*>(dkdv_smem + (stats - raw));
  sm.stats = stats_p;
  sm.xchg = reinterpret_cast<float*>(dkdv_smem + (xchg - raw));

  const int b = blockIdx.x / KV, g = blockIdx.x % KV;
  const int k0 = blockIdx.y * BK;
  const int rep = H / KV;
  // the query tiles that see a key of this block: qi >= k0 and, with a
  // window, qi < (last key) + window
  const int k_last = min(k0 + BK, S) - 1;
  const int qt_begin = k0 / BQ;
  const int qt_end =
      (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(sm.kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      // the tiles' expect_tx, then each producer lane after its lse and D
      mbar_init(sm.full + 8 * s, 1 + 32);
      // one arrival from each consumer warp frees the stage
      mbar_init(sm.empty + 8 * s, 4 * T::kConsumers);
    }
    mbar_init(sm.x_full, 128);
    mbar_init(sm.x_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp loads every tile -----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        T::kProducerRegs));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(sm.kv_bar, 2 * kKVBytes);
        for (int j = 0; j < kSlabs; ++j) {
          tma_load(sm.k + j * BK * kSlab, &tm_k, sm.kv_bar, j * kSlabCols, g,
                   k0, b);
          tma_load(sm.v + j * BK * kSlab, &tm_v, sm.kv_bar, j * kSlabCols, g,
                   k0, b);
        }
      }
      int i = 0;
      for (int hr = 0; hr < rep; ++hr) {
        const int h = g * rep + hr;
        const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
        const float* db = D + (static_cast<size_t>(b) * H + h) * S;
        for (int qt = qt_begin; qt <= qt_end; ++qt, ++i) {
          const int s = i % kStages, q0 = qt * BQ;
          if (i >= kStages)   // the consumers released this stage's last use
            mbar_wait(sm.empty + 8 * s, ((i / kStages) - 1) & 1);
          if (lane == 0) {
            mbar_expect_tx(sm.full + 8 * s, 2 * kQBytes);
            for (int j = 0; j < kSlabs; ++j) {
              tma_load(sm.q + s * kQBytes + j * BQ * kSlab, &tm_q,
                       sm.full + 8 * s, j * kSlabCols, h, q0, b);
              tma_load(sm.g + s * kQBytes + j * BQ * kSlab, &tm_g,
                       sm.full + 8 * s, j * kSlabCols, h, q0, b);
            }
          }
          // queries past S: lse and D 0, so P^T = 1 against the zero rows
          // of Q and dO, which add nothing
          float* st = stats_p + s * 2 * BQ;
          for (int e = lane; e < BQ; e += 32) {
            const bool in = q0 + e < S;
            st[e] = in ? lb[q0 + e] * kLog2e : 0.f;
            st[BQ + e] = in ? db[q0 + e] : 0.f;
          }
          mbar_arrive(sm.full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warpgroups --------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::kConsumerRegs));
    const int wgc = threadIdx.x / 128 - 1;
    if constexpr (T::kSplit) {
      if (wgc == 0)
        dkdv_consumer<HD, kDvOnly>(sm, wgc, b, g, k0, rep, qt_begin, qt_end,
                                   S, KV, window, scale, scale_log2, dk, dv);
      else
        dkdv_consumer<HD, kDkOnly>(sm, wgc, b, g, k0, rep, qt_begin, qt_end,
                                   S, KV, window, scale, scale_log2, dk, dv);
    } else {
      dkdv_consumer<HD, kBoth>(sm, wgc, b, g, k0, rep, qt_begin, qt_end, S,
                               KV, window, scale, scale_log2, dk, dv);
    }
  }
}

// pass 3, bf16 at hd 64-256: dQ, one block a (b, h, 128-query tile), the
// heaviest query tiles first
template <int HD>
__global__ void __launch_bounds__(DqTile<HD>::kThreads, 1)
flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_g,
                           const float* __restrict__ lse,
                           const float* __restrict__ D,
                           __nv_bfloat16* __restrict__ dq, int S, int H,
                           int KV, int window, float scale,
                           float scale_log2) {
  using T = DqTile<HD>;
  constexpr int BK = T::BK, BQ = T::kRows, kStages = T::kStages;
  constexpr int kSlabs = HD / kSlabCols;
  constexpr uint32_t kQBytes = 2 * BQ * HD;        // Q or dO
  constexpr uint32_t kTileBytes = 2 * BK * HD;     // K or V, a stage
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  const uint32_t q_s = (smem_u32(dq_smem) + 1023) & ~1023u;
  const uint32_t g_s = q_s + kQBytes;
  const uint32_t k_s = g_s + kQBytes;              // + stage * kTileBytes
  const uint32_t v_s = k_s + kStages * kTileBytes;
  const uint32_t q_bar = v_s + kStages * kTileBytes;
  const uint32_t full = q_bar + 8;                 // + 8 * stage
  const uint32_t empty = full + 8 * kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;        // heaviest first
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int t_end = (min(q0 + BQ, S) - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        T::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * kQBytes);
      for (int j = 0; j < kSlabs; ++j) {
        tma_load(q_s + j * BQ * kSlab, &tm_q, q_bar, j * kSlabCols, h, q0, b);
        tma_load(g_s + j * BQ * kSlab, &tm_g, q_bar, j * kSlabCols, h, q0, b);
      }
      for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
        const int s = i % kStages;
        if (i >= kStages)
          mbar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
        for (int j = 0; j < kSlabs; ++j) {
          tma_load(k_s + s * kTileBytes + j * BK * kSlab, &tm_k, full + 8 * s,
                   j * kSlabCols, g, t * BK, b);
          tma_load(v_s + s * kTileBytes + j * BK * kSlab, &tm_v, full + 8 * s,
                   j * kSlabCols, g, t * BK, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::kConsumerRegs));
    const int wgc = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int quad = lane / 4, pair = lane % 4;
    const int r0 = q0 + 64 * wgc;                 // this warpgroup's rows
    const int r_last = min(r0 + 63, S - 1);       // < r0 if it has none
    const int row = r0 + 16 * warp + quad;        // this thread's: +0, +8
    const uint32_t q_wg = q_s + 64 * wgc * kSlab;
    const uint32_t g_wg = g_s + 64 * wgc * kSlab;
    // rows past S: lse and D 0, against zero rows of Q and dO
    float ls[2], dd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = row + 8 * half;
      const size_t at = (static_cast<size_t>(b) * H + h) * S + qi;
      ls[half] = qi < S ? lse[at] * kLog2e : 0.f;
      dd[half] = qi < S ? D[at] : 0.f;
    }

    float acc[HD / 2];
    zero_acc(acc);
    mbar_wait(q_bar, 0);
    for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
      const int s = i % kStages;
      const int k0 = t * BK;
      const bool live = r0 <= r_last && k0 <= r_last &&
                        (window <= 0 || k0 + BK - 1 > r0 - window);
      const bool masked = k0 + BK - 1 > r0 ||
                          (window > 0 && k0 <= r_last - window);
      const uint32_t k_t = k_s + s * kTileBytes, v_t = v_s + s * kTileBytes;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      if (live) {
        // S = Q K^T and dP = dO V^T: 64 queries x BK keys
        float sc[BK / 2], dp[BK / 2];
        zero_acc(sc);
        zero_acc(dp);
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        mma_ss<HD, BQ, BK>(sc, q_wg, k_t);
        mma_ss<HD, BQ, BK>(dp, g_wg, v_t);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        if (masked) mask_queries<BK>(sc, row, k0, pair, window);
        // dS = P o (dP - D), P = exp2(S * scale * log2(e) - lse * log2(e))
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 4 * j + 2 * half + e;
              const float p =
                  fast_exp2(fmaf(sc[c], scale_log2, -ls[half]));
              dp[c] = p * (dp[c] - dd[half]);
            }
        // dQ += dS K, K read MN-major
        uint32_t a[BK / 16][4];
        as_operand<BK>(a, dp);
        fence_regs(acc);
        wgmma_fence();
        mma_rs<BK, BK>(acc, a, k_t);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);    // the stage is free
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = row + 8 * half;
      if (qi <= r_last) {
        __nv_bfloat16* dst =
            dq + ((static_cast<size_t>(b) * S + qi) * H + h) * HD + 2 * pair;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_pair(acc[4 * j + 2 * half] * scale,
                        acc[4 * j + 2 * half + 1] * scale);
      }
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

// pass 1, dot_lanes threads a row
template <typename T>
int launch_dot(const Args& a, int hd) {
  const int rows = a.B * a.S * a.H;
  const int per_block = kThreads / dot_lanes<T>(hd);
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

// passes 2 and 3 on mma.sync (bf16 at hd 16 and 32)
template <int HD>
int launch_mma(const Args& a) {
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

  const dim3 grid_kv((a.S + kMmaRows - 1) / kMmaRows, a.B * a.KV);
  flash_bwd_dkdv_mma_kernel<HD><<<grid_kv, kMmaThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.D, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.H, a.KV, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((a.S + kMmaRows - 1) / kMmaRows, a.B * a.H);
  flash_bwd_dq_mma_kernel<HD><<<grid_q, kMmaThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.D, static_cast<bf16*>(a.dq), a.S, a.H, a.KV,
      a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// passes 2 and 3 on TMA and wgmma (bf16 at hd 64-256): two tensor maps of
// each input, one a pass, whose boxes are that pass's tiles
template <int HD>
int launch_hopper(const Args& a) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  using T2 = DkdvTile<HD>;
  using T3 = DqTile<HD>;
  CUtensorMap q2, g2, k2, v2, q3, g3, k3, v3;
  if (!encode_map(encode, &q2, a.q, a.B, a.S, a.H, HD, T2::BQ) ||
      !encode_map(encode, &g2, a.dout, a.B, a.S, a.H, HD, T2::BQ) ||
      !encode_map(encode, &k2, a.k, a.B, a.S, a.KV, HD, T2::BK) ||
      !encode_map(encode, &v2, a.v, a.B, a.S, a.KV, HD, T2::BK) ||
      !encode_map(encode, &q3, a.q, a.B, a.S, a.H, HD, T3::kRows) ||
      !encode_map(encode, &g3, a.dout, a.B, a.S, a.H, HD, T3::kRows) ||
      !encode_map(encode, &k3, a.k, a.B, a.S, a.KV, HD, T3::BK) ||
      !encode_map(encode, &v3, a.v, a.B, a.S, a.KV, HD, T3::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem2 = dkdv_smem_bytes<HD>(), smem3 = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_hopper_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_hopper_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  const float scale_log2 = a.scale * kLog2e;

  const dim3 grid_kv(a.B * a.KV, (a.S + T2::BK - 1) / T2::BK);
  flash_bwd_dkdv_hopper_kernel<HD><<<grid_kv, T2::kThreads, smem2,
                                     a.stream>>>(
      q2, k2, v2, g2, a.lse, a.D, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.H, a.KV, a.window, a.scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q(a.B * a.H, (a.S + T3::kRows - 1) / T3::kRows);
  flash_bwd_dq_hopper_kernel<HD><<<grid_q, T3::kThreads, smem3,
                                   a.stream>>>(
      q3, k3, v3, g3, a.lse, a.D, static_cast<bf16*>(a.dq), a.S, a.H, a.KV,
      a.window, a.scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// pass 1, then passes 2 and 3 on the route that flash_attention/kernel.py's
// bwd_route() names: bf16 at hd 64-256 TMA and wgmma, bf16 at hd 16 and 32
// mma.sync, float32 the CUDA cores
template <typename T>
int launch_hd(const Args& a, int hd) {
  int err = launch_dot<T>(a, hd);
  if (err) return err;
  if constexpr (sizeof(T) == 2) {
    switch (hd) {
      case 16: return launch_mma<16>(a);
      case 32: return launch_mma<32>(a);
      case 64: return launch_hopper<64>(a);
      case 128: return launch_hopper<128>(a);
      case 256: return launch_hopper<256>(a);
    }
  } else {
    switch (hd) {
      case 16: return launch<T, 16>(a);
      case 32: return launch<T, 32>(a);
      case 64: return launch<T, 64>(a);
      case 128: return launch<T, 128>(a);
      case 256: return launch<T, 256>(a);
    }
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
