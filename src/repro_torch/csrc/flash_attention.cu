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
// output is written in the input type.  Probabilities enter the P.V
// product rounded to the input type, as the TPU kernel's p.astype(v.dtype)
// does, while the row sum l adds them unrounded.
//
// Bound: operations.  A call does 4*B*H*hd*sum_i(live keys) flops.  At
// gemma3-1b's global layer (B 4, S 2,048, H 4, KV 1, hd 256) that is
// 3.4e10 flops on 42 MB of q, k, v and out: 35 us at the bf16 tensor-core
// peak against 13 us for the bytes; at its 512-key window 1.5e10 (15 us).
// At hymba-1.5b's (H 25, KV 5, hd 64) window 1,024 it is 4.0e10 (41 us),
// at window 0 5.4e10 (54 us).  Like the TPU kernel, every route keeps the
// [S, S] score matrix out of device memory, and never loads a KV tile
// that the causal mask or the window removes entirely (the TPU kernel's
// pl.when).
//
// Three routes; flash_attention_launch picks one by type and head size:
//
// bf16 at hd 64, 128, 256 (the models' calls): the Hopper kernel below.
//   One block per (b*h, query tile) of a producer warpgroup and two or
//   three consumer warpgroups of 64 query rows each; the heaviest query
//   tiles are issued first so the causal imbalance does not set the tail.
//   The producer warpgroup gives up its registers (setmaxnreg) and one of
//   its threads loads the query tile once, then every live K and V tile
//   into a ring of shared-memory stages, by TMA from tensor maps over the
//   [B, S, heads, hd] tensors (64-column slabs with 128-byte swizzle; rows
//   past S arrive as zeros).  Each stage has a full barrier for K, one for
//   V, and an empty barrier that every consumer warp arrives at when done
//   with it.  In each consumer, S = Q.K^T is wgmma with both operands in
//   shared memory; the online softmax runs on its float32 accumulators
//   (the max kept in unscaled scores, so a score costs one FMA with
//   scale*log2(e) and one ex2; a row's four threads meet in two shuffles);
//   O += P.V is wgmma with P from registers (the S accumulator rounded to
//   bf16 in place is exactly the A-operand layout) and V read transposed
//   from shared memory by the descriptor, never by hand.  Only the tiles
//   that cross the diagonal or the window's edge for some row of the
//   warpgroup run the per-element mask, in a branch of its own.  Tiles
//   (query rows x keys x stages, consumers): hd 256 128 x 64 x 2, two
//   (193 KB of shared memory); hd 128 128 x 128 x 2, two (161 KB); hd 64
//   192 x 128 x 3, three (121 KB: a third consumer hides more of the
//   latency of each warpgroup's chain of product, softmax, product).
//
// bf16 at hd 16 and 32 (the smoke configurations): tensor cores through
//   mma.sync m16n8k16, 4 warps of 16 query rows per 64-row block, K and V
//   staged by plain loads; too narrow for 64-column TMA slabs.
//
// float32 (the comparisons' exact twin): CUDA cores, exact float32
//   products.
//
// lse (optional, null on the serving path): each row's log-normaliser
// log sum_j exp(scale * s_ij) over its live keys, float32 [B, H, S], which
// the backward kernel (flash_attention_bwd.cu) recomputes P from.  Each
// route writes it from its final running max m and sum l, one thread a
// row, after the output.
//
// NEG_INF is -1e30, not -inf, as in the TPU kernel: a row with no live
// key in its first tile then holds m = -1e30 and, on the mma.sync and
// float32 routes, p = 1 for a while (p = 0 on the Hopper route), and the
// first live key's correction factor exp(-1e30 - m) = 0 wipes that out.
// The diagonal is always live, so every row ends with a real max.

#include "attention_sm90.cuh"   // TMA maps and loads, descriptors, bf16 wgmma

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool live_key(int kj, int qi, int window) {
  return kj <= qi && (window <= 0 || kj > qi - window);
}

// ---------------------------------------------------------------------------
// bf16 at hd 64-256: TMA ring, a producer thread, wgmma
// ---------------------------------------------------------------------------

// keys a tile, stages in the ring, consumer warpgroups of 64 query rows,
// and the registers a consumer thread takes: 65,536 a block, of which the
// producer warpgroup keeps 24 a thread
template <int K, int Stages, int Consumers, int Regs>
struct HopperTiling {
  static constexpr int BK = K, kStages = Stages, kConsumers = Consumers;
  static constexpr int kRegs = Regs;
  static constexpr int kBQ = 64 * Consumers;               // query rows
  static constexpr int kThreads = 128 * (1 + Consumers);
};
template <int HD> struct HopperTile;
template <> struct HopperTile<64> : HopperTiling<128, 3, 3, 160> {};
template <> struct HopperTile<128> : HopperTiling<128, 2, 2, 240> {};
template <> struct HopperTile<256> : HopperTiling<64, 2, 2, 240> {};

template <int HD>
constexpr size_t hopper_smem_bytes() {
  using T = HopperTile<HD>;
  // 1 KB to align the base to the swizzle atom, Q, the K and V stages,
  // then the barriers: Q, full K and V per stage, empty per stage
  return 1024 + 2 * (T::kBQ * HD + 2 * T::kStages * T::BK * HD)
         + 8 * (1 + 3 * T::kStages);
}

template <int HD>
__global__ void __launch_bounds__(HopperTile<HD>::kThreads, 1)
flash_attention_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int S, int H,
                              int KV, int window, float scale_log2) {
  constexpr int BK = HopperTile<HD>::BK;
  constexpr int kStages = HopperTile<HD>::kStages;
  constexpr int kBQ = HopperTile<HD>::kBQ;
  constexpr int kSlabs = HD / kSlabCols;
  constexpr uint32_t kRowBytes = 2 * kSlabCols;           // 128
  constexpr uint32_t kQBytes = 2 * kBQ * HD;
  constexpr uint32_t kTileBytes = 2 * BK * HD;             // one K or V tile
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t q_s = (smem_u32(hopper_smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;                      // + stage * tile
  const uint32_t v_s = k_s + kStages * kTileBytes;
  const uint32_t q_bar = v_s + kStages * kTileBytes;
  const uint32_t full_k = q_bar + 8;                       // + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;        // heaviest first
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int t_end = (min(q0 + kBQ, S) - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      // one arrival from each consumer warp frees the stage
      mbar_init(empty + 8 * s, 4 * HopperTile<HD>::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, kQBytes);
      for (int j = 0; j < kSlabs; ++j)
        tma_load(q_s + j * kBQ * kRowBytes, &tm_q, q_bar, j * kSlabCols, h,
                 q0, b);
      for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
        const int s = i % kStages;
        if (i >= kStages)   // the consumers released this stage's last use
          mbar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
        mbar_expect_tx(full_k + 8 * s, kTileBytes);
        for (int j = 0; j < kSlabs; ++j)
          tma_load(k_s + s * kTileBytes + j * BK * kRowBytes, &tm_k,
                   full_k + 8 * s, j * kSlabCols, g, t * BK, b);
        mbar_expect_tx(full_v + 8 * s, kTileBytes);
        for (int j = 0; j < kSlabs; ++j)
          tma_load(v_s + s * kTileBytes + j * BK * kRowBytes, &tm_v,
                   full_v + 8 * s, j * kSlabCols, g, t * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        HopperTile<HD>::kRegs));
    const int wgc = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int quad = lane / 4, pair = lane % 4;
    const int r0 = q0 + 64 * wgc;                 // this warpgroup's rows
    const int r_last = min(r0 + 63, S - 1);       // < r0 if it has none
    const int row = r0 + 16 * warp + quad;        // this thread's: +0, +8
    const uint32_t q_wg = q_s + 64 * wgc * kRowBytes;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);

    for (int t = t_begin, i = 0; t <= t_end; ++t, ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = t * BK;
      // uniform over the warpgroup: does any of its rows see a key here,
      // and does any key need the per-element mask
      const bool live = r0 <= r_last && k0 <= r_last &&
                        (window <= 0 || k0 + BK - 1 > r0 - window);
      const bool masked = k0 + BK - 1 > r0 ||
                          (window > 0 && k0 <= r_last - window);
      mbar_wait(full_k + 8 * s, parity);
      if (live) {
        // S = Q K^T over hd in 16-column steps, 4 steps a 64-column slab
        float sc[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          wgmma_ss(sc,
                   smem_desc(q_wg + (kk / 4) * kBQ * kRowBytes + col,
                             16, 1024),
                   smem_desc(k_s + s * kTileBytes + (kk / 4) * BK * kRowBytes
                             + col, 16, 1024),
                   kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // online softmax: m is kept in unscaled scores (the scale is
        // positive), so p = exp2(s * scale_log2 - m * scale_log2) is one
        // fused multiply-add and one exp2 a score
        if (masked) {
          // key k0 + c (c = 8j + 2 pair + e) is live for row qi when
          // c <= qi - k0 and, with a window, c > qi - k0 - window
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int hi = row + 8 * half - k0 - 2 * pair;
            const int lo = window > 0 ? hi - window : -(1 << 30);
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (8 * j + e > hi || 8 * j + e <= lo)
                  sc[4 * j + 2 * half + e] = kNegInf;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              mx = fmaxf(mx, sc[4 * j + 2 * half + e]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[half], mx);
          // a row with no live key yet keeps m = NEG_INF and p = 0: fma's
          // unrounded product would leave -1e30 * scale - m_scaled a large
          // residue of either sign, and exp2 of it 0 or inf
          const float m_scaled = m_new == kNegInf ? 0.f : m_new * scale_log2;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[4 * j + 2 * half + e];
              x = fast_exp2(fmaf(x, scale_log2, -m_scaled));
              sum += x;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const float corr = fast_exp2((m[half] - m_new) * scale_log2);
          l[half] = l[half] * corr + sum;
          m[half] = m_new;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            o[4 * j + 2 * half] *= corr;
            o[4 * j + 2 * half + 1] *= corr;
          }
        }

        // P as the A operand: the accumulators of two adjacent 8-key
        // column blocks are one 16-key step's fragment, rounded to bf16
        uint32_t p[BK / 16][4];
#pragma unroll
        for (int c = 0; c < BK / 16; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[c][r] = pack_pair(sc[8 * c + 2 * r], sc[8 * c + 2 * r + 1]);

        // O += P V, V's 16-key steps 16 rows (2,048 bytes) apart
        mbar_wait(full_v + 8 * s, parity);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < BK / 16; ++c)
          wgmma_rs(o, p[c],
                   smem_desc(v_s + s * kTileBytes + c * 16 * kRowBytes,
                             BK * kRowBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      } else {
        // no row here sees this tile: wait for it to land all the same,
        // so that this warp's arrival counts for this use of the stage
        mbar_wait(full_v + 8 * s, parity);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);    // the stage is free
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = row + 8 * half;
      if (qi <= r_last) {
        const float inv = 1.f / fmaxf(l[half], 1e-30f);
        __nv_bfloat16* dst =
            out + ((static_cast<size_t>(b) * S + qi) * H + h) * HD + 2 * pair;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_pair(o[4 * j + 2 * half] * inv,
                        o[4 * j + 2 * half + 1] * inv);
        // m is in unscaled scores and l sums exp2((s - m) * scale_log2),
        // so ln(sum exp(scale * s)) = (m * scale_log2 + log2(l)) * ln 2
        if (lse != nullptr && pair == 0)
          lse[(static_cast<size_t>(b) * H + h) * S + qi] =
              (m[half] * scale_log2 + log2f(l[half])) * 0.6931471805599453f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 16 and 32: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
//
// Shared by this route and the float32 one: one block per (64-query tile,
// b*h).  The query tile is staged once in shared memory; the block then
// walks, in order, only the KV tiles that hold a live key for some query
// of its tile, staging each K and V tile in shared memory with plain
// loads.  A row's running max m and sum l, and the rescale of its
// accumulators, stay in the registers of the threads that own the row.
//
// Here: 4 warps of 16 query rows each.  A warp's S tile stays in its mma
// accumulators: the 4 lanes of a quad hold one row's scores, so a row's
// max and sum meet in two xor-shuffles, and the accumulator layout of two
// adjacent 8-key tiles is exactly the operand layout of one 16-key step of
// P.V, so P never leaves registers.  V is staged transposed so both
// products read their B operand as 32-bit pairs.  Shared-memory rows are
// padded by 8 elements (16 bytes) so the 8 rows a fragment load touches
// fall in different banks.

constexpr int kBQ = 64;              // query rows per block
constexpr int kMmaThreads = 128;     // 4 warps x 16 query rows

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
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int S, int H, int KV,
                           int window, float scale) {
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
      if (lse != nullptr && pair == 0)           // m is in scaled scores
        lse[static_cast<size_t>(blockIdx.y) * S + qi] = m[half] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: exact products on the CUDA cores
// ---------------------------------------------------------------------------
//
// A 16 x 16 thread grid owns 4 query rows per thread, scores against the
// key columns tx, tx+16, ... (a row's max and sum meet in four
// xor-shuffles within a half-warp) and the same rows' output columns tx,
// tx+16, ...; probabilities pass through shared memory; Q and K rows have
// an odd pitch (hd + 1 floats) so the two half-warps' rows fall in
// different banks.  Shared memory at hd 256: 140 KB, past the 48 KB
// default: the launcher raises the block's dynamic limit each time.

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
                           float* __restrict__ out,
                           float* __restrict__ lse, int S, int H, int KV,
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
      if (lse != nullptr && tx == 0)             // m is in scaled scores
        lse[static_cast<size_t>(blockIdx.y) * S + qi] = m[r] + logf(denom);
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
  float* lse;
  int B, S, H, KV, window;
  float scale;
  cudaStream_t stream;
};


template <int HD>
int launch_hopper(const Args& a) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  const int BK = HopperTile<HD>::BK;
  constexpr int kBQ = HopperTile<HD>::kBQ;
  if (!encode_map(encode, &tm_q, a.q, a.B, a.S, a.H, HD, kBQ) ||
      !encode_map(encode, &tm_k, a.k, a.B, a.S, a.KV, HD, BK) ||
      !encode_map(encode, &tm_v, a.v, a.B, a.S, a.KV, HD, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = hopper_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_hopper_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S + kBQ - 1) / kBQ);
  constexpr int threads = HopperTile<HD>::kThreads;
  flash_attention_hopper_kernel<HD><<<grid, threads, smem, a.stream>>>(
          tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(a.out), a.lse, a.S,
          a.H, a.KV, a.window, a.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK>
int launch_mma(const Args& a) {
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
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.S, a.H, a.KV, a.window,
      a.scale);
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
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.S,
      a.H, a.KV, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [B, S, H, hd]; k, v: [B, S, KV, hd]; all contiguous, one dtype
// (is_bf16 ? bf16, 16-byte aligned : float32); H % KV == 0; hd in
// {16, 32, 64, 128, 256}; lse: null, or float32 [B, H, S] to receive each
// row's log-normaliser.  The route (kernel/flash_attention/kernel.py's
// route()): bf16 at hd 64-256 the Hopper kernel, bf16 at hd 16-32 the
// mma.sync kernel, float32 the CUDA-core kernel.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int H, int KV, int hd,
                                      int window, float scale, int is_bf16,
                                      void* stream) {
  const Args a{q, k, v, out, static_cast<float*>(lse), B, S, H, KV, window,
               scale, static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    switch (hd) {
      case 16: return launch_mma<16, 64>(a);
      case 32: return launch_mma<32, 64>(a);
      case 64: return launch_hopper<64>(a);
      case 128: return launch_hopper<128>(a);
      case 256: return launch_hopper<256>(a);
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
