// Packed-bit rule matching on CUDA cores, the design that the binary
// tensor-core kernel (src/repro_torch/csrc/rule_match_packed.cu) was timed
// against by tools/rule_match_packed_designs.py:
//
//   out[b, r] = [ sum_w popc(Qw[b, w] & Aw[r, w]) == sizes[r] ] * conf[r]
//
// It fills the SMs where the parent kernel (64 threads a CTA, a rule a
// thread walking all W words against 8 queries at a time) left each SM two
// warps: a CTA of 4 warps holds 32 rules, 4 threads a rule, each thread 8
// of a rule's 32-word chunk in registers; the CTA stages its block of QB
// queries (8 to 64, chosen so the grid covers the SMs twice where it can)
// once a chunk in shared memory, where a warp's 8 rules x 4 quarters read
// 4 distinct 32-byte pieces of a query row (no bank conflicts).  A rule's
// 4 partial counts meet in two shuffles; thread p of a rule then writes
// the queries b with b % 4 == p, so a warp's stores cover 8 consecutive
// rules of a row.
//
// Same C entry point and contract as the parent kernel: W % 4 == 0, Qw and
// Aw 16-byte aligned; the grid is the launcher's own.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRules = 32;               // rules a CTA
constexpr int kThreads = 4 * kRules;     // 4 threads a rule
constexpr int kChunk = 32;               // words a stage

template <int QB>
__global__ void __launch_bounds__(kThreads)
rule_match_cuda_cores(const uint32_t* __restrict__ Qw,
                      const uint32_t* __restrict__ Aw,
                      const int32_t* __restrict__ sizes,
                      const float* __restrict__ conf,
                      float* __restrict__ out, int B, int R, int W) {
  __shared__ __align__(16) uint32_t sQ[QB][kChunk];
  const int part = threadIdx.x % 4;
  const int r = blockIdx.x * kRules + threadIdx.x / 4;
  const int q0 = blockIdx.y * QB;
  const bool live = r < R;
  const uint32_t* arow = Aw + static_cast<size_t>(live ? r : 0) * W;

  int dot[QB];
#pragma unroll
  for (int b = 0; b < QB; ++b) dot[b] = 0;
  for (int w0 = 0; w0 < W; w0 += kChunk) {
    // this thread's 8 words of the chunk (zeros past W)
    uint4 a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = w0 + 8 * part + 4 * h;
      a[h] = live && w < W ? __ldg(reinterpret_cast<const uint4*>(arow + w))
                           : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();             // the previous chunk has been read
    for (int i = threadIdx.x; i < QB * kChunk / 4; i += kThreads) {
      const int b = i / (kChunk / 4), w = w0 + 4 * (i % (kChunk / 4));
      uint4 x = make_uint4(0, 0, 0, 0);
      if (q0 + b < B && w < W)
        x = __ldg(reinterpret_cast<const uint4*>(
            Qw + static_cast<size_t>(q0 + b) * W + w));
      reinterpret_cast<uint4*>(sQ[b])[i % (kChunk / 4)] = x;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      const uint4* qrow = reinterpret_cast<const uint4*>(sQ[b]) + 2 * part;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 t = qrow[h];
        dot[b] += __popc(t.x & a[h].x) + __popc(t.y & a[h].y) +
                  __popc(t.z & a[h].z) + __popc(t.w & a[h].w);
      }
    }
  }
  const int size = live ? sizes[r] : -1;
  const float c = live ? conf[r] : 0.0f;
#pragma unroll
  for (int b = 0; b < QB; ++b) {
    int d = dot[b];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (live && b % 4 == part && q0 + b < B)
      out[static_cast<size_t>(q0 + b) * R + r] =
          static_cast<float>(d == size) * c;
  }
}

template <int QB>
void launch(const void* Qw, const void* Aw, const void* sizes,
            const void* conf, void* out, int B, int R, int W,
            cudaStream_t stream) {
  const dim3 grid((R + kRules - 1) / kRules, (B + QB - 1) / QB);
  rule_match_cuda_cores<QB><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(Qw), static_cast<const uint32_t*>(Aw),
      static_cast<const int32_t*>(sizes), static_cast<const float*>(conf),
      static_cast<float*>(out), B, R, W);
}

}  // namespace

extern "C" int rule_match_packed_launch(const void* Qw, const void* Aw,
                                        const void* sizes, const void* conf,
                                        void* out, int B, int R, int W,
                                        void* stream) {
  int sms = 132, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the largest query block whose grid still covers the SMs twice
  const int rule_blocks = (R + kRules - 1) / kRules;
  int qb = 64;
  while (qb > 8 && rule_blocks * ((B + qb - 1) / qb) < 2 * sms) qb /= 2;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 8: launch<8>(Qw, Aw, sizes, conf, out, B, R, W, s); break;
    case 16: launch<16>(Qw, Aw, sizes, conf, out, B, R, W, s); break;
    case 32: launch<32>(Qw, Aw, sizes, conf, out, B, R, W, s); break;
    default: launch<64>(Qw, Aw, sizes, conf, out, B, R, W, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
