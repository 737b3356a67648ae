// int8 flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/flash_attn.py::flash_attention_int8
//   (body _flash_kernel_int8)
// q, k and v arrive as int8 with per-tensor scales folded into
// scale_qk = sq * sk / sqrt(d) and scale_pv = sv / 127 (the wrapper
// quantizes, as the JAX wrapper does).  Per block of 256 keys:
//   s     = float(int32 q . k) * scale_qk        (keys past the end: -1e30)
//   m_new = max(m, max over the block of s)
//   p     = exp(s - m_new);  l = l * exp(m - m_new) + sum p
//   p8    = round(p * 127)                       (halves to even)
//   acc   = acc * exp(m - m_new) + float(int32 p8 . v) * scale_pv
// and out = acc / max(l, 1e-30).  The block of 256 keys is part of the
// contract: p8 is rounded against the running maximum after the whole block,
// so another block size gives other roundings.
//
// Bound on this card: at the decoder's shape (B 8, len 900, d 32) q, k, v
// are 0.69 MB of int8 and the float32 output 0.92 MB, 0.5 us of memory
// traffic; the 4 * B * Lq * Lk * d = 0.83 GOP take 0.4 us at the int8
// tensor-core rate.  Either way it is launch-sized; this first version runs
// both products on the CUDA cores with __dp4a.
//
// Design: one block per (B, 64-query tile), four adjacent lanes per query
// row.  A lane owns every fourth group of four keys.  Pass 1 over the block
// computes its logits for the block maximum, which the four lanes merge by
// shuffles; pass 2 recomputes them (cheaper than keeping 64 logits a lane),
// forms p and p8, packs four p8 into one word and multiplies it with the
// transposed v tile, four keys per __dp4a.  The int32 sums of the block are
// merged over the four lanes before they become float, as the TPU kernel
// converts the whole block's sum.  K rows sit in shared memory padded to 9
// words and v transposed as [d][key / 4] words, both conflict-free for the
// four lanes.  The kernel allocates nothing and launches on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kSplit = 4;                   // lanes per row
constexpr int kThreads = kBlockQ * kSplit;
constexpr int kBlockK = 256;                // keys per requantization block (the contract)
constexpr int kQuads = kBlockK / 4;         // groups of four keys per block
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ v, const float* __restrict__ scales,
                  T* __restrict__ out, int Lq, int Lk) {
  constexpr int W = D / 4;                  // words per row
  __shared__ int ks[kBlockK][W + 1];        // key rows, padded by one word
  __shared__ int vt[D][kQuads + 1];         // v transposed: vt[c][g] = v[4g .. 4g+3][c]
  const int t = threadIdx.x;
  const int row = t / kSplit, part = t % kSplit;
  const long long b = blockIdx.y;
  const int qi = blockIdx.x * kBlockQ + row;
  const bool active = qi < Lq;
  const float scale_qk = scales[0], scale_pv = scales[1];

  int qw[W];
  const int* qp = reinterpret_cast<const int*>(q + (b * Lq + (active ? qi : 0)) * D);
#pragma unroll
  for (int i = 0; i < W; ++i) qw[i] = active ? qp[i] : 0;

  float acc[W];  // this lane's channels: 4 * i + part
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  const int8_t* kb = k + b * Lk * D;
  const int8_t* vb = v + b * Lk * D;

  for (int k0 = 0; k0 < Lk; k0 += kBlockK) {
    const int nk = min(kBlockK, Lk - k0);
    __syncthreads();
    for (int e = t; e < kBlockK * W; e += kThreads) {
      const int j = e / W, i = e % W;
      ks[j][i] = j < nk ? reinterpret_cast<const int*>(kb + (long long)(k0 + j) * D)[i] : 0;
    }
    for (int e = t; e < kQuads * D; e += kThreads) {
      const int g = e / D, c = e % D;
      unsigned word = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * g + u;
        const unsigned byte = j < nk ? (uint8_t)vb[(long long)(k0 + j) * D + c] : 0u;
        word |= byte << (8 * u);
      }
      vt[c][g] = (int)word;
    }
    __syncthreads();

    // pass 1: the block's maximum logit
    float mt = kNegInf;
    for (int g = part; g < kQuads; g += kSplit) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * g + u;
        int dot = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) dot = __dp4a(qw[i], ks[j][i], dot);
        mt = fmaxf(mt, j < nk ? (float)dot * scale_qk : kNegInf);
      }
    }
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);

    // pass 2: p, p8 and the int8 p8 . v product
    int pv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) pv[c] = 0;
    float psum = 0.f;
    for (int g = part; g < kQuads; g += kSplit) {
      unsigned pw = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * g + u;
        int dot = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) dot = __dp4a(qw[i], ks[j][i], dot);
        const float s = j < nk ? (float)dot * scale_qk : kNegInf;
        const float p = expf(s - m_new);
        psum += p;
        pw |= (unsigned)__float2int_rn(p * 127.f) << (8 * u);  // 0 .. 127
      }
#pragma unroll
      for (int c = 0; c < D; ++c) pv[c] = __dp4a(vt[c][g], (int)pw, pv[c]);
    }
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) psum += __shfl_xor_sync(kFull, psum, o);
#pragma unroll
    for (int c = 0; c < D; ++c) {
#pragma unroll
      for (int o = 1; o < kSplit; o <<= 1) pv[c] += __shfl_xor_sync(kFull, pv[c], o);
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int mine = part == 0 ? pv[4 * i] : part == 1 ? pv[4 * i + 1]
                     : part == 2 ? pv[4 * i + 2] : pv[4 * i + 3];
      acc[i] = acc[i] * alpha + (float)mine * scale_pv;
    }
  }

  if (active) {
    T* op = out + (b * Lq + qi) * D;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < W; ++i) op[4 * i + part] = from_f<T>(acc[i] / den);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* scales, void* out,
                   int B, int Lq, int Lk, int D, cudaStream_t stream) {
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B);
#define FLASH_INT8_LAUNCH(N)                                                              \
  flash_int8_kernel<T, N><<<grid, kThreads, 0, stream>>>(                                 \
      (const int8_t*)q, (const int8_t*)k, (const int8_t*)v, (const float*)scales, (T*)out, \
      Lq, Lk)
  switch (D) {
    case 32: FLASH_INT8_LAUNCH(32); break;
    case 64: FLASH_INT8_LAUNCH(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_INT8_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Lq, D], k/v [B, Lk, D] int8; scales [2] f32 = (sq*sk/sqrt(D), sv/127);
// out [B, Lq, D]; out_dtype 0 = float32, 1 = bfloat16.
int flash_attn_int8_forward(const void* q, const void* k, const void* v, const void* scales,
                            void* out, int B, int Lq, int Lk, int D, int out_dtype,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == 0) return (int)launch<float>(q, k, v, scales, out, B, Lq, Lk, D, st);
  if (out_dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, scales, out, B, Lq, Lk, D, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
