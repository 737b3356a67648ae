// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/flash_attn.py::flash_attention
// and computes ops/attention.py::qkv: softmax(q k^T / sqrt(d)) v over
// [B, len, d] (heads folded into B), with an online softmax and float32
// running max, denominator and accumulator.  The kv tail is masked, so any
// length works.
//
// Bound on this card: at the decoder's shapes (B 8, len 900, d 32) the
// inputs and output are 3.7 MB (f32), about 1.1 us of memory traffic, and
// the 4*B*Lq*Lk*d = 0.83 GFLOP take 12 us at the 67 TFLOP/s float32 rate;
// so operations bound it in float32, bytes and operations are within a
// small factor of each other in bf16.  This first version does the
// arithmetic on the CUDA cores in f32; mma.sync/wgmma on the tensor cores is
// the next step.
//
// Design: one block per (B, 64-query tile), four threads per query row
// (256 threads).  The four threads of a row are adjacent lanes; each keeps
// q (pre-scaled), an accumulator and a running max/denominator in registers
// for every fourth key, and they merge their partial softmaxes with warp
// shuffles at the end.  Each 64-row K/V tile is staged in shared memory as
// f32, rows padded by one word so the four key rows read at once fall in
// different banks (rows past the end are zero and their logits -inf).  The
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockQ = 64;                  // query rows per block
constexpr int kSplit = 4;                    // threads per row, one key in four each
constexpr int kThreads = kBlockQ * kSplit;
constexpr int kBlockK = 64;                  // keys staged per tile
constexpr int kPerThread = kBlockK / kSplit;  // keys per thread per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Lq, int Lk, float scale) {
  __shared__ float ks[kBlockK][D + 1];
  __shared__ float vs[kBlockK][D + 1];
  const int t = threadIdx.x;
  const int row = t / kSplit, part = t % kSplit;
  const long long b = blockIdx.y;
  const int qi = blockIdx.x * kBlockQ + row;
  const bool active = qi < Lq;

  float qr[D], acc[D];
  const T* qp = q + (b * Lq + (active ? qi : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const T* kb = k + b * Lk * D;
  const T* vb = v + b * Lk * D;

  for (int k0 = 0; k0 < Lk; k0 += kBlockK) {
    const int nk = min(kBlockK, Lk - k0);
    __syncthreads();
    for (int e = t; e < kBlockK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = j < nk;
      ks[j][d] = in ? to_f(kb[(long long)(k0 + j) * D + d]) : 0.f;
      vs[j][d] = in ? to_f(vb[(long long)(k0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[kPerThread];
    float mt = m;
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) {
      const int j = jj * kSplit + part;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[jj] = j < nk ? dot : -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    // a thread whose keys are all masked so far keeps m = -inf, l = acc = 0
    const float mref = mt == -INFINITY ? 0.f : mt;
    const float alpha = expf(m - mref);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) {
      const int j = jj * kSplit + part;
      const float p = expf(s[jj] - mref);
      psum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    l = l * alpha + psum;
    m = mt;
  }

  // merge the row's kSplit partial softmaxes (adjacent lanes)
  float mrow = m;
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) mrow = fmaxf(mrow, __shfl_xor_sync(kFull, mrow, o));
  const float c = m == -INFINITY ? 0.f : expf(m - mrow);
  float lrow = l * c;
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) lrow += __shfl_xor_sync(kFull, lrow, o);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d] * c;
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
    acc[d] = a;
  }
  if (active) {
    T* op = out + (b * Lq + qi) * D;
    const float inv = 1.f / lrow;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d % kSplit == part) op[d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                   int Lk, int D, cudaStream_t stream) {
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B);
  const float scale = 1.f / sqrtf((float)D);
#define FLASH_LAUNCH(N)                                                                  \
  flash_kernel<T, N><<<grid, kThreads, 0, stream>>>((const T*)q, (const T*)k, (const T*)v, \
                                                   (T*)out, Lq, Lk, scale)
  switch (D) {
    case 8: FLASH_LAUNCH(8); break;
    case 32: FLASH_LAUNCH(32); break;
    case 64: FLASH_LAUNCH(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Lq, D], k/v [B, Lk, D], out [B, Lq, D]; dtype 0 = float32, 1 = bfloat16.
int flash_attn_forward(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                       int Lk, int D, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(q, k, v, out, B, Lq, Lk, D, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, out, B, Lq, Lk, D, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
