// int8 matrix product with a fused dequantization, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/int8_matmul.py::int8_matmul
// and computes out[m, n] = float(sum_k x[m, k] * w[n, k]) * (x_scale * w_scale[n])
// with exact int32 accumulation.  It is the product behind every int8
// QDense and QConv of the port (a convolution arrives as an im2col matrix).
// Both operands keep K last (x [M, K], w [N, K]), the "row.col" operand
// order of the tensor cores.
//
// Bound on this card: the model's shapes span both sides.  A dense layer of
// the decoder (M 900, K 256, N 256) moves 0.5 MB (0.15 us) for 0.12 GOP
// (0.06 us at the 1979 TOP/s int8 rate): a launch, not a roofline.  A 3x3
// convolution of the R101 backbone (M 139200, K 2304, N 256) is 164 GOP
// (83 us) against 463 MB (138 us, most of it the float32 output): bytes
// bound it, so a later version should emit int8 or bf16 and fuse the
// activation quantization.
//
// Design (simple first): mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor
// cores.  A block of 256 threads owns a 128 x 64 output tile; its eight
// warps sit 4 x 2, each on a 32 x 32 sub-tile (2 x 4 mma tiles, 32 int32
// accumulators a thread).  K advances 64 bytes a step: each thread fetches
// 16-byte pieces of the x and w tiles into registers while the tensor cores
// work on the previous step's tiles in shared memory (rows padded to 80
// bytes so the eight rows a fragment load touches fall in different banks).
// Rows and columns past M and N load zeros and are not stored, so any M and
// N work; K must be a multiple of 16 (the wrapper pads).  wgmma, TMA and a
// deeper pipeline are for a later version.  The kernel allocates nothing
// and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 64;   // block tile; kBK in bytes of K
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;                 // padded shared-memory row, bytes

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of row `r` (of `rows`) at byte `k` (of K) of a [rows, K] int8 matrix, or zeros.
__device__ __forceinline__ int4 fetch(const int8_t* __restrict__ p, int r, int rows, int k, int K) {
  if (r < rows && k < K) return *reinterpret_cast<const int4*>(p + (long long)r * K + k);
  return make_int4(0, 0, 0, 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                 T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t xs[kBM * kRow];
  __shared__ __align__(16) int8_t ws[kBN * kRow];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's sub-tile
  const int g = lane >> 2, tg = lane & 3;                 // fragment row group, thread in group

  // each thread moves two 16-byte pieces of the x tile and one of the w tile
  const int xr0 = t >> 2, xr1 = xr0 + 64, wr = t >> 2, kc = (t & 3) * 16;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  int4 px0 = fetch(x, m0 + xr0, M, kc, K);
  int4 px1 = fetch(x, m0 + xr1, M, kc, K);
  int4 pw = fetch(w, n0 + wr, N, kc, K);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    *reinterpret_cast<int4*>(xs + xr0 * kRow + kc) = px0;
    *reinterpret_cast<int4*>(xs + xr1 * kRow + kc) = px1;
    *reinterpret_cast<int4*>(ws + wr * kRow + kc) = pw;
    __syncthreads();
    const int kn = k0 + kBK + kc;  // the next step's pieces travel during this step's math
    px0 = fetch(x, m0 + xr0, M, kn, K);
    px1 = fetch(x, m0 + xr1, M, kn, K);
    pw = fetch(w, n0 + wr, N, kn, K);

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      int a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = xs + (wm + 16 * i + g) * kRow + ks + 4 * tg;
        a[i][0] = *reinterpret_cast<const int*>(p);
        a[i][1] = *reinterpret_cast<const int*>(p + 8 * kRow);
        a[i][2] = *reinterpret_cast<const int*>(p + 16);
        a[i][3] = *reinterpret_cast<const int*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = ws + (wn + 8 * j + g) * kRow + ks + 4 * tg;
        b[j][0] = *reinterpret_cast<const int*>(p);
        b[j][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // accumulator e of tile (i, j): row g (+8 for e >= 2), column 2*tg + (e & 1)
  const float xsc = *x_scale;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn + 8 * j + 2 * tg + c;
      if (n >= N) continue;
      const float s = xsc * w_scale[n];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * i + g + 8 * h;
          if (m < M) out[(long long)m * N + n] = from_f<T>((float)acc[i][j][2 * h + c] * s);
        }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* x_scale, const void* w_scale,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  if (K % 16 != 0) return cudaErrorInvalidValue;
  const int cols = (N + kBN - 1) / kBN;
  if (cols > 65535) return cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, cols);
  int8_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)x_scale, (const float*)w_scale,
      (T*)out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] int8, w [N, K] int8, x_scale [1] f32, w_scale [N] f32, out [M, N];
// K a multiple of 16; out_dtype 0 = float32, 1 = bfloat16.
int int8_gemm_forward(const void* x, const void* w, const void* x_scale, const void* w_scale,
                      void* out, int M, int N, int K, int out_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == 0) return (int)launch<float>(x, w, x_scale, w_scale, out, M, N, K, st);
  if (out_dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, x_scale, w_scale, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
