// int8 matrix product with a fused dequantization, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/int8_matmul.py::int8_matmul
// and computes out[m, n] = float(sum_k x[m, k] * w[n, k]) * (x_scale * w_scale[n])
// with exact int32 accumulation.  It is the product behind every int8
// QDense and QConv of the port (a convolution arrives as an im2col matrix).
// Both operands keep K last (x [M, K], w [N, K]): K-major, which is what
// wgmma requires of 8-bit operands.
//
// Bound on this card: the model's shapes span both sides.  A dense layer of
// the decoder (M 900, K 256, N 256) moves 0.5 MB (0.15 us) for 0.12 GOP: a
// launch, not a roofline.  A 1x1 of the R101 backbone (M 34800, K 256,
// N 1024) moves 152 MB, most of it the float32 output (45 us), for 18 GOP
// (9 us at the 1979 TOP/s int8 rate): bytes.  A K 4608 3x3 is operations.
//
// Design: the Hopper GEMM shape.
//  * TMA loads the x and w tiles, 128 bytes of K a stage with the 128-byte
//    swizzle, into a ring of STAGES stages in dynamic shared memory; each
//    stage has a "full" mbarrier (expect-tx) and an "empty" one.  Ragged M,
//    N and K edges are the TMA's zero fill.  The tensor maps are encoded
//    here per call through cudaGetDriverEntryPoint (no -lcuda) and passed
//    as __grid_constant__ parameters.
//  * One producer warp issues the loads; NC consumer warpgroups (64 rows of
//    the tile each) issue wgmma.mma_async m64nBNk32 s32.s8.s8 from shared
//    memory, four per stage, keeping one stage's products in flight while
//    they release the stage before it.
//  * Persistent blocks (as many as fit on the SMs) walk the output tiles,
//    so one tile's epilogue overlaps the producer's loads for the next.
//  * Epilogue: each consumer scales its accumulators in registers
//    ((float)acc * (x_scale * w_scale[n]), the plain version's order, so
//    float32 output is bit for bit), stages them in shared memory, and
//    stores rows with 16-byte coalesced stores (scalar stores only where a
//    row of the output is not a multiple of 16 bytes: N 3 of the reference
//    points).
// Tile configurations (chosen by ops/int8_matmul.py::gemm_config from the
// shape, never after a failure): 128x128 (two consumers, 4 stages) for
// large products, 128x64 (two consumers, 6 stages) for N <= 64 (stem and
// stage 1), 64x64 (one consumer, 4 stages, two blocks an SM) for
// launch-sized products (few outputs, K under 1024).  K must be a multiple
// of 16 (the wrapper pads) and both operands 16-byte aligned.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;  // bytes of K per stage: one 128-byte swizzle row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// that TMA wrote: rows of 128 bytes, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // leading byte offset (unused with this swizzle)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset: one 8-row atom
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define ACC8(i)                                                                        \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]),             \
      "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// d += A[64 x 32] * B[BN x 32]^T, both from shared memory; scale_d 0 overwrites d.
template <int BN> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
#undef ACC8

// 16 bytes of output from staged float32 values.
template <typename T> __device__ __forceinline__ void store16(T* dst, const float* src);
template <> __device__ __forceinline__ void store16<float>(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  alignas(16) __nv_bfloat162 h[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int NC, int BN, int STAGES> struct Cfg {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * NC + 32;      // consumers, then the producer warp
  static constexpr int STAGE = (BM + BN) * kBK;       // bytes of one ring stage
  static constexpr int EPI_LD = BN + 8;               // staged row, floats (no bank conflicts)
  static constexpr size_t SMEM = 1024 /* alignment slack */ + (size_t)STAGES * STAGE +
                                 (size_t)NC * 64 * EPI_LD * 4 + 2 * STAGES * 8;
};

template <typename T, int NC, int BN, int STAGES>
__global__ void __launch_bounds__(Cfg<NC, BN, STAGES>::THREADS, NC == 1 ? 2 : 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                 T* __restrict__ out, int M, int N, int K, int vec_out) {
  using C = Cfg<NC, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* epi = reinterpret_cast<float*>(smem + STAGES * C::STAGE);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(epi + NC * 64 * C::EPI_LD), empty = full + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + C::BM - 1) / C::BM * n_tiles;
  const int k_steps = (K + kBK - 1) / kBK;

  if (wg == NC) {  // the producer warp: one thread keeps the ring full
    if (tid == 128 * NC) {
      int s = 0, ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * C::BM, n0 = t % n_tiles * BN;
        for (int k = 0; k < k_steps; ++k) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, C::STAGE);
          const uint32_t a = ring + s * C::STAGE;
          tma_load(a, &xmap, k * kBK, m0, full + 8 * s);
          tma_load(a + C::BM * kBK, &wmap, k * kBK, n0, full + 8 * s);
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // consumer warpgroup `wg`: rows [64 wg, 64 wg + 64) of each tile
  const int lane = tid & 31, warp = (tid >> 5) & 3, t128 = tid & 127;
  const float xsc = *x_scale;
  float* my_epi = epi + wg * 64 * C::EPI_LD;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int s = 0, ph = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_tiles * C::BM, n0 = t % n_tiles * BN;
    int prev = 0;
    for (int k = 0; k < k_steps; ++k) {
      mbar_wait(full + 8 * s, ph);
      wgmma_fence();
      const uint32_t a = ring + s * C::STAGE + wg * 64 * kBK;
      const uint32_t b = ring + s * C::STAGE + C::BM * kBK;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        Wgmma<BN>::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), k | kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release that stage
      if (k > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // accumulator 4j + e: row 16 warp + lane/4 + 8 (e >> 1), column 8 j + 2 (lane & 3) + (e & 1)
    const int r = 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float s0 = n0 + c < N ? xsc * w_scale[n0 + c] : 0.f;
      const float s1 = n0 + c + 1 < N ? xsc * w_scale[n0 + c + 1] : 0.f;
      *reinterpret_cast<float2*>(my_epi + r * C::EPI_LD + c) =
          make_float2((float)acc[4 * j] * s0, (float)acc[4 * j + 1] * s1);
      *reinterpret_cast<float2*>(my_epi + (r + 8) * C::EPI_LD + c) =
          make_float2((float)acc[4 * j + 2] * s0, (float)acc[4 * j + 3] * s1);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    const int row0 = m0 + 64 * wg;
    if (vec_out) {  // N * sizeof(T) a multiple of 16: whole 16-byte pieces
      constexpr int EV = 16 / sizeof(T), CPR = BN / EV;
      for (int i = t128; i < 64 * CPR; i += 128) {
        const int rr = i / CPR, c = i % CPR * EV;
        if (row0 + rr < M && n0 + c < N)
          store16<T>(out + (long long)(row0 + rr) * N + n0 + c, my_epi + rr * C::EPI_LD + c);
      }
    } else {  // only the tile's columns inside N: 3 of 64 for the reference points
      const int cols = N - n0 < BN ? N - n0 : BN;
      for (int i = t128; i < 64 * cols; i += 128) {
        const int rr = i / cols, c = i % cols;
        if (row0 + rr < M)
          out[(long long)(row0 + rr) * N + n0 + c] = from_f<T>(my_epi[rr * C::EPI_LD + c]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// [rows, K] int8, K contiguous, boxes of kBK bytes x box_rows rows, 128-byte swizzle
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T, int NC, int BN, int STAGES>
cudaError_t launch(const void* x, const void* w, const void* x_scale, const void* w_scale,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  using C = Cfg<NC, BN, STAGES>;
  auto kernel = int8_gemm_kernel<T, NC, BN, STAGES>;
  static int sms = 0, per_sm = 0;  // once per configuration: the opt-in and the occupancy
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::THREADS, C::SMEM);
    if (e != cudaSuccess) { per_sm = 0; return e; }
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  CUtensorMap xmap, wmap;
  if (!encode_map(&xmap, x, M, K, C::BM) || !encode_map(&wmap, w, N, K, BN))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((M + C::BM - 1) / C::BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  const int vec_out = (N * (int)sizeof(T)) % 16 == 0 && (uintptr_t)out % 16 == 0;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(xmap, wmap, (const float*)x_scale,
                                                (const float*)w_scale, (T*)out, M, N, K, vec_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int config, const void* x, const void* w, const void* x_scale,
                     const void* w_scale, void* out, int M, int N, int K, cudaStream_t st) {
  switch (config) {  // the order of ops/int8_matmul.py::GEMM_CONFIGS
    case 0: return launch<T, 2, 128, 4>(x, w, x_scale, w_scale, out, M, N, K, st);
    case 1: return launch<T, 2, 64, 6>(x, w, x_scale, w_scale, out, M, N, K, st);
    case 2: return launch<T, 1, 64, 4>(x, w, x_scale, w_scale, out, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [M, K] int8, w [N, K] int8, x_scale [1] f32, w_scale [N] f32, out [M, N];
// K a multiple of 16, x and w 16-byte aligned; out_dtype 0 = float32,
// 1 = bfloat16; config indexes GEMM_CONFIGS of ops/int8_matmul.py.
int int8_gemm_forward(const void* x, const void* w, const void* x_scale, const void* w_scale,
                      void* out, int M, int N, int K, int out_dtype, int config, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || (uintptr_t)x % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == 0)
    return (int)dispatch<float>(config, x, w, x_scale, w_scale, out, M, N, K, st);
  if (out_dtype == 1)
    return (int)dispatch<__nv_bfloat16>(config, x, w, x_scale, w_scale, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
