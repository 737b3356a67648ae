// Two probes of the gather that multi-scale deformable attention and the
// deformable im2col are built on, for Hopper (sm_90a).  They are the kernels
// of the port's kernel bench tool (tools/kernel_bench.py), not of any model.
//
// Replace the TPU design-space probes
//   tools/kernel_bench.py   run_a0 (row gather), run_a1 (gather + corner blend)
//   tools/kernel_bench2.py  run_a2 .. run_a4, tools/kernel_bench3.py variants A-C, F
//   tools/gather_bench.py   f_pallas, f_pallas2
// stripped of what asked questions about Mosaic (one-hot MXU products, wide
// windows, 128-key panels, VMEM probes, the compile bisection): a GPU gathers
// natively, so what is left to measure is the gather itself and the gather
// with the blend around it, at a locality the workload sets.
//
//   gather_rows : out[b, i, :]  = table[b, idx[b, i], :]
//   gather_blend: out[b, q, :]  = sum_e w[b, q, e] * table[b, idx[b, q, e], :]
//                 (e runs over taps x 4 corners; float32 sums)
//
// Bound on this card: bytes.  gather_rows writes as many bytes as it gathers;
// gather_blend reads at most the rows its indices name (or the whole table
// where that is less), 8 bytes of index and weight per row, and writes one
// row per query, so its arithmetic (2 flops per gathered value) is far below
// the memory time.
//
// Design.  gather_rows: one thread per 16-byte piece of an output row, pieces
// of a row on neighbouring threads, so a row moves as one or a few full
// sectors and the writes of a warp are contiguous.  gather_blend: one warp
// per (table, query), one lane per channel of the 32-channel row, which is
// the layout of the MSDA kernel (csrc/msda.cu); the warp loads 32 indices and
// weights at a time with one coalesced load each and hands them round with
// shuffles, so each gathered row costs one load instruction per warp (128
// bytes for float32 rows, 64 for bfloat16, 32 for int8).  Indices are clamped
// into the table.  The kernels allocate nothing and launch on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRow = 32;  // channels of a row of gather_blend: one per lane

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

__device__ __forceinline__ int clamp_key(int k, int keys) { return min(max(k, 0), keys - 1); }

// table [B, keys, chunks] of 16-byte pieces, idx [B, n], out [B, n, chunks]
__global__ void __launch_bounds__(kBlock)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                   uint4* __restrict__ out, const int keys, const long long n, const int chunks,
                   const long long total) {
  const long long tid = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (tid >= total) return;
  const long long r = tid / chunks;  // b * n + i
  const int c = (int)(tid - r * chunks);
  const long long b = r / n;
  const int k = clamp_key(idx[r], keys);
  out[tid] = table[(b * keys + k) * chunks + c];
}

// table [B, keys, 32] of T, idx and w [B * nq, entries], out [B * nq, 32] float32
template <typename T>
__global__ void __launch_bounds__(kBlock)
gather_blend_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                    const float* __restrict__ w, float* __restrict__ out, const int keys,
                    const int nq, const int entries, const long long total_q) {
  const long long r = ((long long)blockIdx.x * kBlock + threadIdx.x) / 32;  // b * nq + q
  const int lane = threadIdx.x & 31;
  if (r >= total_q) return;  // whole warps leave together
  const T* tb = table + (r / nq) * (long long)keys * kRow;
  const int* ir = idx + r * entries;
  const float* wr = w + r * entries;
  float acc = 0.f;
  for (int e0 = 0; e0 < entries; e0 += 32) {
    const int e = e0 + lane;
    const int k = e < entries ? clamp_key(ir[e], keys) : 0;
    const float wl = e < entries ? wr[e] : 0.f;
    const int m = min(32, entries - e0);
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const int kj = __shfl_sync(0xffffffffu, k, j);
      const float wj = __shfl_sync(0xffffffffu, wl, j);
      acc = fmaf(wj, to_f(tb[(long long)kj * kRow + lane]), acc);
    }
  }
  out[r * kRow + lane] = acc;
}

template <typename T>
cudaError_t launch_blend(const void* table, const void* idx, const void* w, void* out, int B,
                         int keys, int nq, int entries, cudaStream_t stream) {
  const long long total_q = (long long)B * nq;
  const long long blocks = (total_q * 32 + kBlock - 1) / kBlock;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  gather_blend_kernel<T><<<(unsigned)blocks, kBlock, 0, stream>>>(
      (const T*)table, (const int*)idx, (const float*)w, (float*)out, keys, nq, entries, total_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [B, keys, row_bytes] (row_bytes a multiple of 16, 16-byte aligned),
// idx [B, n] int32, out [B, n, row_bytes].
int gather_rows(const void* table, const void* idx, void* out, int B, int keys, long long n,
                int row_bytes, void* stream) {
  if (B < 1 || keys < 1 || n < 1 || row_bytes < 16 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = row_bytes / 16;
  const long long total = (long long)B * n * chunks;
  const long long blocks = (total + kBlock - 1) / kBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (uint4*)out, keys, n, chunks, total);
  return (int)cudaGetLastError();
}

// dtype of the table: 0 = float32, 1 = bfloat16, 2 = int8; rows of 32
// channels.  idx int32 and w float32 [B, nq, entries]; out float32 [B, nq, 32].
int gather_blend(const void* table, const void* idx, const void* w, void* out, int B, int keys,
                 int nq, int entries, int dtype, void* stream) {
  if (B < 1 || keys < 1 || nq < 1 || entries < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_blend<float>(table, idx, w, out, B, keys, nq, entries, st);
  if (dtype == 1)
    return (int)launch_blend<__nv_bfloat16>(table, idx, w, out, B, keys, nq, entries, st);
  if (dtype == 2) return (int)launch_blend<int8_t>(table, idx, w, out, B, keys, nq, entries, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
