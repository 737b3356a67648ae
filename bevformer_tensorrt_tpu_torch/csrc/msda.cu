// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/msda_gather.py::msda_gather_sorted
//   (MSDA mode, reached through ops/msda.py::_sorted_core)
// and computes the function of ops/msda.py::multi_scale_deformable_attn:
// softmax of the raw logits over (level, point), sampling locations
// ref + offset / (W, H), a bilinear gather with torch grid-sample border
// rules (align_corners=False, zero weight outside the image), and the
// weighted sum.  The TPU kernel's sorted taps, key panels and packed u32
// tables exist for Mosaic's limits; a GPU gathers natively, so none of them
// carries over.
//
// Bound on this card: bytes.  Per (query, head) the kernel reads L*P logits,
// 2*L*P offsets and 4*L*P corner rows of ch values, and writes ch values;
// the arithmetic is ~8 flops per corner value.  The value tables of the
// main path (2.4-5.1 MB) fit in the 50 MB L2, so the corner rows are served
// from L2 and device memory sees roughly each input once.
//
// Design: one warp per (batch, query, head), one lane per channel (ch 32;
// other widths loop over the lanes).  Lanes first split the logits and the
// sampling locations of up to 32 points, the softmax is a warp reduction in
// f32 registers, and each point is then broadcast with a shuffle so the whole
// warp reads one corner row as one coalesced 128-byte transaction (f32,
// ch 32); corners outside the image are skipped (a warp-uniform branch).
// Accumulation is f32; the output is written once in the value's dtype.
// The kernel allocates nothing and launches on the caller's stream.
//
// int8 value tables (msda_int8_forward) replace the `packed="int8"` mode of
// the same TPU kernel (ops/msda.py::_pack_int8_quarters, the scale of
// _pack_tables_from_vt, the dequantization folded at _prep_taps_qminor):
// the value arrives as int8 rows [bs, keys, heads, ch] with one float32
// scale per (batch, head), the same kernel accumulates sum m * q in f32 from
// rows a quarter as wide (32 bytes at ch 32), and the scale multiplies the
// sum once at the end.  The TPU's u32 quads, channel quarters and bf16
// weights are Mosaic layout and do not carry over: weights stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// value [bs, nk, heads, ch]; ref [bs, nq, ppg*2] f32; off [bs, nq, heads, L*P*2];
// attn [bs, nq, heads, L*P]; levels [L, 3] int32 = (h, w, start);
// out [bs, nq, heads*ch].  CPL = channels per lane = ceil(ch / 32).
// V is the value's type: T, or int8_t with vscale [bs, heads] (else null).
template <typename V, typename T, int CPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
msda_kernel(const V* __restrict__ value, const float* __restrict__ vscale,
            const float* __restrict__ ref,
            const T* __restrict__ off, const T* __restrict__ attn,
            const int* __restrict__ levels, T* __restrict__ out,
            int bs, int nk, int nq, int heads, int ch, int L, int P, int ppg) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)bs * nq * heads) return;  // warp-uniform
  const int h = (int)(w % heads);
  const long long bq = w / heads;  // b * nq + q
  const long long b = bq / nq;
  const int LP = L * P;
  const T* a = attn + w * LP;
  const T* o = off + w * LP * 2;
  const float* r = ref + bq * ppg * 2;

  float m = -INFINITY;
  for (int i = lane; i < LP; i += 32) m = fmaxf(m, to_f(a[i]));
  m = warp_max(m);
  float s = 0.f;
  for (int i = lane; i < LP; i += 32) s += expf(to_f(a[i]) - m);
  s = warp_sum(s);

  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
  const V* vb = value + (b * nk * heads + h) * (long long)ch;

  for (int base = 0; base < LP; base += 32) {
    // lane i owns point base+i: point order within a level is (P/ppg, ppg),
    // ppg innermost, so point p uses reference group p % ppg.
    const int i = base + lane;
    float px = 0.f, py = 0.f, pw = 0.f;
    if (i < LP) {
      const int l = i / P, g = (i % P) % ppg;
      const float hl = (float)__ldg(levels + 3 * l), wl = (float)__ldg(levels + 3 * l + 1);
      const float lx = r[2 * g] + to_f(o[2 * i]) / wl;
      const float ly = r[2 * g + 1] + to_f(o[2 * i + 1]) / hl;
      px = lx * wl - 0.5f;
      py = ly * hl - 0.5f;
      pw = expf(to_f(a[i]) - m) / s;
    }
    const int n = min(32, LP - base);
    for (int j = 0; j < n; ++j) {
      const float x = __shfl_sync(kFull, px, j);
      const float y = __shfl_sync(kFull, py, j);
      const float pj = __shfl_sync(kFull, pw, j);
      const int l = (base + j) / P;
      const int hl = __ldg(levels + 3 * l), wl = __ldg(levels + 3 * l + 1);
      const int start = __ldg(levels + 3 * l + 2);
      const float x0 = floorf(x), y0 = floorf(y);
      const float wx1 = x - x0, wy1 = y - y0;
      // clamped before the int conversion: far-out samples stay out of the
      // image (every corner fails the bounds test) and nothing overflows
      const int ix = (int)fminf(fmaxf(x0, -2.f), (float)wl);
      const int iy = (int)fminf(fmaxf(y0, -2.f), (float)hl);
      const float cw[4] = {(1.f - wx1) * (1.f - wy1) * pj, wx1 * (1.f - wy1) * pj,
                           (1.f - wx1) * wy1 * pj, wx1 * wy1 * pj};
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int cx = ix + (c4 & 1), cy = iy + (c4 >> 1);
        if (cx < 0 || cx >= wl || cy < 0 || cy >= hl) continue;  // warp-uniform
        const V* row = vb + (long long)(start + cy * wl + cx) * heads * ch;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = lane + 32 * k;
          if (c < ch) acc[k] = fmaf(cw[c4], to_f(row[c]), acc[k]);
        }
      }
    }
  }
  const float vs = vscale != nullptr ? vscale[b * heads + h] : 1.f;
  T* op = out + w * ch;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    if (c < ch) op[c] = from_f<T>(vscale != nullptr ? acc[k] * vs : acc[k]);
  }
}

template <typename V, typename T>
cudaError_t launch(const void* value, const void* vscale, const void* ref, const void* off,
                   const void* attn,
                   const void* levels, void* out, int bs, int nk, int nq, int heads, int ch,
                   int L, int P, int ppg, cudaStream_t stream) {
  const long long warps = (long long)bs * nq * heads;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  const int cpl = (ch + 31) / 32;
#define MSDA_LAUNCH(N)                                                                  \
  msda_kernel<V, T, N><<<grid, block, 0, stream>>>(                                     \
      (const V*)value, (const float*)vscale, (const float*)ref, (const T*)off,          \
      (const T*)attn, (const int*)levels, (T*)out, bs, nk, nq, heads, ch, L, P, ppg)
  if (cpl == 1) MSDA_LAUNCH(1);
  else if (cpl == 2) MSDA_LAUNCH(2);
  else if (cpl <= 4) MSDA_LAUNCH(4);
  else return cudaErrorInvalidValue;
#undef MSDA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (value, offsets, logits and output).
int msda_forward(const void* value, const void* ref, const void* off, const void* attn,
                 const void* levels, void* out, int bs, int nk, int nq, int heads, int ch,
                 int L, int P, int ppg, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float, float>(value, nullptr, ref, off, attn, levels, out, bs, nk, nq,
                                     heads, ch, L, P, ppg, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(value, nullptr, ref, off, attn, levels,
                                                     out, bs, nk, nq, heads, ch, L, P, ppg, st);
  return (int)cudaErrorInvalidValue;
}

// int8 value rows [bs, nk, heads, ch] with vscale [bs, heads] f32; dtype is
// that of the offsets, logits and output.
int msda_int8_forward(const void* value, const void* vscale, const void* ref, const void* off,
                      const void* attn, const void* levels, void* out, int bs, int nk, int nq,
                      int heads, int ch, int L, int P, int ppg, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vscale == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<int8_t, float>(value, vscale, ref, off, attn, levels, out, bs, nk, nq,
                                      heads, ch, L, P, ppg, st);
  if (dtype == 1)
    return (int)launch<int8_t, __nv_bfloat16>(value, vscale, ref, off, attn, levels, out, bs,
                                              nk, nq, heads, ch, L, P, ppg, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
