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
// from L2 and device memory sees roughly each input once.  What held the
// first version (one warp per (query, head)) far above that bound was
// instructions: every lane redid each tap's softmax, location and corner
// math, and each load instruction fetched one row.
//
// Design: one block owns QT queries of one batch with all their heads, in
// two phases.
//  1. One thread per (query, head, tap) (taps padded to LPP, a power of
//     two, at most the block's 256 threads): the logits, offsets and
//     reference points of the block are one contiguous run, read once.  The
//     softmax is a segmented reduction over the tap's LPP lanes (shuffles
//     within a warp, shared memory across warps where LPP > 32) with one
//     expf per tap.  The thread computes the location, clamps before the int
//     conversion (far-out samples stay out of the image and nothing
//     overflows), and writes four corners to shared memory, 8 bytes each:
//     the key and the weight (softmax x bilinear x border validity; 0
//     outside, with key 0).
//  2. The blend: each lane loads VW bytes of a row (16 where the row
//     allows), so one warp instruction reads rpw = 32 / lanes-per-row rows
//     (4 of float32, 8 of bfloat16, 16 of int8 at ch 32).  The rpw row
//     groups of a warp take rpw / SEG (query, head) outputs at a time, SEG
//     groups each, the fewest that give every warp of the block an output:
//     an instruction then reads rows of neighbouring heads of one query
//     (adjacent in memory where the heads sample nearby keys), and few
//     shuffles combine the shares.  Each group accumulates its share
//     of the output's 4 * L * P corners in f32, shuffles combine the SEG
//     shares, and the first stores the output, 16 bytes a lane where the row
//     allows.
// The int8 value tables (msda_int8_forward) replace the `packed="int8"` mode
// of the same TPU kernel (ops/msda.py::_pack_int8_quarters, the scale of
// _pack_tables_from_vt, the dequantization folded at _prep_taps_qminor):
// rows of int8 with one float32 scale per (batch, head) that multiplies the
// sum once at the end.  The TPU's u32 quads, channel quarters and bf16
// weights are Mosaic layout and do not carry over: weights stay float32.
// The launch geometry (QT, threads, LPP, VW, SEG, shared memory) comes from
// ops/msda.py::msda_launch_geometry and is checked here.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // a block; a softmax group (LPP taps) fits in it
constexpr int kTapPad = 2;     // int2 after each output's corners in shared memory

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int VW> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };
template <> struct Vec<1> { using type = unsigned char; };

// VW bytes of a row as VW / sizeof(V) floats, in one load instruction
template <typename V, int VW>
__device__ __forceinline__ void load_row(const V* p, float (&f)[VW / sizeof(V)]) {
  const typename Vec<VW>::type raw = __ldg(reinterpret_cast<const typename Vec<VW>::type*>(p));
  const V* e = reinterpret_cast<const V*>(&raw);
#pragma unroll
  for (int k = 0; k < VW / (int)sizeof(V); ++k) f[k] = to_f(e[k]);
}

// the reduction of a softmax group wider than a warp: each warp's partial
// through shared memory (every thread of the block calls it)
__device__ __forceinline__ float across_warps(float v, bool is_max, int lpp, float* red) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int per = lpp >> 5, first = warp / per * per;
  float r = red[first];
  for (int k = 1; k < per; ++k) r = is_max ? fmaxf(r, red[first + k]) : r + red[first + k];
  __syncthreads();
  return r;
}

// value [bs, nk, heads, ch]; ref [bs, nq, ppg*2] f32; off [bs, nq, heads, L*P*2];
// attn [bs, nq, heads, L*P]; levels [L, 3] int32 = (h, w, start);
// out [bs, nq, heads*ch].  V is the value's type: T, or int8_t with vscale
// [bs, heads] (else null).  Dynamic shared memory: the lpp * 4 corners of each of
// the qt * heads outputs, kTapPad apart so that row groups reading different
// outputs' corners hit different banks.
template <typename V, typename T, int VW>
__global__ void __launch_bounds__(kThreads, 3)
msda_kernel(const V* __restrict__ value, const float* __restrict__ vscale,
            const float* __restrict__ ref, const T* __restrict__ off,
            const T* __restrict__ attn, const int* __restrict__ levels, T* __restrict__ out,
            int nk, int nq, int heads, int ch, int L, int P, int ppg, int qt, int lpp,
            int seg, int out_vec) {
  extern __shared__ __align__(16) int2 taps[];
  __shared__ float red[kThreads / 32];
  const int LP = L * P;
  const int qblocks = (nq + qt - 1) / qt;
  const int b = blockIdx.x / qblocks, q0 = blockIdx.x % qblocks * qt;
  const int items = qt * heads * lpp;
  const int gw = lpp < 32 ? lpp : 32;

  // phase 1: one thread per (query, head, tap)
  for (int base = 0; base < items; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int t = i % lpp, hq = i / lpp;
    const int q = q0 + hq / heads, h = hq % heads;
    const bool live = i < items && q < nq && t < LP;
    const long long bqh = ((long long)b * nq + q) * heads + h;
    const float a = live ? to_f(attn[bqh * LP + t]) : -INFINITY;
    float m = a;
    for (int o = 1; o < gw; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (lpp > 32) m = across_warps(m, true, lpp, red);
    const float e = live ? expf(a - m) : 0.f;
    float s = e;
    for (int o = 1; o < gw; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lpp > 32) s = across_warps(s, false, lpp, red);
    if (i >= items) continue;
    int key[4] = {0, 0, 0, 0};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      // point order within a level is (P/ppg, ppg), ppg innermost: point p
      // uses reference group p % ppg
      const int l = t / P, g = t % P % ppg;
      const int hl = __ldg(levels + 3 * l), wl = __ldg(levels + 3 * l + 1);
      const int start = __ldg(levels + 3 * l + 2);
      const float* r = ref + ((long long)b * nq + q) * ppg * 2;
      const float lx = r[2 * g] + to_f(off[bqh * 2 * LP + 2 * t]) / (float)wl;
      const float ly = r[2 * g + 1] + to_f(off[bqh * 2 * LP + 2 * t + 1]) / (float)hl;
      const float x = lx * wl - 0.5f, y = ly * hl - 0.5f;
      const float pw = e / s;
      const float x0 = floorf(x), y0 = floorf(y);
      const float wx1 = x - x0, wy1 = y - y0;
      const int ix = (int)fminf(fmaxf(x0, -2.f), (float)wl);
      const int iy = (int)fminf(fmaxf(y0, -2.f), (float)hl);
      const float bw[4] = {(1.f - wx1) * (1.f - wy1), wx1 * (1.f - wy1), (1.f - wx1) * wy1,
                           wx1 * wy1};
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int cx = ix + (c4 & 1), cy = iy + (c4 >> 1);
        if (cx >= 0 && cx < wl && cy >= 0 && cy < hl) {
          key[c4] = start + cy * wl + cx;
          cw[c4] = bw[c4] * pw;
        }
      }
    }
    int4* dst = reinterpret_cast<int4*>(taps + hq * (4 * lpp + kTapPad) + 4 * t);
    dst[0] = make_int4(key[0], __float_as_int(cw[0]), key[1], __float_as_int(cw[1]));
    dst[1] = make_int4(key[2], __float_as_int(cw[2]), key[3], __float_as_int(cw[3]));
  }
  __syncthreads();

  // phase 2: a warp instruction reads rpw rows, VW bytes a lane; the row
  // groups take rpw / seg (query, head) outputs at a time, seg groups each
  constexpr int E = VW / sizeof(V);
  const int lpr = ch * (int)sizeof(V) / VW;  // lanes per row
  int rpw = 1;                                // rows per warp instruction
  while (2 * rpw * lpr <= 32) rpw *= 2;
  const int lane = threadIdx.x & 31, g = lane / lpr, j = lane % lpr;
  const int og = g / seg, sg = g % seg, per_pass = rpw / seg;
  const int outputs = qt * heads;
  const long long kstride = (long long)heads * ch;
  for (int o0 = (threadIdx.x >> 5) * per_pass; o0 < outputs; o0 += (blockDim.x >> 5) * per_pass) {
    const int o = o0 + og;
    const int q = q0 + o / heads, h = o % heads;
    const bool mine = g < rpw && o < outputs && q < nq;
    float acc[E];
#pragma unroll
    for (int k = 0; k < E; ++k) acc[k] = 0.f;
    if (mine) {
      const V* vb = value + ((long long)b * nk * heads + h) * ch + j * E;
      const int2* tp = taps + o * (4 * lpp + kTapPad);
#pragma unroll 4
      for (int r = sg; r < 4 * LP; r += seg) {
        const int2 c = tp[r];  // a zero weight outside the image reads key 0 and adds 0
        const float w = __int_as_float(c.y);
        float f[E];
        load_row<V, VW>(vb + c.x * kstride, f);
#pragma unroll
        for (int k = 0; k < E; ++k) acc[k] = fmaf(w, f[k], acc[k]);
      }
    }
    for (int d = seg / 2; d > 0; d >>= 1)  // the segments of an output, within its groups
#pragma unroll
      for (int k = 0; k < E; ++k) acc[k] += __shfl_down_sync(kFull, acc[k], d * lpr);
    if (!mine || sg != 0) continue;
    const float vs = vscale != nullptr ? vscale[(long long)b * heads + h] : 1.f;
    alignas(16) T res[E];
#pragma unroll
    for (int k = 0; k < E; ++k) res[k] = from_f<T>(vscale != nullptr ? acc[k] * vs : acc[k]);
    T* op = out + (((long long)b * nq + q) * heads + h) * ch + j * E;
    if constexpr (E * sizeof(T) % 16 == 0) {
      if (out_vec) {
#pragma unroll
        for (int k = 0; k < E * (int)sizeof(T) / 16; ++k)
          reinterpret_cast<uint4*>(op)[k] = reinterpret_cast<const uint4*>(res)[k];
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < E; ++k) op[k] = res[k];
  }
}

template <typename V, typename T, int VW>
cudaError_t launch_vw(const void* value, const void* vscale, const void* ref, const void* off,
                      const void* attn, const void* levels, void* out, int blocks, int threads,
                      int smem, int nk, int nq, int heads, int ch, int L, int P, int ppg, int qt,
                      int lpp, int seg, int out_vec, cudaStream_t stream) {
  if constexpr (VW < sizeof(V)) {
    return cudaErrorInvalidValue;
  } else {
    auto kernel = msda_kernel<V, T, VW>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<blocks, threads, smem, stream>>>(
        (const V*)value, (const float*)vscale, (const float*)ref, (const T*)off, (const T*)attn,
        (const int*)levels, (T*)out, nk, nq, heads, ch, L, P, ppg, qt, lpp, seg, out_vec);
    return cudaGetLastError();
  }
}

template <typename V, typename T>
cudaError_t launch(const void* value, const void* vscale, const void* ref, const void* off,
                   const void* attn, const void* levels, void* out, int bs, int nk, int nq,
                   int heads, int ch, int L, int P, int ppg, int qt, int threads, int lpp, int vw,
                   int seg, cudaStream_t stream) {
  // the geometry of ops/msda.py::msda_launch_geometry, checked
  const int LP = L * P;
  const long long smem = 8LL * qt * heads * (4 * lpp + kTapPad);
  const int row = ch * (int)sizeof(V);
  if (bs < 1 || nq < 1 || heads < 1 || ch < 1 || ch > 128 || L < 1 || P < 1 || ppg < 1 ||
      qt < 1 || lpp < LP || lpp & (lpp - 1) || lpp > kThreads || threads != kThreads ||
      smem > 232448 || vw < 1 || vw > 16 || vw & (vw - 1) || row % vw ||
      row / vw > 32 || (uintptr_t)value % vw || seg < 1 || seg & (seg - 1) ||
      seg * (row / vw) > 32)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)bs * ((nq + qt - 1) / qt);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int out_vec = (ch * (int)sizeof(T)) % 16 == 0 && (uintptr_t)out % 16 == 0;
#define MSDA_VW(W)                                                                        \
  launch_vw<V, T, W>(value, vscale, ref, off, attn, levels, out, (int)blocks, threads,    \
                     (int)smem, nk, nq, heads, ch, L, P, ppg, qt, lpp, seg, out_vec, stream)
  switch (vw) {
    case 16: return MSDA_VW(16);
    case 8: return MSDA_VW(8);
    case 4: return MSDA_VW(4);
    case 2: return MSDA_VW(2);
    default: return MSDA_VW(1);
  }
#undef MSDA_VW
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (value, offsets, logits and output).
// qt, threads, lpp, vw and seg: the launch geometry (ops/msda.py::msda_launch_geometry).
int msda_forward(const void* value, const void* ref, const void* off, const void* attn,
                 const void* levels, void* out, int bs, int nk, int nq, int heads, int ch,
                 int L, int P, int ppg, int dtype, int qt, int threads, int lpp, int vw,
                 int seg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float, float>(value, nullptr, ref, off, attn, levels, out, bs, nk, nq,
                                     heads, ch, L, P, ppg, qt, threads, lpp, vw, seg, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(value, nullptr, ref, off, attn, levels,
                                                     out, bs, nk, nq, heads, ch, L, P, ppg, qt,
                                                     threads, lpp, vw, seg, st);
  return (int)cudaErrorInvalidValue;
}

// int8 value rows [bs, nk, heads, ch] with vscale [bs, heads] f32; dtype is
// that of the offsets, logits and output.
int msda_int8_forward(const void* value, const void* vscale, const void* ref, const void* off,
                      const void* attn, const void* levels, void* out, int bs, int nk, int nq,
                      int heads, int ch, int L, int P, int ppg, int dtype, int qt, int threads,
                      int lpp, int vw, int seg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vscale == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<int8_t, float>(value, vscale, ref, off, attn, levels, out, bs, nk, nq,
                                      heads, ch, L, P, ppg, qt, threads, lpp, vw, seg, st);
  if (dtype == 1)
    return (int)launch<int8_t, __nv_bfloat16>(value, vscale, ref, off, attn, levels, out, bs,
                                              nk, nq, heads, ch, L, P, ppg, qt, threads, lpp,
                                              vw, seg, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
