// Deformable im2col of the modulated deformable convolution (DCNv2),
// forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/msda_gather.py::msda_gather_sorted
//   (im2col mode, emit_rows=True, reached through ops/dcn.py::_dcn_pallas)
// and computes, for each image n, output pixel s = (ho, wo), tap t = (i, j)
// and channel c of deform group g,
//   col[n, t*Cin + c, s] = mask[n, g, t, s] *
//       bilinear(x[n, c], (ho*stride - pad + i*dil + off_y[n, g, t, s],
//                          wo*stride - pad + j*dil + off_x[n, g, t, s]))
// with mmcv's border rule: a corner outside the map contributes 0, so a
// sample at p <= -1 or p >= size is 0.  The product with the weight that
// follows is left to a matrix product outside the kernel, as in the JAX
// package.  The TPU kernel's sorted taps, 128-pixel key panels, panel spans,
// row groups and channel-group tables exist for Mosaic's limits; a GPU
// gathers natively, so none of them carries over.
//
// Bound on this card: bytes.  Each element of x is read (about nine times,
// mostly from L1/L2), but each of the kh*kw*Cin*S column values is written
// once, so the column write is nearly all of the traffic: 9x the input.
// Arithmetic is 8 flops per column value.
//
// Design: one thread per output pixel, with the pixel index fastest so a
// warp's 32 column writes are one coalesced transaction and its 32 corner
// reads fall on neighbouring addresses of a few map rows (NCHW).  A block
// takes 512 pixels and a chunk of 8 channels of one deform group; the
// thread reads its offsets and mask once per tap in float32, turns them
// into four clamped corner indices and four weights (border test and mask
// folded in), and reuses them over the chunk's channels.  512 pixels are
// several rows of the map, so the corner reads of one warp, which offsets
// scatter over the rows around it, can hit lines in L1 that the block's other
// warps also read; a first version with 128 pixels and 32 channels per block
// took twice as long at base's stage-3 shape, and the short channel loop
// also gives the grid enough blocks for several waves.  Positions are
// float32 whatever the tensor type (bfloat16 cannot address a 100-pixel
// map).  x, offset and mask are read through strides, so NCHW and NHWC
// inputs need no copy.  The kernel allocates nothing and launches on the
// caller's stream.
//
// Second entry, `dcn_im2col_int8`: the same im2col from an int8 copy of the
// feature map.  Replaces the `packed="int8"` table of the same TPU kernel
// (bevformer_tensorrt_tpu/ops/dcn.py::_dcn_pallas; the scale lands on the
// columns at ops/dcn.py:227-230).  The map is quantized outside the kernel
// with one float32 scale per (image, group of `ch_group` consecutive
// channels); the kernel reads q through x's strides and writes
//   col[n, t*Cin + c, s] = scale[n, c / ch_group] * mask * sum_corners w * q
// with float32 sums, so the dequantization costs no pass over the column
// matrix (the column is linear in the table).  The TPU kernel's u32 int8-quad
// packing, corner rolls and bfloat16 blend weights do not carry over.  Still
// bound by the column write: the int8 map only cuts the corner reads to a
// quarter.  It is the float kernel with another element type for x (a
// template parameter); offsets, mask and columns keep the activation type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;  // pixels per block
constexpr int kChunk = 8;      // channels per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Geometry {
  int Cin, H, W, Ho, Wo, kh, kw, stride, pad, dil, dg;
  long long xs_n, xs_c, xs_y, xs_x;  // strides of x as [N, Cin, H, W]
  long long os_n, os_c, os_s;        // offset as [N, 2*dg*kh*kw, Ho*Wo]
  long long ms_n, ms_c, ms_s;        // mask as [N, dg*kh*kw, Ho*Wo]
};

// TX is the element type of x (T, or int8_t with `scale` [N, Cin / ch_group]);
// T the type of offset, mask and col.
template <typename TX, typename T>
__global__ void __launch_bounds__(kThreads)
dcn_im2col_kernel(const TX* __restrict__ x, const float* __restrict__ scale, const int ch_group,
                  const T* __restrict__ offset, const T* __restrict__ mask,
                  T* __restrict__ col, const Geometry p) {
  const int S = p.Ho * p.Wo;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int n = blockIdx.z;
  const int cpg = p.Cin / p.dg;  // channels per deform group
  const int chunks = (cpg + kChunk - 1) / kChunk;
  const int g = blockIdx.y / chunks;
  const int c0 = g * cpg + (blockIdx.y % chunks) * kChunk;
  const int c1 = min(c0 + kChunk, (g + 1) * cpg);
  const int ho = s / p.Wo, wo = s % p.Wo;
  const int taps = p.kh * p.kw;
  // the scale group of the chunk's first channel, found once: a division
  // per column value cost the int8 entry more than its narrower reads saved
  const float* scale0 = nullptr;
  int group_end0 = 0;
  if constexpr (std::is_same<TX, int8_t>::value) {
    scale0 = scale + n * (p.Cin / ch_group) + c0 / ch_group;
    group_end0 = (c0 / ch_group + 1) * ch_group;
  }

  const TX* xn = x + n * p.xs_n;
  const T* on = offset + n * p.os_n + s * p.os_s;
  const T* mn = mask + n * p.ms_n + s * p.ms_s;
  T* cn = col + (long long)n * taps * p.Cin * S + s;

  for (int t = 0; t < taps; ++t) {
    const int i = t / p.kw, j = t % p.kw;
    const int row = g * taps + t;
    const float oy = to_f(on[(2 * row) * p.os_c]);
    const float ox = to_f(on[(2 * row + 1) * p.os_c]);
    const float m = to_f(mn[row * p.ms_c]);
    const float py = (float)(ho * p.stride - p.pad + i * p.dil) + oy;
    const float px = (float)(wo * p.stride - p.pad + j * p.dil) + ox;
    const float y0 = floorf(py), x0 = floorf(px);
    const float wy1 = py - y0, wx1 = px - x0;
    // clamped before the int conversion: far-out samples stay outside the
    // map (every corner fails the bounds test) and nothing overflows
    const int iy = (int)fminf(fmaxf(y0, -2.f), (float)p.H);
    const int ix = (int)fminf(fmaxf(x0, -2.f), (float)p.W);
    const bool vy0 = iy >= 0 && iy < p.H, vy1 = iy + 1 >= 0 && iy + 1 < p.H;
    const bool vx0 = ix >= 0 && ix < p.W, vx1 = ix + 1 >= 0 && ix + 1 < p.W;
    // weights with the border test and the mask folded in; indices clamped
    // into the map so a corner of weight 0 still reads a valid address
    const float w00 = (vy0 && vx0) ? (1.f - wy1) * (1.f - wx1) * m : 0.f;
    const float w01 = (vy0 && vx1) ? (1.f - wy1) * wx1 * m : 0.f;
    const float w10 = (vy1 && vx0) ? wy1 * (1.f - wx1) * m : 0.f;
    const float w11 = (vy1 && vx1) ? wy1 * wx1 * m : 0.f;
    const long long ya = (long long)min(max(iy, 0), p.H - 1) * p.xs_y;
    const long long yb = (long long)min(max(iy + 1, 0), p.H - 1) * p.xs_y;
    const long long xa = (long long)min(max(ix, 0), p.W - 1) * p.xs_x;
    const long long xb = (long long)min(max(ix + 1, 0), p.W - 1) * p.xs_x;
    const long long k00 = ya + xa, k01 = ya + xb, k10 = yb + xa, k11 = yb + xb;

    T* ct = cn + ((long long)t * p.Cin + c0) * S;
    const TX* xc = xn + c0 * p.xs_c;
    const float* sp = scale0;  // int8 table: the scale of channel c, stepped along the chunk
    float sc = scale0 ? *scale0 : 1.f;
    int group_end = group_end0;
    if (w00 == 0.f && w01 == 0.f && w10 == 0.f && w11 == 0.f) {
      for (int c = c0; c < c1; ++c, ct += S) *ct = from_f<T>(0.f);
      continue;
    }
#pragma unroll 4
    for (int c = c0; c < c1; ++c, ct += S, xc += p.xs_c) {
      float v = w00 * to_f(xc[k00]);
      v = fmaf(w01, to_f(xc[k01]), v);
      v = fmaf(w10, to_f(xc[k10]), v);
      v = fmaf(w11, to_f(xc[k11]), v);
      if constexpr (std::is_same<TX, int8_t>::value) {
        if (c == group_end) {  // the chunk's channels ran into the next scale group
          sc = *++sp;
          group_end += ch_group;
        }
        v *= sc;
      }
      *ct = from_f<T>(v);
    }
  }
}

template <typename TX, typename T>
cudaError_t launch(const void* x, const void* scale, int ch_group, const void* offset,
                   const void* mask, void* col, int N, const Geometry& p, cudaStream_t stream) {
  const int S = p.Ho * p.Wo;
  const int cpg = p.Cin / p.dg;
  const int chunks = (cpg + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)(p.dg * chunks),
                  (unsigned)N);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  dcn_im2col_kernel<TX, T><<<grid, kThreads, 0, stream>>>(
      (const TX*)x, (const float*)scale, ch_group, (const T*)offset, (const T*)mask, (T*)col, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, offset, mask and col).  Strides are
// in elements.  col is [N, kh*kw*Cin, Ho*Wo], contiguous.
int dcn_im2col(const void* x, const void* offset, const void* mask, void* col, int N, int Cin,
               int H, int W, int Ho, int Wo, int kh, int kw, int stride, int pad, int dil,
               int dg, long long xs_n, long long xs_c, long long xs_y, long long xs_x,
               long long os_n, long long os_c, long long os_s, long long ms_n, long long ms_c,
               long long ms_s, int dtype, void* stream) {
  if (N < 1 || Cin < 1 || dg < 1 || Cin % dg || Ho < 1 || Wo < 1 || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry p = {Cin,  H,    W,    Ho,   Wo,   kh,   kw,   stride, pad,  dil,  dg,
                      xs_n, xs_c, xs_y, xs_x, os_n, os_c, os_s, ms_n,   ms_c, ms_s};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float, float>(x, nullptr, 1, offset, mask, col, N, p, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, nullptr, 1, offset, mask, col, N, p, st);
  return (int)cudaErrorInvalidValue;
}

// The same from an int8 map q (x's shape and strides) with scale
// [N, Cin / ch_group] float32, contiguous.  dtype is that of offset, mask
// and col.
int dcn_im2col_int8(const void* q, const void* scale, const void* offset, const void* mask,
                    void* col, int N, int Cin, int H, int W, int Ho, int Wo, int kh, int kw,
                    int stride, int pad, int dil, int dg, int ch_group, long long xs_n,
                    long long xs_c, long long xs_y, long long xs_x, long long os_n,
                    long long os_c, long long os_s, long long ms_n, long long ms_c,
                    long long ms_s, int dtype, void* stream) {
  if (N < 1 || Cin < 1 || dg < 1 || Cin % dg || Ho < 1 || Wo < 1 || kh < 1 || kw < 1 ||
      ch_group < 1 || Cin % ch_group)
    return (int)cudaErrorInvalidValue;
  const Geometry p = {Cin,  H,    W,    Ho,   Wo,   kh,   kw,   stride, pad,  dil,  dg,
                      xs_n, xs_c, xs_y, xs_x, os_n, os_c, os_s, ms_n,   ms_c, ms_s};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<int8_t, float>(q, scale, ch_group, offset, mask, col, N, p, st);
  if (dtype == 1)
    return (int)launch<int8_t, __nv_bfloat16>(q, scale, ch_group, offset, mask, col, N, p, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
