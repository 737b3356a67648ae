// Modulated deformable convolution (DCNv2), forward, as one kernel for
// Hopper (sm_90a): the taps are sampled into shared memory and feed the
// product with the weight from there, so no column matrix exists.
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/msda_gather.py::msda_gather_sorted
//   (im2col mode, reached through ops/dcn.py::_dcn_pallas, with the product
//   that follows it at ops/dcn.py:231-240, and the `packed="int8"` table of
//   ops/dcn.py:215-230)
// and computes, for image n, output channel o of conv group g, output pixel
// s = (ho, wo), tap t = (i, j) and input channel c of the group,
//   out[n, o, s] = sum_{t, c} W[o, c, t] * mask[n, d, t, s] *
//       bilinear(x[n, c], (ho*stride - pad + i*dil + off_y[n, d, t, s],
//                          wo*stride - pad + j*dil + off_x[n, d, t, s]))
//     (+ bias[o])
// with d the deform group of c and mmcv's border rule (a corner outside the
// map contributes 0).  Positions, bilinear weights and sums are float32
// whatever the activation type; the output is in the activation type.
//
// Bound on this card: operations.  At base's stage-3 block one launch is
// 41.2 GFLOP against 36 MB of inputs and output: 42 us at the bfloat16
// tensor-core rate, 615 us at the float32 FFMA rate, 11 us of bytes.  What
// the old route (im2col kernel, then a library product) spent most on was
// writing and reading back the column matrix, 9x the input (321 MB in
// float32 at that shape).
//
// Design: an implicit GEMM.  M = output channels of one conv group, N =
// output pixels, K = kh*kw*Cin of the group, ordered (tap, channel) as the
// kept weight matrix is (ops/dcn.py::dcn_weight_matrix).  A block owns a
// BM x BN output tile and walks K in steps of 128 bytes of channels of one
// tap: a chunk of channels through all the taps, then the next chunk, so the
// corner rows of a chunk's taps stay in cache.  A step never crosses a tap or
// a deform group (it is cut short at either; its missing channels are zero
// rows of the sampled tile, which the next tap's weights then multiply by
// zero).
//  * The gather table: the map with its channels last ([N, H, W, C]), made
//    by `dcn_gather_table` below in one pass (or the NHWC map itself), so a
//    corner's channels are one contiguous run that a lane reads 16 bytes at
//    a time; reading an NCHW map directly, one channel a lane, was several
//    times slower on an H100.
//  * The corner table: for each (tap, pixel) of the tile, four clamped
//    corner offsets and four weights with the border test and the mask
//    folded in, 32 bytes in shared memory, made by the whole block once per
//    deform group and read by every channel chunk.
//  * The weights: one TMA box a step on an mbarrier, one step ahead (two
//    buffers: deeper rings left less shared memory to L1 and were slower).
//  * Pixel tiles run across the images (no tile is left part empty at an
//    image's end), and where the tiles outnumber the blocks the card holds
//    at once each block takes an equal run of (tile, step) iterations
//    (stream-K), so no SM idles through a last partial wave; a tile two
//    blocks share is finished by the second from the two float32 shares
//    in a workspace (finish_share).
//  * bfloat16 (`dcn_wgmma_kernel`): 128-pixel tiles; the weights K-major
//    in the 128-byte swizzle; every thread samples (a warp
//    reads four pixels' 128-byte runs of channels a corner) into the step's
//    B tile, K-major in the same swizzle (by hand, as TMA would), fenced to
//    the async proxy before the barrier; two warpgroups run
//    wgmma.mma_async m64n128k16 f32.bf16.bf16, and while the tensor cores
//    run one step the same threads sample the next into the other buffer.
//    The epilogue adds the bias in float32, casts once, stages the tile in
//    shared memory and stores 16 bytes a lane along the output's contiguous
//    axis where the rows allow.
//  * float32 (`dcn_ffma_kernel`): a register-tiled FFMA product on the CUDA
//    cores, 8x8 (or 8x4) outputs a thread from tiles with the outputs
//    contiguous (the transposed weight matrix by TMA, the sampled tile with
//    a warp's lanes on consecutive pixels), two blocks an SM; the next
//    step's int8 corners are copied into shared memory (cp.async) while the
//    block multiplies.  TF32 stays off: it would change the function.  ops/dcn.py sends the int8 table's float32
//    activations here; the float32 map keeps the im2col route, which this
//    kernel did not beat on an H100 (PERF.md, section 6).
// The int8 table (TX = int8_t) is the same kernels with another table: the
// codes q = clamp(rint(x / s), -127, 127), written channels last by
// `dcn_gather_table` with an IEEE division (bit for bit
// ops/dcn.py::quantize_dcn_table), one scale s per (image, group of 32 or
// 64 channels) that multiplies the blend; a code becomes a float by a byte
// permute and a subtraction, off the slow conversion unit.  Offsets, mask
// and the output are read and written through strides, so NCHW and NHWC
// need no copy of them.  The kernels allocate nothing (the caller passes
// the stream-K workspace) and launch on the caller's stream; the tile
// configuration comes from ops/dcn.py::dcn_config and is checked here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::fence_proxy_async;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::sw128_offset;
using hopper::tma_load;

constexpr int kThreads = 256;  // a block: two warpgroups; every thread samples
constexpr int kBN = 128;       // output pixels of a tile
constexpr int kStepBytes = 128;  // bytes of K (channels of one tap) per step
constexpr int kAStages = 2;      // weight tiles in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

struct Geo {
  int Cin, H, W, Ho, Wo, kh, kw, stride, pad, dil, dg, Cout;
  int cin_g, cout_g, cpdg, ch_group;  // per conv group, per deform group, per scale
  int ka, kcap;  // K elements of 16 bytes (TMA's alignment); channels a step takes at most
  long long xs_n, xs_c, xs_y, xs_x;  // x as [N, Cin, H, W]
  long long os_n, os_c, os_s;        // offset as [N, 2*dg*kh*kw, Ho*Wo]
  long long ms_n, ms_c, ms_s;        // mask as [N, dg*kh*kw, Ho*Wo]
  long long ys_n, ys_c, ys_s;        // out as [N, Cout, Ho*Wo]
  // set at launch: the images; pixel tiles (the FFMA kernel's run across
  // the images), row tiles of a conv group; for the FFMA kernel's schedule
  // the K steps of every tile (0 where the groups' walks differ in length)
  // and the (tile, step) iterations each block takes (0: one block a tile)
  int images, ptiles, mtiles, steps, span;
  // the wgmma kernel's stream-K workspace: the two float32 shares of a tile
  // that two blocks split, per block boundary, and an arrival count each
  float* ws;
  int* cnt;
};

// CUT: 0; the bench's split (dcn_fused_split.cu) builds 1, no corner loads
// (the sampled tiles blend zeros), and 2, no product.

// The K step a block is on: tap t, channels [c, c + len) of its conv group.
// The walk takes a chunk of channels through all the taps before the next
// chunk, so the corner rows that a chunk's nine taps read around the tile
// stay in L1 between steps.  TMA reads the step's weight columns from a
// 16-byte boundary: from column t * cin_g + c less its `shift` (that column
// modulo ka), so the step's channels sit at rows [shift, shift + len) of
// the sampled tile and its other rows are zero.  A chunk is cut short
// enough (kcap) that this fits where groups or deform groups are not whole
// multiples of 16 bytes.
struct Step {
  int t, c, len;
};

// channels of the chunk that starts at c: at most kcap, cut at the group's
// end and at a deform-group boundary
__host__ __device__ __forceinline__ int chunk_len(const Geo& p, int g, int c) {
  const int abs = g * p.cin_g + c;
  return min(min(p.kcap, p.cin_g - c), p.cpdg - abs % p.cpdg);
}

__host__ __device__ __forceinline__ Step next_step(const Geo& p, int g, Step st) {
  if (st.t + 1 < p.kh * p.kw) return Step{st.t + 1, st.c, st.len};
  const int c = st.c + st.len;
  return Step{0, c, c < p.cin_g ? chunk_len(p, g, c) : 0};
}

__device__ __forceinline__ int step_shift(const Geo& p, const Step& st) {
  return (st.t * p.cin_g + st.c) % p.ka;
}

// One pixel's sampling of one (tap, deform group): four corner offsets
// into x's (y, x) plane, clamped into the map so a corner of weight 0 still
// reads a valid address, and four weights with the border test and the mask
// folded in.  32 bytes in shared memory, as two 16-byte halves.
template <typename T>
__device__ __forceinline__ void tap_corners(const Geo& p, const T* __restrict__ offset,
                                            const T* __restrict__ mask, int n, int s, int t,
                                            int d, int4& k, float4& w) {
  const int ho = s / p.Wo, wo = s % p.Wo;
  const int i = t / p.kw, j = t % p.kw;
  const int row = d * p.kh * p.kw + t;
  const T* on = offset + n * p.os_n + s * p.os_s;
  const float oy = to_f(on[(2 * row) * p.os_c]);
  const float ox = to_f(on[(2 * row + 1) * p.os_c]);
  const float m = to_f(mask[n * p.ms_n + row * p.ms_c + s * p.ms_s]);
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
  w.x = (vy0 && vx0) ? (1.f - wy1) * (1.f - wx1) * m : 0.f;
  w.y = (vy0 && vx1) ? (1.f - wy1) * wx1 * m : 0.f;
  w.z = (vy1 && vx0) ? wy1 * (1.f - wx1) * m : 0.f;
  w.w = (vy1 && vx1) ? wy1 * wx1 * m : 0.f;
  const int ya = min(max(iy, 0), p.H - 1) * (int)p.xs_y;
  const int yb = min(max(iy + 1, 0), p.H - 1) * (int)p.xs_y;
  const int xa = min(max(ix, 0), p.W - 1) * (int)p.xs_x;
  const int xb = min(max(ix + 1, 0), p.W - 1) * (int)p.xs_x;
  k = make_int4(ya + xa, ya + xb, yb + xa, yb + xb);
}

// A flat tile's pixel `pix`: the FFMA kernel's pixel tiles run across the
// images (pixel P = n * Ho * Wo + s of all N images), so no tile is left
// part empty at an image's end.  Returns s, with n, or -1 past the last.
template <int BN>
__device__ __forceinline__ int flat_pixel(const Geo& p, int tile, int pix, int& n) {
  const int S = p.Ho * p.Wo, P = tile * BN + pix;  // below 2^31 (checked at launch)
  if (P >= p.images * S) return -1;
  n = P / S;
  return P - n * S;
}

// The corner table of a tile: every (tap, pixel) of deform group d, made
// by the whole block once per deform group and read by every channel chunk.
// The corner offsets count from the table's start (the pixel's image
// included: the table is below 2^31 elements, checked at launch); tn holds
// each pixel's image.
template <int BN, typename T>
__device__ __forceinline__ void build_table(const Geo& p, const T* offset, const T* mask,
                                            int tile, int d, int4* tk, float4* tw, int* tn) {
  const int entries = p.kh * p.kw * BN;
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    int n = 0;
    const int s = flat_pixel<BN>(p, tile, e % BN, n);
    int4 k = make_int4(0, 0, 0, 0);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s >= 0) {
      tap_corners(p, offset, mask, n, s, e / BN, d, k, w);
      const int base = n * (int)p.xs_n;
      k = make_int4(k.x + base, k.y + base, k.z + base, k.w + base);
    }
    tk[e] = k;
    tw[e] = w;
    if (e < BN) tn[e] = n;
  }
}

constexpr size_t kTableEntry = 32;  // bytes of one (tap, pixel) of the corner table

// Element e of a corner's raw load of TX values, as float (e a constant
// after unrolling, so the raw words stay in registers)
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t word(const uint2& v, int i) { return i ? v.y : v.x; }
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename TX, typename V>
__device__ __forceinline__ float element(const V& v, int e) {
  constexpr int per = 4 / (int)sizeof(TX);  // elements a 32-bit word
  const uint32_t w = word(v, e / per);
  const int sub = e % per;
  if constexpr (std::is_same<TX, int8_t>::value) {
    // 2^23 + 128 + q as a float's bits (the code's byte, offset to unsigned,
    // under the exponent of 2^23), less 2^23 + 128: exact, and on the
    // integer and FMA pipes rather than the slow conversion unit
    const uint32_t u = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | sub);
    return __uint_as_float(u) - 8388736.f;
  } else if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    return __uint_as_float(sub ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float(w);
  }
}

template <typename T> struct Piece;  // 16 bytes of the sampled tile from PE floats
template <> struct Piece<float> {
  static constexpr int PE = 4;
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int PE = 8;
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    alignas(16) __nv_bfloat162 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    return *reinterpret_cast<const uint4*>(h);
  }
};

// One step's sampled tile for the wgmma kernel: kBN pixel rows of 128
// bytes of T (the step's channels), K-major in the 128-byte swizzle.  The
// table xg is channels-last (channel stride 1) at the conv group (the corner
// offsets carry the image): the map itself, or its int8 codes with the
// scales qscale [N, Cin / ch_group] (the pixel's image from tn).  Thread tid takes the items tid + kThreads * r: piece = item % 8
// (16 bytes of T, PE channels), pixel = item / 8, so a warp's corner loads
// read four pixels' 128-byte runs of channels; an item's four corners are
// one load each of PE * sizeof(TX) bytes (16 for a bfloat16 table, 8 for
// int8 codes), blended in float32 (times the scale of the codes' group: a
// piece lies in one group of 32 or 64 channels).  vec_x: every piece's
// channels lie in one aligned load.
template <typename T, typename TX, int CUT>
__device__ __forceinline__ void sample_step(const Geo& p, const TX* __restrict__ xg,
                                            const float* __restrict__ qscale, int g, int tile,
                                            const Step& st, const int4* tk, const float4* tw,
                                            const int* tn, uint8_t* dst, int vec_x) {
  constexpr int PE = Piece<T>::PE;
  constexpr int BYTES = PE * (int)sizeof(TX);
  constexpr bool Q = std::is_same<TX, int8_t>::value;
  using V = typename std::conditional<
      BYTES == 16, uint4, typename std::conditional<BYTES == 8, uint2, uint32_t>::type>::type;
#pragma unroll
  for (int r = 0; r < kBN * 8 / kThreads; ++r) {
    const int item = threadIdx.x + kThreads * r;
    const int piece = item & 7, pix = item >> 3;
    float v[PE];
#pragma unroll
    for (int e = 0; e < PE; ++e) v[e] = 0.f;
    const int shift = step_shift(p, st);  // 0 wherever vec_x
    const int c = st.c + piece * PE - shift;  // the piece's first row's channel, in the group
    if (piece * PE < shift + st.len && piece * PE + PE > shift &&
        tile * kBN + pix < p.images * p.Ho * p.Wo) {
      const int4 k = tk[st.t * kBN + pix];
      const float4 w = tw[st.t * kBN + pix];
      const TX* xc = xg + c;
      const float qs =
          Q ? qscale[(long long)tn[pix] * (p.Cin / p.ch_group) + (g * p.cin_g + c) / p.ch_group]
            : 1.f;
      if (vec_x) {
        V f[4];
        if (CUT != 1) {
          f[0] = __ldg(reinterpret_cast<const V*>(xc + k.x));
          f[1] = __ldg(reinterpret_cast<const V*>(xc + k.y));
          f[2] = __ldg(reinterpret_cast<const V*>(xc + k.z));
          f[3] = __ldg(reinterpret_cast<const V*>(xc + k.w));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) f[q] = V();
        }
#pragma unroll
        for (int e = 0; e < PE; ++e) {
          float a = w.x * element<TX>(f[0], e);
          a = fmaf(w.y, element<TX>(f[1], e), a);
          a = fmaf(w.z, element<TX>(f[2], e), a);
          a = fmaf(w.w, element<TX>(f[3], e), a);
          v[e] = Q ? a * qs : a;
        }
      } else {  // channels one at a time: a group or deform group not in whole pieces
        for (int e = 0; e < PE; ++e) {
          const int ch = c + e - st.c;  // the row's channel within the step
          if (ch < 0 || ch >= st.len) continue;
          float a = w.x * to_f(xc[e + k.x]);
          a = fmaf(w.y, to_f(xc[e + k.y]), a);
          a = fmaf(w.z, to_f(xc[e + k.z]), a);
          a = fmaf(w.w, to_f(xc[e + k.w]), a);
          v[e] = Q ? a * qs : a;
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + sw128_offset(pix, piece)) = Piece<T>::pack(v);
  }
  __syncwarp();  // the channel loops above may diverge; wgmma's .aligned forms must not
}

// ---- bfloat16: wgmma from shared memory --------------------------------------------

#define ACCF8(i)                                                                       \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),             \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d[64 x 128] += A[64 x 16] * B[128 x 16]^T, both K-major in shared memory
// (scale-d 1: accumulate; no negation, no transpose)
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACCF8(0), ACCF8(8), ACCF8(16), ACCF8(24), ACCF8(32), ACCF8(40), ACCF8(48), ACCF8(56)
      : "l"(a), "l"(b), "r"(1));
}
#undef ACCF8

// pins the accumulators in place around asynchronous wgmma: the compiler
// neither reads nor writes them across this point
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The walk of K steps shared by both kernels: the block's corner table,
// rebuilt where a chunk starts a new deform group (uniform across the
// block, so its barriers are too), and the A tiles, loaded by TMA (thread 0)
// into a ring of kAStages buffers, up to kAStages - 1 steps ahead of the
// product.
template <int BN>
struct Walk {
  const Geo& p;
  int g, tile, m0, table_d;
  int4* tk;
  float4* tw;
  int* tn;
  uint32_t ring, a_bytes;  // A stage s at ring + s * a_bytes
  uint64_t* full;          // one mbarrier a stage
  Step ahead;              // the next step whose A tile is to load
  int loaded;              // A tiles asked for so far
  bool k_inner;            // the weight map's inner axis is K (wgmma) or the rows (FFMA)
  int left;                // A tiles of the block's run still to ask for (-1: to the walk's end)

  template <typename T>
  __device__ __forceinline__ void table(const Step& st, const T* offset, const T* mask) {
    const int d = (g * p.cin_g + st.c) / p.cpdg;
    if (d == table_d) return;
    __syncthreads();  // the last chunk's samples are all taken
    build_table<BN>(p, offset, mask, tile, d, tk, tw, tn);
    __syncthreads();
    table_d = d;
  }
  // ask for the next A tile into its stage, if there is one; the stage's
  // last reader finished before the barrier that ended the step before
  __device__ __forceinline__ void load_next(const CUtensorMap* map) {
    if (ahead.c >= p.cin_g || left == 0) return;
    if (left > 0) --left;
    if (threadIdx.x == 0) {
      const int s = loaded % kAStages;
      const uint32_t bar = smem_u32(&full[s]);
      mbar_expect_tx(bar, a_bytes);
      const int k = ahead.t * p.cin_g + ahead.c - step_shift(p, ahead), m = g * p.cout_g + m0;
      tma_load(ring + s * a_bytes, map, k_inner ? k : m, k_inner ? m : k, bar);
    }
    ahead = next_step(p, g, ahead);
    ++loaded;
  }
  __device__ __forceinline__ uint32_t wait_a(int k) {
    mbar_wait(smem_u32(&full[k % kAStages]), (k / kAStages) & 1);
    return ring + (k % kAStages) * a_bytes;
  }
};

template <int MI> struct WgmmaCfg {
  static constexpr int BM = 128 * MI;  // two warpgroups of MI x 64 rows
  static constexpr int A_BYTES = BM * kStepBytes;
  static constexpr int B_BYTES = kBN * kStepBytes;
  // the A stages, then two B stages, then the corner table
  static constexpr size_t RING = 1024 + (size_t)kAStages * A_BYTES + 2 * (size_t)B_BYTES;
};

// TX: the map's type (__nv_bfloat16, or int8_t for the int8 table's codes
// with qscale [N, Cin / ch_group]); offset, mask, out bfloat16
// One block's run of (tile, K step) iterations under a stream-K schedule
// (Geo::span; 0: the block's own tile whole), as segments of one tile each.
struct Runs {
  long long it, end;
  int groups;
  __device__ __forceinline__ Runs(const Geo& p) : groups(p.Cout / p.cout_g) {
    const long long iters = (long long)p.ptiles * p.mtiles * groups * p.steps;
    it = p.span ? (long long)blockIdx.x * p.span : 0;
    end = p.span ? min(it + p.span, iters) : 1;
  }
  // the next segment: tile id, first step s0, steps count (-1: to the
  // walk's end); false at the run's end
  __device__ __forceinline__ bool next(const Geo& p, int& id, int& s0, int& count) {
    if (it >= end) return false;
    if (p.span) {
      id = (int)(it / p.steps);
      s0 = (int)(it % p.steps);
      count = (int)min((long long)(p.steps - s0), end - it);
      it += count;
    } else {
      id = blockIdx.x;
      s0 = 0;
      count = p.steps ? p.steps : -1;
      it = end;
    }
    return true;
  }
};

// A tile two blocks share under the stream-K schedule (a run is at least a
// tile long, so never more than two): each writes its float32 share of the
// A accumulators a thread holds (plus the bias, head share only) to the
// workspace slot of the block boundary inside the tile, and the second to
// arrive sums head + tail (in that order, whichever came first: the result
// does not depend on the order) into acc and finishes the tile.  Returns
// true where this block is the first (nothing more to do).  The boundary's
// arrival count is left at zero for the next launch.
template <int A, typename Bias>
__device__ __forceinline__ bool finish_share(const Geo& p, bool head, float* acc, Bias bias_of,
                                             int& last) {
  const int slot = blockIdx.x + (head ? 1 : 0);
  float* mine = p.ws + ((long long)slot * 2 + (head ? 0 : 1)) * (A * kThreads);
#pragma unroll
  for (int k = 0; k < A; ++k)
    __stcg(mine + k * kThreads + threadIdx.x, acc[k] + (head ? bias_of(k) : 0.f));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(p.cnt + slot, 1) == 1;
    if (last) p.cnt[slot] = 0;
  }
  __syncthreads();
  if (!last) return true;
  __threadfence();
  const float* both = p.ws + (long long)slot * 2 * (A * kThreads);
#pragma unroll
  for (int k = 0; k < A; ++k)
    acc[k] = __ldcg(both + k * kThreads + threadIdx.x) +
             __ldcg(both + (A + k) * kThreads + threadIdx.x);
  return false;
}

// TX: the map's type (__nv_bfloat16, or int8_t for the int8 table's codes
// with qscale [N, Cin / ch_group]); offset, mask, out bfloat16.  Pixel tiles
// run across the images and the schedule is the FFMA kernel's (one block a
// tile, or stream-K); a tile two blocks share is finished by the second to
// arrive: each writes its float32 share to the workspace, and the second
// sums head + tail (that order whichever came first) and stores it.
template <int MI, typename TX, int CUT>
__global__ void __launch_bounds__(kThreads, MI == 1 ? 2 : 1)
dcn_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const TX* __restrict__ x,
                 const float* __restrict__ qscale, const __nv_bfloat16* __restrict__ offset,
                 const __nv_bfloat16* __restrict__ mask, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, const Geo p, int vec_x, int vec_out) {
  using C = WgmmaCfg<MI>;
  constexpr int BM = C::BM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kAStages];
  __shared__ int last;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* btiles = smem + kAStages * C::A_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int entries = p.kh * p.kw * kBN;
  uint8_t* tab = btiles + 2 * C::B_BYTES;
  Walk<kBN> walk{p, 0, 0, 0, -1, reinterpret_cast<int4*>(tab),
                 reinterpret_cast<float4*>(tab + 16 * entries),
                 reinterpret_cast<int*>(tab + 32 * entries), smem_u32(smem), C::A_BYTES, full,
                 Step{0, 0, 0}, 0, true, -1};

  if (tid == 0) {
    for (int i = 0; i < kAStages; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int S0 = p.Ho * p.Wo, P_end = p.images * S0;
  int used = 0;  // A tiles taken from the ring
  Runs runs(p);
  int id, s0, count;
  while (runs.next(p, id, s0, count)) {
    const int mt = id % p.mtiles, pt = id / p.mtiles % p.ptiles, g = id / p.mtiles / p.ptiles;
    const int m0 = mt * BM;
    const bool whole = s0 == 0 && (count < 0 || count == p.steps);
    Step st{0, 0, chunk_len(p, g, 0)};
    for (int i = 0; i < s0; ++i) st = next_step(p, g, st);
    walk.g = g;
    walk.tile = pt;
    walk.m0 = m0;
    walk.table_d = -1;
    walk.ahead = st;
    walk.left = count;
    const TX* xg = x + g * p.cin_g;
    auto sample = [&](int buf, const Step& s) {
      walk.table(s, offset, mask);
      sample_step<__nv_bfloat16, TX, CUT>(p, xg, qscale, g, pt, s, walk.tk, walk.tw, walk.tn,
                                          btiles + buf * C::B_BYTES, vec_x);
    };

    float acc[MI][64];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mi][i] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_operands(acc[mi]);

    for (int i = 0; i < kAStages - 1; ++i) walk.load_next(&wmap);
    sample(0, st);
    fence_proxy_async();
    __syncthreads();
    for (int j = 0;; ++j) {
      const uint32_t a = walk.wait_a(used++) + wg * (64 * MI) * kStepBytes;
      const uint32_t b = smem_u32(btiles + (j & 1) * C::B_BYTES);
      __syncwarp();  // converged again after the barrier's wait loop
      hopper::wgmma_fence();
      if constexpr (CUT != 2) {
#pragma unroll
        for (int kk = 0; kk < kStepBytes / 32; ++kk)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            wgmma_bf16_n128(acc[mi], sw128_desc(a + mi * 64 * kStepBytes + 32 * kk),
                            sw128_desc(b + 32 * kk));
      }
      hopper::wgmma_commit();
      walk.load_next(&wmap);
      const Step nx = next_step(p, g, st);
      const bool more = count < 0 ? nx.c < p.cin_g : j + 1 < count;
      if (more) {  // while the tensor cores run this step, sample the next
        sample((j + 1) & 1, nx);
        fence_proxy_async();
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_operands(acc[mi]);
      __syncthreads();
      if (!more) break;
      st = nx;
    }

    // accumulator element (mi, i) sits at row acc_row(mi, i) of the tile and
    // pixel 8 (i / 4) + 2 (lane % 4) + i % 2
    auto acc_row = [&](int mi, int i) {
      return wg * 64 * MI + mi * 64 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    };
    auto bias_of = [&](int r) {
      return bias != nullptr && s0 == 0 && m0 + r < p.cout_g ? bias[g * p.cout_g + m0 + r] : 0.f;
    };
    if (!whole) {  // a share: to the workspace; the second to arrive finishes the tile
      auto bias_at = [&](int k) { return bias_of(acc_row(k / 64, k % 64)); };
      if (finish_share<MI * 64>(p, s0 == 0, &acc[0][0], bias_at, last)) continue;
    }

    // epilogue: bias in float32 (a whole tile's; a shared one has it in its
    // head share), one cast, the tile staged in shared memory (the ring is
    // free), then stores along the output's contiguous axis
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
    const bool pix_major = p.ys_s == 1;  // NCHW: a channel's pixels are contiguous
    constexpr int LDP = kBN + 8, LDC = BM + 8;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = acc_row(mi, 2 * half);
        const float bv = whole ? bias_of(r) : 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int c = 8 * j + 2 * (lane & 3);
          const float v0 = acc[mi][4 * j + 2 * half] + bv, v1 = acc[mi][4 * j + 2 * half + 1] + bv;
          if (pix_major) {
            *reinterpret_cast<__nv_bfloat162*>(stage + r * LDP + c) = __floats2bfloat162_rn(v0, v1);
          } else {
            stage[c * LDC + r] = __float2bfloat16(v0);
            stage[(c + 1) * LDC + r] = __float2bfloat16(v1);
          }
        }
      }
    __syncthreads();
    const int rows = min(BM, p.cout_g - m0);
    const int P0 = pt * kBN, cols = min(kBN, P_end - P0);
    auto at_pixel = [&](int P, int o) {  // output channel o of flat pixel P
      const int ne = P / S0;
      return out + ne * p.ys_n + (long long)o * p.ys_c + (long long)(P - ne * S0) * p.ys_s;
    };
    if (pix_major && vec_out) {  // 16 bytes: 8 consecutive pixels of a channel, of one image
      for (int i = tid; i < BM * (kBN / 8); i += kThreads) {
        const int r = i / (kBN / 8), c = i % (kBN / 8) * 8;
        if (r >= rows || c >= cols) continue;
        __nv_bfloat16* dst = at_pixel(P0 + c, g * p.cout_g + m0 + r);
        if (c + 8 <= cols) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(stage + r * LDP + c);
        } else {
          for (int e = 0; c + e < cols; ++e) dst[e] = stage[r * LDP + c + e];
        }
      }
    } else if (pix_major) {  // a warp's lanes on consecutive pixels
      for (int i = tid; i < BM * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        if (r < rows && c < cols) *at_pixel(P0 + c, g * p.cout_g + m0 + r) = stage[r * LDP + c];
      }
    } else {  // NHWC: 8 consecutive channels of a pixel
      for (int i = tid; i < kBN * (BM / 8); i += kThreads) {
        const int c = i / (BM / 8), r = i % (BM / 8) * 8;
        if (r >= rows || c >= cols) continue;
        __nv_bfloat16* dst = at_pixel(P0 + c, g * p.cout_g + m0 + r);
        if (vec_out && r + 8 <= rows) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(stage + c * LDC + r);
        } else {
          for (int e = 0; e < 8 && r + e < rows; ++e) dst[e] = stage[c * LDC + r + e];
        }
      }
    }
    fence_proxy_async();  // the staging's bytes go back to the TMA ring
    __syncthreads();
  }
}

// ---- float32: FFMA on the CUDA cores ---------------------------------------------

// Both tiles MN-major: A [BK k][BM rows] by TMA (no swizzle) from the
// transposed weight matrix, B [BK k][BN pixels] written by the sampler; then
// the staging area of the int8 corners (as many bytes as B).
template <int BN>
struct FfmaCfg {
  static constexpr int BM = 128, BK = kStepBytes / 4;  // 32 channels a step
  static constexpr int A_BYTES = BK * BM * 4;
  static constexpr int B_BYTES = BK * BN * 4;
  static constexpr int STAGE_BYTES = B_BYTES;
  static constexpr size_t RING =
      1024 + (size_t)kAStages * A_BYTES + (size_t)B_BYTES + (size_t)STAGE_BYTES;
};

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes16) {
  if (bytes16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The FFMA kernel's sampling of one step into its B tile [BK channels][BN
// pixels].  An item is a pixel and E channels of the step, one 16-byte load
// a corner (8 bytes for the int8 codes of a 64-pixel tile), blended in
// float32 (times the scale of the codes' group: an item lies in one group of
// 32 or 64 channels); rows [len, BK) are zero.  Thread tid takes items
// tid + kThreads * r: pixel = item % BN, so a warp's lanes are on
// consecutive pixels and its writes of a channel row fall on consecutive
// words.  vec_x: every item's channels lie in one aligned load; elsewhere
// they are read one at a time.
// The int8 corners are staged: `fetch` copies a thread's corners from the
// table into its own slots of the staging area (cp.async, no registers
// held), before the block multiplies the step before; `finish` waits for
// its own copies, blends them and writes B.  A float table's corners (64
// bytes an item, four items a thread) are loaded by `finish` itself.
template <typename TX, int BN, int CUT>
struct ColSampler {
  static constexpr bool Q = std::is_same<TX, int8_t>::value;
  static constexpr int BK = FfmaCfg<BN>::BK;
  static constexpr int E = Q ? (BN == 128 ? 16 : 8) : 4;
  static constexpr int R = BN * (BK / E) / kThreads;  // items a thread
  static constexpr bool STAGED = Q && CUT != 1;
  using V = typename std::conditional<E * sizeof(TX) == 16, uint4, uint2>::type;
  static_assert(R >= 1 && BN * (BK / E) == R * kThreads, "items must fill the block");
  static_assert(!Q || R * 4 * kThreads * (int)sizeof(V) <= FfmaCfg<BN>::STAGE_BYTES,
                "the staged corners must fit their area");

  // slot of item r, corner q of this thread: consecutive lanes, consecutive slots
  static __device__ __forceinline__ V* slot(uint8_t* stage, int r, int q) {
    return reinterpret_cast<V*>(stage) + (r * 4 + q) * kThreads + threadIdx.x;
  }
  // pix_ok: this thread's pixel (the same for all its items) is one
  static __device__ __forceinline__ bool live(const Step& st, int r, bool pix_ok, int& pix,
                                              int& part) {
    const int i = threadIdx.x + kThreads * r;
    pix = i % BN;
    part = i / BN;
    return pix_ok && part * E < st.len;
  }

  static __device__ __forceinline__ void fetch(const TX* __restrict__ xg, bool pix_ok,
                                               const Step& st, const int4* tk, uint8_t* stage,
                                               int vec_x) {
    if constexpr (STAGED) {
      if (!vec_x) return;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int pix, part;
        if (!live(st, r, pix_ok, pix, part)) continue;
        const int4 k = tk[st.t * BN + pix];
        const TX* xc = xg + st.c + part * E;
        constexpr int B16 = sizeof(V) == 16;
        cp_async(smem_u32(slot(stage, r, 0)), xc + k.x, B16);
        cp_async(smem_u32(slot(stage, r, 1)), xc + k.y, B16);
        cp_async(smem_u32(slot(stage, r, 2)), xc + k.z, B16);
        cp_async(smem_u32(slot(stage, r, 3)), xc + k.w, B16);
      }
      cp_async_commit();
    }
  }

  static __device__ __forceinline__ void finish(const Geo& p, const TX* __restrict__ xg,
                                                const float* __restrict__ qs_n, int g, bool pix_ok,
                                                const Step& st, const int4* tk, const float4* tw,
                                                uint8_t* stage, float* dst, int vec_x) {
    if constexpr (STAGED) cp_async_wait_all();  // this thread's own copies
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int pix, part;
      const bool on = live(st, r, pix_ok, pix, part);
      const int c = st.c + part * E;  // the item's first channel, in the group
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = 0.f;
      if (on) {
        const int4 k = tk[st.t * BN + pix];
        const float4 w = tw[st.t * BN + pix];
        const float qs = Q ? qs_n[(g * p.cin_g + c) / p.ch_group] : 1.f;
        const TX* xc = xg + c;
        if (vec_x) {
          V f[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) f[q] = V();
          if constexpr (STAGED) {
#pragma unroll
            for (int q = 0; q < 4; ++q) f[q] = *slot(stage, r, q);
          } else if constexpr (CUT != 1) {
            f[0] = __ldg(reinterpret_cast<const V*>(xc + k.x));
            f[1] = __ldg(reinterpret_cast<const V*>(xc + k.y));
            f[2] = __ldg(reinterpret_cast<const V*>(xc + k.z));
            f[3] = __ldg(reinterpret_cast<const V*>(xc + k.w));
          }
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float a = w.x * element<TX>(f[0], e);
            a = fmaf(w.y, element<TX>(f[1], e), a);
            a = fmaf(w.z, element<TX>(f[2], e), a);
            a = fmaf(w.w, element<TX>(f[3], e), a);
            v[e] = Q ? a * qs : a;
          }
        } else {  // channels one at a time: a group or deform group not in whole items
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (part * E + e >= st.len) break;
            float a = w.x * to_f(xc[e + k.x]);
            a = fmaf(w.y, to_f(xc[e + k.y]), a);
            a = fmaf(w.z, to_f(xc[e + k.z]), a);
            a = fmaf(w.w, to_f(xc[e + k.w]), a);
            v[e] = Q ? a * qs : a;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) dst[(part * E + e) * BN + pix] = v[e];
    }
  }
};

// One step's product: acc[i][j] += sum over k of A[k][row i] * B[k][pixel j].
// Thread (ty, tx) owns rows 4 ty + [0, 4) and 64 + 4 ty + [0, 4), pixels
// 4 tx + [0, 4) (and 64 + 4 tx + [0, 4) in a 128-pixel tile).  A warp is 4
// ty x 8 tx, so its reads of one k row are 4 (A) and 8 (B) consecutive
// 16-byte words: one shared-memory wavefront each, four 16-byte loads a
// thread for 64 FMAs (128-pixel tile).
template <int BN>
__device__ __forceinline__ void ffma_step(float (&acc)[8][BN / 16], const float* __restrict__ at,
                                          const float* __restrict__ bt, int ty, int tx) {
  constexpr int NB = BN / 64;  // 16-byte column groups of a thread
#pragma unroll
  for (int k = 0; k < FfmaCfg<BN>::BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(at + k * 128 + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(at + k * 128 + 64 + 4 * ty);
    float4 b[NB];
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
      b[jb] = *reinterpret_cast<const float4*>(bt + k * BN + 64 * jb + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        acc[i][4 * jb + 0] = fmaf(av[i], b[jb].x, acc[i][4 * jb + 0]);
        acc[i][4 * jb + 1] = fmaf(av[i], b[jb].y, acc[i][4 * jb + 1]);
        acc[i][4 * jb + 2] = fmaf(av[i], b[jb].z, acc[i][4 * jb + 2]);
        acc[i][4 * jb + 3] = fmaf(av[i], b[jb].w, acc[i][4 * jb + 3]);
      }
  }
}

// TX: float, or int8_t for the int8 table's codes; offset, mask, out
// float32.  128 x BN tiles, K steps of 32 channels; the walk and the corner
// table are the wgmma kernel's.  A step: the next step's int8 corners are
// copied into the staging area (cp.async), this step's product runs from
// the B tile, and after a barrier the staged corners are blended into B.
// Two blocks an SM (at most 128 registers a thread), so one block's blend
// and barriers run while the other multiplies.  (Holding the next step's
// corners in registers across the product instead spilled at this
// register count and was slower.)
// Schedule (Geo::span): one block a tile, or, where the tiles outnumber the
// blocks the SMs hold at once, as many blocks as they hold, each taking the
// same run of span (tile, K step) iterations (stream-K), so no SM idles
// through a last partial wave; a tile two blocks share is finished by
// finish_share.
template <typename TX, int BN, int CUT>
__global__ void __launch_bounds__(kThreads, 2)
dcn_ffma_kernel(const __grid_constant__ CUtensorMap wmap, const TX* __restrict__ x,
                const float* __restrict__ qscale, const float* __restrict__ offset,
                const float* __restrict__ mask, const float* __restrict__ bias,
                float* __restrict__ out, const Geo p, int vec_x, int vec_out) {
  using C = FfmaCfg<BN>;
  using S = ColSampler<TX, BN, CUT>;
  constexpr bool Q = S::Q;
  constexpr int BM = C::BM, NB = BN / 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kAStages];
  __shared__ int last;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* btile = reinterpret_cast<float*>(smem + kAStages * C::A_BYTES);
  uint8_t* stage = smem + kAStages * C::A_BYTES + C::B_BYTES;
  const int tid = threadIdx.x;
  const int entries = p.kh * p.kw * BN;
  uint8_t* tab = stage + C::STAGE_BYTES;
  Walk<BN> walk{p, 0, 0, 0, -1, reinterpret_cast<int4*>(tab),
                reinterpret_cast<float4*>(tab + 16 * entries),
                reinterpret_cast<int*>(tab + 32 * entries), smem_u32(smem), C::A_BYTES, full,
                Step{0, 0, 0}, 0, false, -1};

  if (tid == 0) {
    for (int i = 0; i < kAStages; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  int used = 0;  // A tiles taken from the ring
  Runs runs(p);
  int id, s0, count;  // this segment's tile and steps [s0, s0 + count)
  while (runs.next(p, id, s0, count)) {
    const int mt = id % p.mtiles, pt = id / p.mtiles % p.ptiles, g = id / p.mtiles / p.ptiles;
    const int m0 = mt * BM;
    const bool whole = s0 == 0 && (count < 0 || count == p.steps);
    Step st{0, 0, chunk_len(p, g, 0)};
    for (int i = 0; i < s0; ++i) st = next_step(p, g, st);
    walk.g = g;
    walk.tile = pt;
    walk.m0 = m0;
    walk.table_d = -1;
    walk.ahead = st;
    walk.left = count;
    // every item of this thread is of one pixel (kThreads is a multiple of
    // BN), so of one image: its scales (the corner offsets carry the image)
    int n = 0;
    const bool pix_ok = flat_pixel<BN>(p, pt, tid % BN, n) >= 0;
    const TX* xg = x + g * p.cin_g;
    const float* qs_n = Q ? qscale + (long long)n * (p.Cin / p.ch_group) : nullptr;

    float acc[8][BN / 16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;

    for (int i = 0; i < kAStages - 1; ++i) walk.load_next(&wmap);
    walk.table(st, offset, mask);
    S::fetch(xg, pix_ok, st, walk.tk, stage, vec_x);
    S::finish(p, xg, qs_n, g, pix_ok, st, walk.tk, walk.tw, stage, btile, vec_x);
    __syncthreads();
    for (int j = 0;; ++j) {
      walk.load_next(&wmap);
      const Step nx = next_step(p, g, st);
      const bool more = count < 0 ? nx.c < p.cin_g : j + 1 < count;
      if (more) {  // the next step's corners, in flight during this step's product
        walk.table(nx, offset, mask);
        S::fetch(xg, pix_ok, nx, walk.tk, stage, vec_x);
      }
      const float* at =
          reinterpret_cast<const float*>(smem + (walk.wait_a(used++) - smem_u32(smem)));
      if constexpr (CUT != 2) ffma_step<BN>(acc, at, btile, ty, tx);
      if (!more) break;
      __syncthreads();  // B is read
      S::finish(p, xg, qs_n, g, pix_ok, nx, walk.tk, walk.tw, stage, btile, vec_x);
      __syncthreads();
      st = nx;
    }

    // rows of acc[k][.]: m0 + 64 (k / 4) + 4 ty + k % 4; the bias is added
    // to a whole tile, and to a shared tile's head share
    auto bias_of = [&](int k) {
      const int r = m0 + 64 * (k >> 2) + 4 * ty + (k & 3);
      return bias != nullptr && s0 == 0 && r < p.cout_g ? bias[g * p.cout_g + r] : 0.f;
    };
    if (!whole) {  // a share: to the workspace; the second to arrive finishes the tile
      auto bias_at = [&](int k) { return bias_of(k / (BN / 16)); };
      if (finish_share<8 * (BN / 16)>(p, s0 == 0, &acc[0][0], bias_at, last)) continue;
    }

    // epilogue: NCHW four consecutive pixels of a channel (16 bytes where
    // the map's size and the address allow: a warp writes 128 contiguous
    // bytes of each of four rows), NHWC four consecutive channels of a pixel.
    // The four pixels of a thread are in one image wherever Ho * Wo % 4 == 0
    // (vec_out).
    const bool pix_major = p.ys_s == 1;
    const int S0 = p.Ho * p.Wo, P_end = p.images * S0;
    auto at_pixel = [&](int P, long long o) {  // output channel o of flat pixel P
      const int ne = P / S0;
      return out + ne * p.ys_n + o * p.ys_c + (long long)(P - ne * S0) * p.ys_s;
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = m0 + 64 * h + ty * 4;  // rows r0 .. r0 + 3 of the group
      float bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = whole ? bias_of(4 * h + i) : 0.f;
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const int P = pt * BN + 64 * jb + 4 * tx;  // flat pixels P .. P + 3
        if (P >= P_end) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r0 + i >= p.cout_g) continue;
          const float* a = &acc[4 * h + i][4 * jb];
          const long long o = (long long)(g * p.cout_g + r0 + i);
          if (pix_major && vec_out && P + 4 <= P_end) {
            *reinterpret_cast<float4*>(at_pixel(P, o)) =
                make_float4(a[0] + bv[i], a[1] + bv[i], a[2] + bv[i], a[3] + bv[i]);
          } else if (pix_major || !vec_out || r0 + 4 > p.cout_g) {
            for (int e = 0; e < 4 && P + e < P_end; ++e) *at_pixel(P + e, o) = a[e] + bv[i];
          }
        }
        if (!pix_major && vec_out && r0 + 4 <= p.cout_g) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (P + e < P_end)
              *reinterpret_cast<float4*>(at_pixel(P + e, g * p.cout_g + r0)) =
                  make_float4(acc[4 * h][4 * jb + e] + bv[0], acc[4 * h + 1][4 * jb + e] + bv[1],
                              acc[4 * h + 2][4 * jb + e] + bv[2],
                              acc[4 * h + 3][4 * jb + e] + bv[3]);
        }
      }
    }
  }
}

// The schedule (Geo::steps, Geo::span) for `blocks` blocks an SM:
// stream-K where every conv group's walk has the same length and the tiles
// outnumber the blocks the card holds at once, else one block a tile.
inline cudaError_t schedule(Geo& p, int blocks) {
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int groups = p.Cout / p.cout_g;
  int steps = -1;
  for (int g = 0; g < groups && steps != 0; ++g) {
    int n = 0;
    for (Step st{0, 0, chunk_len(p, g, 0)}; st.c < p.cin_g; st = next_step(p, g, st)) ++n;
    steps = steps < 0 || steps == n ? n : 0;
  }
  p.steps = steps;
  const long long tiles = (long long)p.ptiles * p.mtiles * groups;  // flat pixel tiles
  const long long slots = (long long)blocks * sms;
  p.span = steps > 0 && tiles > slots ? (int)((tiles * steps + slots - 1) / slots) : 0;
  return cudaSuccess;
}

// max_shared: ask for all of the unified L1 that shared memory may take, so
// that the two blocks the registers allow an SM also fit its shared memory
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool max_shared, size_t& opted) {
  if (smem <= opted) return cudaSuccess;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && max_shared)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) opted = smem;
  return e;
}

// The kernel of a configuration: MI warpgroup row tiles (bfloat16) or the
// FFMA tile of BN pixels.  T: the activation type; TX: T, or int8_t for the
// int8 table's codes.
template <int MI, int BN, typename T, typename TX, int CUT>
struct Kernel {
  static constexpr bool WG = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BM = WG ? WgmmaCfg<MI>::BM : FfmaCfg<BN>::BM;
  static constexpr size_t RING = WG ? WgmmaCfg<MI>::RING : FfmaCfg<BN>::RING;
  static_assert(!WG || BN == kBN, "the wgmma kernel's tile is kBN pixels");
  using Fn = void (*)(CUtensorMap, const TX*, const float*, const T*, const T*, const float*, T*,
                      Geo, int, int);
  static Fn fn() {
    if constexpr (WG) {
      return dcn_wgmma_kernel<MI, TX, CUT>;
    } else {
      return dcn_ffma_kernel<TX, BN, CUT>;
    }
  }
  // the ring, the corner table and each pixel's image
  static size_t smem(int taps) { return RING + kTableEntry * taps * BN + 4 * BN; }
  static cudaError_t prepare(int taps) {
    static size_t opted = 0;  // the dynamic shared memory opted into, per instantiation
    return opt_in(fn(), smem(taps), !WG, opted);
  }
  // ws: (blocks + 1) x 2 shares of BM x BN floats, cnt: blocks + 1 zeroed
  // counts (the wgmma kernel's stream-K schedule; may be null otherwise)
  static cudaError_t launch(const CUtensorMap& wmap, const void* x, const void* qscale,
                            const void* offset, const void* mask, const void* bias, void* out,
                            float* ws, size_t ws_bytes, int* cnt, int cnt_len,
                            int N, const Geo& p0, int vec_x, int vec_out, cudaStream_t stream) {
    cudaError_t e = prepare(p0.kh * p0.kw);
    if (e != cudaSuccess) return e;
    if ((long long)N * p0.Ho * p0.Wo >= (1LL << 31)) return cudaErrorInvalidValue;
    Geo p = p0;  // flat pixel tiles; one block a tile, or stream-K
    p.images = N;
    p.ptiles = (N * p.Ho * p.Wo + BN - 1) / BN;
    p.mtiles = (p.cout_g + BM - 1) / BM;
    p.ws = ws;
    p.cnt = cnt;
    e = schedule(p, blocks_per_sm(p.kh * p.kw));
    if (e != cudaSuccess) return e;
    const long long tiles = (long long)p.ptiles * p.mtiles * (p.Cout / p.cout_g);
    const long long blocks = p.span ? (tiles * p.steps + p.span - 1) / p.span : tiles;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks);
    if (p.span && (ws == nullptr || cnt == nullptr || cnt_len < blocks + 1 ||
                   ws_bytes < (size_t)(blocks + 1) * 2 * BM * BN * sizeof(float)))
      return cudaErrorInvalidValue;
    const size_t bytes = smem(p.kh * p.kw);
    if constexpr (WG) {
      dcn_wgmma_kernel<MI, TX, CUT><<<grid, kThreads, bytes, stream>>>(
          wmap, (const TX*)x, (const float*)qscale, (const T*)offset, (const T*)mask,
          (const float*)bias, (T*)out, p, vec_x, vec_out);
    } else {
      dcn_ffma_kernel<TX, BN, CUT><<<grid, kThreads, bytes, stream>>>(
          wmap, (const TX*)x, (const float*)qscale, (const T*)offset, (const T*)mask,
          (const float*)bias, (T*)out, p, vec_x, vec_out);
    }
    return cudaGetLastError();
  }
  // blocks that fit one SM at once, or -1 (kept for the last `taps` asked)
  static int blocks_per_sm(int taps) {
    static int kept_taps = -1, kept = -1;
    if (taps == kept_taps) return kept;
    int blocks = 0;
    if (prepare(taps) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn(), kThreads, smem(taps)) !=
            cudaSuccess)
      return -1;
    kept_taps = taps;
    kept = blocks;
    return blocks;
  }
};

// Calls F::template run<Kernel<...>>() for configuration `config` (the
// order of DCN_CONFIGS in ops/dcn.py) with int8 codes where q.
template <typename F, int CUT>
int with_config(int config, bool q, F&& f) {
  using bf16 = __nv_bfloat16;
#define DCN_CASE(ID, MI, BN, T, TX)                                                           \
  case ID:                                                                                    \
    return q ? f.template run<Kernel<MI, BN, T, int8_t, CUT>>()                              \
             : f.template run<Kernel<MI, BN, T, TX, CUT>>();
  switch (config) {
    DCN_CASE(0, 2, 128, bf16, bf16)
    DCN_CASE(1, 1, 128, bf16, bf16)
    DCN_CASE(2, 1, 128, float, float)
    DCN_CASE(3, 1, 64, float, float)
    default: return -1;
  }
#undef DCN_CASE
}

// The gather table of a map: channels last, [N, H*W, C], in the map's type
// (a transposed copy of an NCHW map) or as the int8 codes
// q = clamp(rint(x / s), -127, 127) with an IEEE division and round half to
// even, s = scale[n, c / ch_group] (bit for bit ops/dcn.py::quantize_dcn_table).
// x is contiguous NCHW ([N, C, HW]; 32 x 32 tiles through shared memory, so
// both the reads and the writes are coalesced) or, for the codes alone,
// NHWC (elementwise).  One pass: bound by its bytes.
template <typename T, typename TO>
__global__ void __launch_bounds__(256)
dcn_table_kernel(const T* __restrict__ x, const float* __restrict__ scale, TO* __restrict__ table,
                 int C, int HW, int nhwc, int ch_group) {
  constexpr bool Q = std::is_same<TO, int8_t>::value;
  const int n = blockIdx.z;
  const float* sn = Q ? scale + (long long)n * (C / ch_group) : nullptr;
  auto code = [&](float v, int c) -> TO {
    if constexpr (Q) {
      return (TO)fminf(fmaxf(rintf(__fdiv_rn(v, sn[c / ch_group])), -127.f), 127.f);
    } else if constexpr (std::is_same<TO, __nv_bfloat16>::value) {
      return __float2bfloat16(v);  // exact: v came from a bfloat16
    } else {
      return v;
    }
  };
  const long long base = (long long)n * C * HW;
  if (nhwc) {  // elementwise: a row of C channels per pixel
    const int per_image = C * HW;
    for (int i = blockIdx.x * 256 + threadIdx.x; i < per_image; i += gridDim.x * 256)
      table[base + i] = code(to_f(x[base + i]), i % C);
    return;
  }
  __shared__ float tile[32][33];
  const int c0 = blockIdx.y * 32, s0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;  // 32 x 8
#pragma unroll
  for (int r = 0; r < 32; r += 8) {  // read along pixels
    const int c = c0 + ty + r, s = s0 + tx;
    if (c < C && s < HW) tile[ty + r][tx] = to_f(x[base + (long long)c * HW + s]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 32; r += 8) {  // write along channels
    const int s = s0 + ty + r, c = c0 + tx;
    if (c < C && s < HW) table[base + (long long)s * C + c] = code(tile[tx][ty + r], c);
  }
}

// max |x| of each (image, channel) of a contiguous map, float32, exact:
// NCHW one block a channel row (its pixels contiguous, read 16 bytes at a
// time where they allow); NHWC a block a run of pixels of one image, a
// thread a channel, merged by an atomic max on the value's bits (amax
// zeroed first; non-negative floats order as their bits do).
template <typename T>
__global__ void __launch_bounds__(256)
dcn_amax_kernel(const T* __restrict__ x, float* __restrict__ amax, int C, int HW, int nhwc) {
  const int n = blockIdx.z;
  float m = 0.f;
  if (!nhwc) {
    const int c = blockIdx.x;
    const T* row = x + ((long long)n * C + c) * HW;
    constexpr int V = 16 / (int)sizeof(T);
    if (HW % V == 0 && (uintptr_t)row % 16 == 0) {
      for (int i = threadIdx.x; i < HW / V; i += 256) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + i);
#pragma unroll
        for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(element<T>(raw, e)));
      }
    } else {
      for (int i = threadIdx.x; i < HW; i += 256) m = fmaxf(m, fabsf(to_f(row[i])));
    }
    __shared__ float part[8];
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < 8; ++w) m = fmaxf(m, part[w]);
      amax[n * C + c] = m;
    }
    return;
  }
  const int rows = (HW + gridDim.x - 1) / gridDim.x, s0 = blockIdx.x * rows;
  const T* xn = x + (long long)n * HW * C;
  for (int c = threadIdx.x; c < C; c += 256) {
    float mc = 0.f;
    for (int s = s0; s < min(s0 + rows, HW); ++s) mc = fmaxf(mc, fabsf(to_f(xn[(long long)s * C + c])));
    atomicMax(reinterpret_cast<int*>(amax) + n * C + c, __float_as_int(mc));
  }
}

template <typename T, typename TO>
cudaError_t launch_table(const void* x, const void* scale, void* table, int N, int C, int HW,
                         int nhwc, int ch_group, cudaStream_t stream) {
  const dim3 grid = nhwc ? dim3(1024, 1, (unsigned)N)
                         : dim3((unsigned)((HW + 31) / 32), (unsigned)((C + 31) / 32), (unsigned)N);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  dcn_table_kernel<T, TO><<<grid, 256, 0, stream>>>((const T*)x, (const float*)scale, (TO*)table,
                                                    C, HW, nhwc, ch_group);
  return cudaGetLastError();
}

// what with_config runs on the kernel of a configuration
struct Launch {
  const CUtensorMap& wmap;
  const void *x, *qscale, *offset, *mask, *bias;
  void* out;
  float* ws;
  size_t ws_bytes;
  int* cnt;
  int cnt_len;
  int N;
  const Geo& p;
  int vec_x, vec_out;
  cudaStream_t stream;
  template <typename K>
  int run() {
    return (int)K::launch(wmap, x, qscale, offset, mask, bias, out, ws, ws_bytes, cnt, cnt_len, N,
                          p, vec_x, vec_out, stream);
  }
};
struct Blocks {
  int taps;
  template <typename K>
  int run() {
    return K::blocks_per_sm(taps);
  }
};

}  // namespace

extern "C" {

// offset, mask and out of one dtype (0 = float32, 1 = bfloat16), read and
// written through the given strides (in elements).  x is the gather table:
// channels last (stride 1 between channels), the map itself or, with
// qscale (float32 [N, Cin / ch_group]), its int8 codes.  wmat is the
// weight matrix in the activation dtype, contiguous, K = (tap, channel of
// the conv group) padded to Kp, a multiple of 64: bfloat16 [Cout, Kp]
// (wld = Kp), row o holding conv group o / (Cout / groups)'s weights;
// float32 its transpose [Kp, wld], wld >= Cout a multiple of 4.  bias
// float32 [Cout] or null.  config indexes DCN_CONFIGS of ops/dcn.py (0 and 1
// bfloat16, 2 and 3 float32); vec_x: every 16-byte piece of a step's
// channels is one aligned load of the table; vec_out: the output's
// contiguous axis takes 16-byte stores; ws (float32, ws_bytes) and cnt
// (cnt_len int32, zero, and left zero) the stream-K workspace (see
// finish_share): at least (blocks an SM x SMs + 1) x 2 x BM x BN floats
// and as many counts, where the tiles outnumber the blocks the card holds
// (else they may be null); cut 0 (1 and 2 in dcn_fused_split.cu, see CUT).
// The table is below 2^31 elements.
int dcn_fused_forward(const void* x, const void* qscale, const void* offset, const void* mask,
                      const void* wmat, const void* bias, void* out, int N, int Cin, int H,
                      int W, int Ho, int Wo, int kh, int kw, int stride, int pad, int dil,
                      int dg, int groups, int Cout, int Kp, int wld, int ch_group,
                      long long xs_n,
                      long long xs_c, long long xs_y, long long xs_x, long long os_n,
                      long long os_c, long long os_s, long long ms_n, long long ms_c,
                      long long ms_s, long long ys_n, long long ys_c, long long ys_s,
                      void* ws, long long ws_bytes, void* cnt, int cnt_len,
                      int dtype, int config, int vec_x, int vec_out, int cut, void* stream) {
  if (N < 1 || Cin < 1 || Cout < 1 || dg < 1 || groups < 1 || Cin % dg || Cin % groups ||
      Cout % groups || Ho < 1 || Wo < 1 || kh < 1 || kw < 1 || Kp % 64 ||
      Kp < kh * kw * (Cin / groups) || (uintptr_t)wmat % 16 || xs_c != 1 ||
      (long long)N * xs_n >= (1LL << 31) ||
      (qscale != nullptr && (ch_group < 1 || Cin % ch_group || ch_group % 32)))
    return (int)cudaErrorInvalidValue;
  if ((dtype == 1) != (config == 0 || config == 1) || (dtype == 0) != (config >= 2) ||
      (dtype == 1 ? wld != Kp : (wld < Cout || wld % 4)))
    return (int)cudaErrorInvalidValue;
  // a step's 128 bytes of channels; for the K-major bfloat16 tile one
  // 16-byte piece fewer where a group or deform group does not start on 16
  // bytes (its steps' weights start short of it, see Step); the float32
  // tile's K is its outer axis, which TMA starts anywhere
  const int ka = dtype == 1 ? 8 : 1;
  const int kcap = dtype == 1 ? 64 - ((Cin / groups) % ka || (Cin / dg) % ka ? ka - 1 : 0) : 32;
  const Geo p = {Cin,  H,    W,    Ho,   Wo,   kh,   kw,   stride, pad,  dil,  dg,   Cout,
                 Cin / groups,   Cout / groups,   Cin / dg,     ch_group,   ka,   kcap,
                 xs_n, xs_c, xs_y, xs_x, os_n, os_c, os_s, ms_n,   ms_c, ms_s, ys_n, ys_c, ys_s,
                 0,    0,    0,    0,    0,    nullptr, nullptr};
  CUtensorMap wmap;
  const bool mapped =
      dtype == 1 ? hopper::encode_sw128_map(&wmap, wmat, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Cout,
                                            Kp, Kp, config == 0 ? 256 : 128)
                 : hopper::encode_box_map(&wmap, wmat, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, Kp,
                                          Cout, wld, 128, 32);
  if (!mapped) return (int)cudaErrorInvalidValue;
  Launch launch{wmap,      x,    qscale,           offset,    mask,    bias, out, (float*)ws,
                (size_t)ws_bytes, (int*)cnt, cnt_len, N,    p,    vec_x, vec_out, (cudaStream_t)stream};
  const bool q = qscale != nullptr;
  int err = -1;
#ifdef DCN_SPLIT
  if (cut == 1) err = with_config<Launch&, 1>(config, q, launch);
  if (cut == 2) err = with_config<Launch&, 2>(config, q, launch);
#else
  if (cut == 0) err = with_config<Launch&, 0>(config, q, launch);
#endif
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

#ifndef DCN_SPLIT
// Blocks of configuration `config` (int8 codes where q) that fit one SM at
// once for a kernel of `taps` taps, or -1.
int dcn_fused_blocks_per_sm(int config, int q, int taps) {
  Blocks blocks{taps};
  return with_config<Blocks&, 0>(config, q != 0, blocks);
}
#endif

// The gather table of a contiguous map x (dtype 0 = float32, 1 = bfloat16;
// NCHW, or NHWC with nhwc = 1) into `table` [N, H*W, C]: x's type when scale
// is null (NCHW only), else the int8 codes under scale [N, C / ch_group]
// float32.
int dcn_gather_table(const void* x, const void* scale, void* table, int N, int C, int H, int W,
                     int nhwc, int ch_group, int dtype, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || (long long)C * H * W >= (1LL << 31) ||
      (scale != nullptr && (ch_group < 1 || C % ch_group)) || (scale == nullptr && nhwc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  if (dtype == 0)
    return (int)(scale ? launch_table<float, int8_t>(x, scale, table, N, C, HW, nhwc, ch_group, st)
                       : launch_table<float, float>(x, scale, table, N, C, HW, nhwc, ch_group, st));
  if (dtype == 1)
    return (int)(scale ? launch_table<__nv_bfloat16, int8_t>(x, scale, table, N, C, HW, nhwc,
                                                             ch_group, st)
                       : launch_table<__nv_bfloat16, __nv_bfloat16>(x, scale, table, N, C, HW,
                                                                    nhwc, ch_group, st));
  return (int)cudaErrorInvalidValue;
}

// max |x| of each (image, channel) of a contiguous map x (dtype 0 = float32,
// 1 = bfloat16; NCHW, or NHWC with nhwc = 1) into amax [N, C] float32.
int dcn_channel_amax(const void* x, void* amax, int N, int C, int H, int W, int nhwc, int dtype,
                     void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || N > 65535 || (dtype != 0 && dtype != 1) ||
      (!nhwc && C > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  if (nhwc) {
    const cudaError_t e = cudaMemsetAsync(amax, 0, (size_t)N * C * sizeof(float), st);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nhwc ? (unsigned)min(HW, 64) : (unsigned)C, 1, (unsigned)N);
  if (dtype == 0)
    dcn_amax_kernel<float><<<grid, 256, 0, st>>>((const float*)x, (float*)amax, C, HW, nhwc);
  else
    dcn_amax_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>((const __nv_bfloat16*)x, (float*)amax,
                                                         C, HW, nhwc);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
