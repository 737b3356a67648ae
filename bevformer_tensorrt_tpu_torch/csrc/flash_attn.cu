// Flash attention, forward, on Hopper's tensor cores (sm_90a, mma.sync).
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/flash_attn.py::flash_attention
// and computes ops/attention.py::qkv_plain: softmax(q k^T / sqrt(d)) v per
// (batch, head), with an online softmax whose running max, denominator and
// accumulator are float32.  Keys past Lk are masked to -inf, so any length
// works.  q, k, v are read where they lie: [bs, L, heads * d] with a row
// stride, head h at column h * d ([B, L, d] is heads = 1), and the output is
// written merged the same way, so splitting and merging heads costs no copy.
//
// Bound on this card, at the decoder's shape (8 heads, 900 queries and
// keys, d 32): 4 * 8 * 900 * 900 * 32 = 0.83 GFLOP of products and 6.5 M
// exponentials.  bfloat16: 0.84 us of tensor-core time at 989 TFLOP/s, the
// exponentials ~1.8 us at 16 a clock per SM, 1.8 MB of traffic 0.55 us: the
// special-function unit bounds it.  float32 as split TF32 (three products a
// product) 2.49 GFLOP at 495 TFLOP/s = 5.0 us: the tensor cores bound it.
//
// Design.  A row group of four warps owns 16 query rows; each of its warps
// keeps the rows' q fragments in registers and takes a quarter (16 keys) of
// every 64-key K / V tile, with its own online softmax, and the group's
// first warp merges the four at the end (rescaled to the largest max).  The
// block's row groups share the tiles, staged in shared memory by cp.async
// and double-buffered (one barrier a tile).  Logits, the row max and the row
// sums stay in registers (the row's four lanes, one quad, reduce them with
// two shuffles).  The split of the keys puts four times the warps on the
// card that 16 rows a warp alone would (1856 against 464 at the decoder),
// so one warp's waits on the tensor cores, the exponentials and its loads
// hide behind the others'.  The launch geometry (row groups a block, grid,
// shared memory) comes from ops/attention.py::flash_launch_geometry, which
// the CPU tests hold: as many row groups a block as still leave >= 132
// blocks, so no SM idles at the decoder shape (2 row groups, 232 blocks of
// 8 warps).
//  - bfloat16: q k^T on mma.m16n8k16 bf16 -> f32 (products of two bfloat16
//    are exact in float32).  The accumulator fragment of q k^T is exactly
//    the A fragment of the P.V product, so P needs no shuffle; it enters as
//    two bfloat16 terms, hi = bf16(p) and lo = bf16(p - hi), which keep P to
//    ~2^-17 where one term (FlashAttention-2's choice) would change the
//    function by 2^-9 a probability.  V's B fragments come from ldmatrix
//    .trans.  The k-depth is a permutation of d (lane t reads d 4t..4t+3,
//    one 64-bit load for both B registers); d = 8 pads the depth to 16
//    with zeros.
//  - float32: split TF32 ("3xTF32"): x = big + small, big = x cut to TF32,
//    small = rna(x - big) (mma_sync.cuh::tf32_split), and big.big +
//    big.small + small.big on mma.m16n8k8 tf32, for both products (one TF32
//    term would miss the 1e-5 bar by far; the split holds ~2e-6).  The
//    accumulator's columns (2t, 2t+1) are not the A fragment's (t, t+4);
//    since the sum over keys may run in any order, logical column t of each
//    8-key step is key 2t and t + 4 is key 2t + 1, and V's B fragment reads
//    rows 2t and 2t + 1 to match.  q k^T permutes d the same way (one
//    64-bit load for both registers).
// The softmax runs on the unscaled logits: 2^(s c - m c) as one FFMA and one
// ex2.approx, and only a warp whose keys reach past Lk masks them.  Row
// strides of the K and V tiles are padded so that every fragment load is
// free of bank conflicts.  The kernel allocates nothing and launches on the
// caller's stream.
//
// What binds is not the products or the exponentials alone: cutting any
// one part of the kernel away saves little.  The time is spread over the
// fixed cost (launch, q, merge, stores), the per-tile bookkeeping (barrier,
// copies issued, maxima, shuffles, rescaling, the hi / lo split), the K / V
// tiles each of a head's 29 blocks reads again from L2 and, in float32, the
// 48 TF32 products a warp takes a tile with their splits (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockK = 64;                 // keys a tile
constexpr int kStages = 2;                  // tiles staged: one in use, one in flight
constexpr int kRows = 16;                   // query rows a warp
constexpr int kSplits = 4;                  // warps a row group: each takes 16 keys of a tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D> struct Tile;
// float32: K rows padded to a stride of 8 words mod 32 (64-bit fragment
// loads), V rows to 4 mod 8 words (32-bit loads of rows 2t and 2t + 1)
template <int D> struct Tile<float, D> {
  static constexpr int KS = D == 8 ? 8 : D + 8;
  static constexpr int VS = D + 4;
  static constexpr int KSTEPS = D / 8;
};
// bfloat16: the depth padded to 16; K rows at 8 words mod 32 (64-bit
// loads), V rows at 4 mod 8 words (conflict-free ldmatrix)
template <int D> struct Tile<__nv_bfloat16, D> {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int KS = 2 * ((DP / 2) % 32 == 8 ? DP / 2 : DP / 2 + 8);
  static constexpr int VS = 2 * ((D / 2) % 8 == 4 ? D / 2 : D / 2 + 4);
  static constexpr int KSTEPS = DP / 16;
};

// the larger of the stages of K / V tiles and the end's merge of the
// splits (per warp and lane: m, l of two rows and the D / 2 accumulators)
template <typename T, int D, int W, int S>
constexpr int smem_bytes() {
  constexpr int tiles = kStages * kBlockK * (Tile<T, D>::KS + Tile<T, D>::VS) * (int)sizeof(T);
  constexpr int merge = W * S * 32 * (4 + D / 2) * 4;
  return tiles > merge ? tiles : merge;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 2^x on the special-function unit (relative error ~2^-22; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D, int W, int S>
__global__ void __launch_bounds__(32 * W * S)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int heads, int Lq, int Lk, long long q_rs, long long k_rs,
             long long v_rs, long long o_rs, float scale_log2) {
  using TT = Tile<T, D>;
  constexpr int KS = TT::KS, VS = TT::VS, KSTEPS = TT::KSTEPS;
  constexpr int NT = 32 * W * S;
  constexpr int NK = kBlockK / S;           // keys of a tile this warp takes
  constexpr int NKT = NK / 8;
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;  // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);             // [kStages][kBlockK][KS]
  T* vs = ks + kStages * kBlockK * KS;                // [kStages][kBlockK][VS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp / S, sw = warp % S;   // row group; split of the keys
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const T* qb = q + (long long)b * Lq * q_rs + (long long)h * D;
  const T* kb = k + (long long)b * Lk * k_rs + (long long)h * D;
  const T* vb = v + (long long)b * Lk * v_rs + (long long)h * D;
  const int r0 = blockIdx.x * (kRows * W) + rw * kRows + g;  // rows r0 and r0 + 8

  if constexpr (sizeof(T) == 2 && D < 16) {  // the zero half of the padded depth
    for (int i = tid; i < kStages * kBlockK; i += NT)
      for (int c = D; c < KS; ++c) ks[i * KS + c] = __float2bfloat16(0.f);
  }

  // a thread's 16-byte pieces of a tile sit at the same rows and columns in
  // every tile: a fixed trip count, no division in the loop
  constexpr int EPC = 16 / (int)sizeof(T);            // elements a piece
  constexpr int PIECES = kBlockK * CHUNKS, ITERS = (PIECES + NT - 1) / NT;
  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * kBlockK;
    const T* kg = kb + (long long)k0 * k_rs;
    const T* vg = vb + (long long)k0 * v_rs;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int e = tid + it * NT;
      if (PIECES % NT != 0 && e >= PIECES) break;
      const int j = e / CHUNKS, c = e % CHUNKS;
      const bool in = k0 + j < Lk;
      mma::cp_async16(ks + (stage * kBlockK + j) * KS + c * EPC,
                      in ? kg + j * k_rs + c * EPC : kb, in);
      mma::cp_async16(vs + (stage * kBlockK + j) * VS + c * EPC,
                      in ? vg + j * v_rs + c * EPC : vb, in);
    }
  };

  // q's A fragments (see mma_sync.cuh), d permuted as the header says
  uint32_t qa[KSTEPS][4], qs[KSTEPS][4];  // qs: the small TF32 terms (float32 only)
  {
    const bool in0 = r0 < Lq, in1 = r0 + 8 < Lq;
    const T* q0 = qb + (long long)(in0 ? r0 : 0) * q_rs;
    const T* q1 = qb + (long long)(in1 ? r0 + 8 : 0) * q_rs;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if constexpr (sizeof(T) == 4) {
        const int c = kk * 8 + 2 * t;
        const float x[4] = {in0 ? to_f(q0[c]) : 0.f, in1 ? to_f(q1[c]) : 0.f,
                            in0 ? to_f(q0[c + 1]) : 0.f, in1 ? to_f(q1[c + 1]) : 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) mma::tf32_split(x[i], qa[kk][i], qs[kk][i]);
      } else {
        const int c = kk * 16 + 4 * t;
        auto at = [&](const T* p, bool in, int col) {
          return in && col < D ? to_f(p[col]) : 0.f;
        };
        qa[kk][0] = pack_bf16(at(q0, in0, c), at(q0, in0, c + 1));
        qa[kk][1] = pack_bf16(at(q1, in1, c), at(q1, in1, c + 1));
        qa[kk][2] = pack_bf16(at(q0, in0, c + 2), at(q0, in0, c + 3));
        qa[kk][3] = pack_bf16(at(q1, in1, c + 2), at(q1, in1, c + 3));
      }
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r0, r0 + 8

  const int ntiles = (Lk + kBlockK - 1) / kBlockK;
  // kStages - 1 tiles in flight ahead of the one in use; a group is
  // committed every step (empty past the end) so the wait counts stay fixed
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load_tile(i, i);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    const int stage = kt % kStages;
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + kStages - 1 < ntiles) load_tile(kt + kStages - 1, (kt + kStages - 1) % kStages);
    mma::cp_async_commit();
    const T* kt_s = ks + (stage * kBlockK + sw * NK) * KS;  // this warp's NK keys
    const T* vt_s = vs + (stage * kBlockK + sw * NK) * VS;

    // s = q k^T for this warp's keys: NKT tiles of 8
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if constexpr (sizeof(T) == 4) {
          const float2 kv = *reinterpret_cast<const float2*>(kt_s + (n * 8 + g) * KS + kk * 8 + 2 * t);
          uint32_t b0, b1, c0, c1;
          mma::tf32_split(kv.x, b0, c0);
          mma::tf32_split(kv.y, b1, c1);
          mma::mma_tf32(s[n], qs[kk], b0, b1);  // small terms first
          mma::mma_tf32(s[n], qa[kk], c0, c1);
          mma::mma_tf32(s[n], qa[kk], b0, b1);
        } else {
          const uint2 kv = *reinterpret_cast<const uint2*>(kt_s + (n * 8 + g) * KS + kk * 16 + 4 * t);
          mma::mma_bf16(s[n], qa[kk], kv.x, kv.y);
        }
      }
    }

    // online softmax on the unscaled logits (max(s) * c = max(s * c) for
    // c > 0): mask the tile that reaches past Lk, row max over the quad,
    // p = 2^(s c - m c) as one FFMA and one ex2
    const int k0 = kt * kBlockK + sw * NK;
    if (k0 + NK > Lk) {
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + n * 8 + 2 * t + (i & 1) >= Lk) s[n][i] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // a split that has seen no key yet keeps m = -inf, l = o = 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float rf0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
    const float rf1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
    const float a0 = ex2(fmaf(m0, scale_log2, -rf0)), a1 = ex2(fmaf(m1, scale_log2, -rf1));
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      s[n][0] = ex2(fmaf(s[n][0], scale_log2, -rf0));
      s[n][1] = ex2(fmaf(s[n][1], scale_log2, -rf0));
      s[n][2] = ex2(fmaf(s[n][2], scale_log2, -rf1));
      s[n][3] = ex2(fmaf(s[n][3], scale_log2, -rf1));
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // o += p v
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < NKT; ++j) {  // 8 keys a step: logical t = key 2t, t + 4 = key 2t + 1
        uint32_t pb[4], psm[4];
        mma::tf32_split(s[j][0], pb[0], psm[0]);
        mma::tf32_split(s[j][2], pb[1], psm[1]);
        mma::tf32_split(s[j][1], pb[2], psm[2]);
        mma::tf32_split(s[j][3], pb[3], psm[3]);
        const T* v0 = vt_s + (j * 8 + 2 * t) * VS + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1, c0, c1;
          mma::tf32_split(to_f(v0[n * 8]), b0, c0);
          mma::tf32_split(to_f(v0[VS + n * 8]), b1, c1);
          mma::mma_tf32(o[n], psm, b0, b1);
          mma::mma_tf32(o[n], pb, c0, c1);
          mma::mma_tf32(o[n], pb, b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NKT / 2; ++j) {  // 16 keys a step: tiles 2j and 2j + 1 of s
        uint32_t ph[4], pl[4];
        const float p[4][2] = {{s[2 * j][0], s[2 * j][1]}, {s[2 * j][2], s[2 * j][3]},
                               {s[2 * j + 1][0], s[2 * j + 1][1]},
                               {s[2 * j + 1][2], s[2 * j + 1][3]}};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p[i][0], p[i][1]);
          ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[i] = pack_bf16(p[i][0] - __low2float(hi), p[i][1] - __high2float(hi));
        }
        const int mat = lane >> 3, r = lane & 7;
        if constexpr (D == 8) {
          uint32_t b0, b1;
          mma::ldmatrix_x2_trans(b0, b1, vt_s + (j * 16 + (mat & 1) * 8 + r) * VS);
          mma::mma_bf16(o[0], pl, b0, b1);
          mma::mma_bf16(o[0], ph, b0, b1);
        } else {
#pragma unroll
          for (int n = 0; n < D / 8; n += 2) {
            uint32_t b0, b1, b2, b3;
            mma::ldmatrix_x4_trans(b0, b1, b2, b3,
                                   vt_s + (j * 16 + (mat & 1) * 8 + r) * VS + (n + (mat >> 1)) * 8);
            mma::mma_bf16(o[n], pl, b0, b1);
            mma::mma_bf16(o[n], ph, b0, b1);
            mma::mma_bf16(o[n + 1], pl, b2, b3);
            mma::mma_bf16(o[n + 1], ph, b2, b3);
          }
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the merge below reuses the tiles' shared memory

  // merge the S splits of each row group into its first warp (same lane,
  // same rows and columns): rescale each to the largest max, then add
  float* xs = reinterpret_cast<float*>(smem_raw) + ((rw * S + sw) * 32 + lane) * (4 + D / 2);
  if (sw > 0) {
    xs[0] = m0; xs[1] = m1; xs[2] = l0; xs[3] = l1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[4 + 4 * n + i] = o[n][i];
  }
  __syncthreads();
  if (sw > 0) return;
  float M0 = m0, M1 = m1;
#pragma unroll
  for (int j = 1; j < S; ++j) {
    const float* xj = xs + j * 32 * (4 + D / 2);
    M0 = fmaxf(M0, xj[0]);
    M1 = fmaxf(M1, xj[1]);
  }
  {
    // M finite: split 0 holds key 0
    const float f0 = ex2((m0 - M0) * scale_log2), f1 = ex2((m1 - M1) * scale_log2);
    l0 *= f0;
    l1 *= f1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= f0; o[n][1] *= f0; o[n][2] *= f1; o[n][3] *= f1;
    }
  }
#pragma unroll
  for (int j = 1; j < S; ++j) {
    const float* xj = xs + j * 32 * (4 + D / 2);
    const float f0 = ex2((xj[0] - M0) * scale_log2), f1 = ex2((xj[1] - M1) * scale_log2);
    l0 += xj[2] * f0;
    l1 += xj[3] * f1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] += xj[4 + 4 * n] * f0;
      o[n][1] += xj[5 + 4 * n] * f0;
      o[n][2] += xj[6 + 4 * n] * f1;
      o[n][3] += xj[7 + 4 * n] * f1;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  T* ob = out + (long long)b * Lq * o_rs + (long long)h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < Lq) store2(ob + (long long)r0 * o_rs + n * 8, o[n][0] * inv0, o[n][1] * inv0);
    if (r0 + 8 < Lq)
      store2(ob + (long long)(r0 + 8) * o_rs + n * 8, o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <typename T, int D, int W>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* out, int B, int heads,
                       int Lq, int Lk, long long q_rs, long long k_rs, long long v_rs,
                       long long o_rs, int grid_x, int smem, cudaStream_t stream) {
  constexpr int need = smem_bytes<T, D, W, kSplits>();
  if (smem != need) return cudaErrorInvalidValue;  // the Python geometry and this file disagree
  auto kernel = flash_kernel<T, D, W, kSplits>;
  if (need > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = kLog2e / sqrtf((float)D);
  kernel<<<dim3(grid_x, B * heads), 32 * W * kSplits, need, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, heads, Lq, Lk, q_rs, k_rs, v_rs, o_rs,
      scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(int warps, const void* q, const void* k, const void* v, void* out, int B,
                     int heads, int Lq, int Lk, long long q_rs, long long k_rs, long long v_rs,
                     long long o_rs, int grid_x, int smem, cudaStream_t st) {
  switch (warps) {
    case 1: return launch_one<T, D, 1>(q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs, v_rs, o_rs,
                                       grid_x, smem, st);
    case 2: return launch_one<T, D, 2>(q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs, v_rs, o_rs,
                                       grid_x, smem, st);
    case 4: return launch_one<T, D, 4>(q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs, v_rs, o_rs,
                                       grid_x, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(int D, int warps, const void* q, const void* k, const void* v, void* out,
                   int B, int heads, int Lq, int Lk, long long q_rs, long long k_rs,
                   long long v_rs, long long o_rs, int grid_x, int smem, cudaStream_t st) {
  switch (D) {
    case 8: return launch_d<T, 8>(warps, q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs, v_rs, o_rs,
                                  grid_x, smem, st);
    case 32: return launch_d<T, 32>(warps, q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs, v_rs,
                                    o_rs, grid_x, smem, st);
    case 64: return launch_d<T, 64>(warps, q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs, v_rs,
                                    o_rs, grid_x, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, Lq, heads * D], k / v [B, Lk, heads * D], out [B, Lq, heads * D],
// rows `*_rs` elements apart, head h at column h * D; dtype 0 = float32,
// 1 = bfloat16; warps (row groups), splits, grid_x and smem from
// flash_launch_geometry.
int flash_attn_forward(const void* q, const void* k, const void* v, void* out, int B, int heads,
                       int Lq, int Lk, int D, long long q_rs, long long k_rs, long long v_rs,
                       long long o_rs, int dtype, int warps, int splits, int grid_x, int smem,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (splits != kSplits) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(D, warps, q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs, v_rs, o_rs,
                              grid_x, smem, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(D, warps, q, k, v, out, B, heads, Lq, Lk, q_rs, k_rs,
                                      v_rs, o_rs, grid_x, smem, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
