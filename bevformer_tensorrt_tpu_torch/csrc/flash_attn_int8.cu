// int8 flash attention, forward, on Hopper's tensor cores (sm_90a,
// mma.sync s8), with its quantization: three launches an op.
//
// Replaces the TPU kernel
//   bevformer_tensorrt_tpu/ops/pallas/flash_attn.py::flash_attention_int8
//   (body _flash_kernel_int8, quantization q8 at :134-143)
// and computes ops/attention.py::flash_attention_int8_plain bit for bit up
// to expf's last bit and the order of the row sums:
//   s_q   = max(amax(q), 1e-12) / 127 (and s_k, s_v),  q8 = clamp(rint(q / s_q), +-127)
//   scale_qk = s_q * s_k / sqrt(d),  scale_pv = s_v / 127   (IEEE divisions)
// and per block of 256 keys (the contract: p8 is rounded against the
// running max after the whole block, so the blocks of a query row run in
// order and the kv axis is never split across CUDA blocks):
//   s     = float(int32 q8 . k8) * scale_qk        (keys past the end: -1e30)
//   m_new = max(m, max over the block of s)
//   p     = exp(s - m_new);  l = l * exp(m - m_new) + sum p
//   p8    = rint(p * 127)                          (halves to even)
//   acc   = acc * exp(m - m_new) + float(int32 p8 . v8) * scale_pv
// and out = acc / max(l, 1e-30).  The integer sums are exact, so the order
// of the keys inside a block does not change them.
//
// Bound on this card, at the decoder's shape (8 heads, 900 queries and
// keys, d 32): q, k, v read once (float32 2.8 MB) and the output written
// (0.9 MB) take 1.1 us; the 0.83 GOP of int8 products 0.42 us at 1979
// TOP/s; the 6.5 M exponentials ~1.8 us at 16 a clock per SM.
//
// Launches:
//  1. flash_int8_amax: |x| of q, k and v in one grid (blockIdx.y picks the
//     tensor); |x| >= 0 orders like its unsigned bits, so atomicMax on them
//     gives the three maxima exactly and in any order.  Slots alternate
//     between calls: the launch resets the slot the next call uses (stream
//     order guarantees that slot's readers are done), so no memset runs.
//  2. flash_int8_quantize: the codes, written head-split as [B * heads, L,
//     d] int8, and the two scales.  A separate pass, not quantization inside
//     the attention kernel's tile loads: every one of a head's 29 query
//     blocks would divide all of that head's k and v again (an IEEE division
//     is ~10 instructions), 29 times the divisions of one pass.
//  3. flash_int8_kernel: a row group of four warps owns 16 query rows (A
//     fragments of q8 in registers); each of its warps takes 64 keys of
//     every 256-key block of k8 and v8, staged by cp.async and
//     double-buffered and shared by the block's row groups.  A warp's 16 x
//     64 int32 logits (mma.m16n8k32 s8) stay in registers (32 a thread;
//     one warp holding all 256 keys would need 128 and compute q8 k8^T
//     twice).  The four warps' row maxima meet in shared memory (an int32
//     max: float(dot) * scale_qk is monotone in dot), each forms p, p8 and
//     its int32 p8 . v8, and the group's first warp adds the four int32
//     sums (exact, so the order of the keys inside a block does not matter)
//     and the row sums (in split order) and updates m, l and acc.  p8 is
//     packed from the accumulator fragment straight into the A fragment of
//     the P.V product: logical k 4t..4t+3 of a 16-key half is keys 2t, 2t+1,
//     8+2t, 9+2t, and v8 is stored transposed as [d][keys] in shared memory
//     with its keys permuted to match (a 4x4 byte transpose, __byte_perm).
//     Only a warp whose keys reach past Lk masks them (-1e30).
//     int32 <-> float conversions of values below 2^22 go through the
//     mantissa of 1.5 * 2^23 (exact, on the integer and FMA pipes), leaving
//     the conversion unit to the exponentials.
//  The geometry of 3 (row groups a block, grid, shared memory) comes from
//  ops/attention.py::flash_launch_geometry.  None allocates; all run on the
//  caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockK = 256;                // keys per requantization block (the contract)
constexpr int kRows = 16;                   // query rows a warp
constexpr int kSplits = 4;                  // warps a row group: 64 keys of a block each
constexpr int kVTS = kBlockK + 16;          // bytes a row of the transposed v block
constexpr float kNegInf = -1e30f;
constexpr int kPrepThreads = 256;
constexpr int kPrepBlocks = 1024;           // blocks a tensor, at most, for launches 1 and 2

// two stages of k rows (padded) and v rows, v transposed, the splits' row
// maxima and their hand-over of P.V sums and row sums
template <int D, int W, int S>
constexpr int smem_bytes() {
  return 2 * kBlockK * ((D + 16) + D) + D * kVTS + W * S * 16 * 4 + W * S * 32 * (D / 2 + 2) * 4;
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(a); x[1] = __high2float(a); x[2] = __low2float(b); x[3] = __high2float(b);
}

template <typename T>
__device__ __forceinline__ const T* pick(const T* q, const T* k, const T* v, int y) {
  return y == 0 ? q : y == 1 ? k : v;
}

// 1. the three amaxes, into slot `slot` of buf [2][4]; resets the other slot
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
flash_int8_amax(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                long long nq, long long nkv, unsigned* __restrict__ buf, int slot) {
  const int y = blockIdx.y;
  if (blockIdx.x == 0 && y == 0 && threadIdx.x < 4) buf[(slot ^ 1) * 4 + threadIdx.x] = 0u;
  const T* x = pick(q, k, v, y);
  const int n4 = (int)((y == 0 ? nq : nkv) / 4);
  float m = 0.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float e[4];
    load4(x + 4 * i, e);
#pragma unroll
    for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(e[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  __shared__ float wmax[kPrepThreads / 32];
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {  // one atomic a block: those on one address serialize
#pragma unroll
    for (int w = 1; w < kPrepThreads / 32; ++w) m = fmaxf(m, wmax[w]);
    atomicMax(buf + slot * 4 + y, __float_as_uint(m));
  }
}

__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits), 1e-12f), 127.f);
}

// 2. codes [B * heads, L, d] from x [B, L, heads * d], and the scales
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
flash_int8_quantize(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    int8_t* __restrict__ q8, int8_t* __restrict__ k8, int8_t* __restrict__ v8,
                    int Lq, int Lk, int heads, int d, long long nq, long long nkv,
                    const unsigned* __restrict__ buf, int slot, float root_d,
                    float* __restrict__ scales) {
  const int y = blockIdx.y;
  const unsigned* amax = buf + slot * 4;
  if (blockIdx.x == 0 && y == 0 && threadIdx.x == 0) {
    const float sq = scale_of(amax[0]), sk = scale_of(amax[1]), sv = scale_of(amax[2]);
    scales[0] = __fdiv_rn(__fmul_rn(sq, sk), root_d);
    scales[1] = __fdiv_rn(sv, 127.f);
  }
  const T* x = pick(q, k, v, y);
  int8_t* out = y == 0 ? q8 : y == 1 ? k8 : v8;
  const int L = y == 0 ? Lq : Lk;
  const int n4 = (int)((y == 0 ? nq : nkv) / 4);
  const float s = scale_of(amax[y]);
  const int E4 = heads * d / 4, d4 = d / 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float e[4];
    load4(x + 4 * i, e);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(e[j], s)), -127.f), 127.f);
      word |= (uint32_t)(uint8_t)(int8_t)(int)r << (8 * j);
    }
    const int row = i / E4, col4 = i - row * E4;  // row b * L + l, column h * d + c
    const int b = row / L, l = row - b * L;
    const int h = col4 / d4, c4 = col4 - h * d4;
    reinterpret_cast<uint32_t*>(out)[((b * heads + h) * L + l) * d4 + c4] = word;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// exact conversions on the integer and FMA pipes instead of the conversion
// unit (16 a clock per SM, shared with the exponentials): an integer of
// magnitude below 2^22 sits in the low mantissa bits of 1.5 * 2^23
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;
__device__ __forceinline__ float int_to_f(int x) {  // |x| < 2^22
  return __fsub_rn(__int_as_float(x + kMagicBits), kMagic);
}
__device__ __forceinline__ uint32_t rint_byte(float x) {  // rint(x) for 0 <= x < 2^22, low byte
  return (uint32_t)(__float_as_int(__fadd_rn(x, kMagic)) - kMagicBits) & 0xffu;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 3. the attention: q8 [B * heads, Lq, D], k8 / v8 [B * heads, Lk, D] int8,
// out [B, Lq, heads * D] with rows o_rs elements apart
template <typename T, int D, int W, int S>
__global__ void __launch_bounds__(32 * W * S)
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ v, const float* __restrict__ scales,
                  T* __restrict__ out, int heads, int Lq, int Lk, long long o_rs) {
  constexpr int KS = D + 16;                // bytes a staged k row (conflict-free fragments)
  constexpr int NT = 32 * W * S;
  constexpr int KSTEPS = D / 32;
  constexpr int NK = kBlockK / S;           // keys of a block this warp takes
  constexpr int NKT = NK / 8;
  constexpr int XW = D / 2 + 2;             // words a lane hands over: P.V sums, two row sums
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* ks = reinterpret_cast<int8_t*>(smem_raw);   // [2][kBlockK][KS]
  int8_t* vr = ks + 2 * kBlockK * KS;                  // [2][kBlockK][D], as stored
  int8_t* vt = vr + 2 * kBlockK * D;                   // [D][kVTS], keys permuted
  int* xmax = reinterpret_cast<int*>(vt + D * kVTS);   // [W * S][16] row maxima of a split
  int* xpv = xmax + W * S * 16;                        // [W * S][32][XW]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp / S, sw = warp % S;   // row group; split of the keys
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int8_t* qb = q + (long long)bh * Lq * D;
  const int8_t* kb = k + (long long)bh * Lk * D;
  const int8_t* vb = v + (long long)bh * Lk * D;
  const int r0 = blockIdx.x * (kRows * W) + rw * kRows + g;  // rows r0 and r0 + 8
  const float scale_qk = scales[0], scale_pv = scales[1];

  uint32_t qa[KSTEPS][4];
  {
    const bool in0 = r0 < Lq, in1 = r0 + 8 < Lq;
    const int8_t* q0 = qb + (long long)(in0 ? r0 : 0) * D;
    const int8_t* q1 = qb + (long long)(in1 ? r0 + 8 : 0) * D;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qa[kk][0] = in0 ? ld32(q0 + kk * 32 + 4 * t) : 0u;
      qa[kk][1] = in1 ? ld32(q1 + kk * 32 + 4 * t) : 0u;
      qa[kk][2] = in0 ? ld32(q0 + kk * 32 + 16 + 4 * t) : 0u;
      qa[kk][3] = in1 ? ld32(q1 + kk * 32 + 16 + 4 * t) : 0u;
    }
  }

  // a thread's 16-byte pieces of a block sit at the same rows in every
  // block: a fixed trip count, no division in the loop
  constexpr int CH = D / 16, PIECES = kBlockK * CH, ITERS = (PIECES + NT - 1) / NT;
  auto load_block = [&](int kb_i, int stage) {
    const int k0 = kb_i * kBlockK;
    const int8_t* kg = kb + (long long)k0 * D;
    const int8_t* vg = vb + (long long)k0 * D;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int e = tid + it * NT;
      if (PIECES % NT != 0 && e >= PIECES) break;
      const int j = e / CH, c = e % CH;
      const bool in = k0 + j < Lk;
      mma::cp_async16(ks + (stage * kBlockK + j) * KS + 16 * c, in ? kg + j * D + 16 * c : kb, in);
      mma::cp_async16(vr + (stage * kBlockK + j) * D + 16 * c, in ? vg + j * D + 16 * c : vb, in);
    }
  };

  float acc[D / 8][4];  // kept by the row group's first warp
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows r0, r0 + 8

  const int nblocks = (Lk + kBlockK - 1) / kBlockK;
  load_block(0, 0);
  mma::cp_async_commit();
  for (int kbi = 0; kbi < nblocks; ++kbi) {
    const int stage = kbi & 1;
    if (kbi + 1 < nblocks) {
      load_block(kbi + 1, stage ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* k_s = ks + (stage * kBlockK + sw * NK) * KS;
    const int8_t* v_s = vr + stage * kBlockK * D;
    // v transposed with its keys permuted: word w of column c holds keys
    // base + 2u, base + 2u + 1, base + 8 + 2u, base + 9 + 2u (base = 16 (w / 4), u = w % 4)
    constexpr int TASKS = (D / 4) * (kBlockK / 4);
#pragma unroll
    for (int it = 0; it < (TASKS + NT - 1) / NT; ++it) {
      const int e = tid + it * NT;
      if (TASKS % NT != 0 && e >= TASKS) break;
      const int c4 = e % (D / 4), w = e / (D / 4);
      const int base = (w / 4) * 16, u = w % 4;
      const uint32_t r0w = ld32(v_s + (base + 2 * u) * D + 4 * c4);
      const uint32_t r1w = ld32(v_s + (base + 2 * u + 1) * D + 4 * c4);
      const uint32_t r2w = ld32(v_s + (base + 8 + 2 * u) * D + 4 * c4);
      const uint32_t r3w = ld32(v_s + (base + 9 + 2 * u) * D + 4 * c4);
      const uint32_t lo01 = __byte_perm(r0w, r1w, 0x5140), hi01 = __byte_perm(r0w, r1w, 0x7362);
      const uint32_t lo23 = __byte_perm(r2w, r3w, 0x5140), hi23 = __byte_perm(r2w, r3w, 0x7362);
      uint32_t* col = reinterpret_cast<uint32_t*>(vt + 4 * c4 * kVTS) + w;
      col[0] = __byte_perm(lo01, lo23, 0x5410);
      col[kVTS / 4] = __byte_perm(lo01, lo23, 0x7632);
      col[2 * kVTS / 4] = __byte_perm(hi01, hi23, 0x5410);
      col[3 * kVTS / 4] = __byte_perm(hi01, hi23, 0x7632);
    }

    // int32 logits of this warp's NK keys of the block, kept in registers
    const int k0 = kbi * kBlockK + sw * NK;
    int c[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] = 0;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int8_t* kr = k_s + (n * 8 + g) * KS + kk * 32 + 4 * t;
        mma::mma_s8(c[n], qa[kk], ld32(kr), ld32(kr + 16));
      }
    }
    // the block's max logit, as an int32 dot over the valid keys of all
    // splits; only a warp whose keys reach past Lk tests them (warp-uniform)
    const bool tail = k0 + NK > Lk;
    int mx0 = INT_MIN, mx1 = INT_MIN;
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      const int key = k0 + n * 8 + 2 * t;
      if (!tail || key < Lk) { mx0 = max(mx0, c[n][0]); mx1 = max(mx1, c[n][2]); }
      if (!tail || key + 1 < Lk) { mx0 = max(mx0, c[n][1]); mx1 = max(mx1, c[n][3]); }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = max(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = max(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    if (t == 0) {
      xmax[(rw * S + sw) * 16 + g] = mx0;
      xmax[(rw * S + sw) * 16 + g + 8] = mx1;
    }
    __syncthreads();  // also: the transposed v is complete
#pragma unroll
    for (int j = 0; j < S; ++j) {
      mx0 = max(mx0, xmax[(rw * S + j) * 16 + g]);
      mx1 = max(mx1, xmax[(rw * S + j) * 16 + g + 8]);
    }
    const float mn0 = fmaxf(m0, __fmul_rn(int_to_f(mx0), scale_qk));
    const float mn1 = fmaxf(m1, __fmul_rn(int_to_f(mx1), scale_qk));
    const float a0 = expf(__fsub_rn(m0, mn0)), a1 = expf(__fsub_rn(m1, mn1));

    // p, p8 and the int32 p8 . v8 of this warp's keys, 32 keys a step
    int pv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[n][i] = 0;
    float ps0 = 0.f, ps1 = 0.f;
    auto pass2 = [&](auto masked) {  // std::true_type: keys past Lk get s = -1e30
#pragma unroll
      for (int st = 0; st < NK / 32; ++st) {
        uint32_t p8[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = k0 + (st * 4 + u) * 8 + 2 * t;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float s = __fmul_rn(int_to_f(c[st * 4 + u][i]), scale_qk);
            if constexpr (decltype(masked)::value) s = key + (i & 1) < Lk ? s : kNegInf;
            const float p = expf(__fsub_rn(s, i < 2 ? mn0 : mn1));
            if (i < 2) ps0 += p; else ps1 += p;
            p8[u][i] = rint_byte(__fmul_rn(p, 127.f));  // 0 .. 127
          }
        }
        uint32_t a[4];
        a[0] = p8[0][0] | p8[0][1] << 8 | p8[1][0] << 16 | p8[1][1] << 24;
        a[1] = p8[0][2] | p8[0][3] << 8 | p8[1][2] << 16 | p8[1][3] << 24;
        a[2] = p8[2][0] | p8[2][1] << 8 | p8[3][0] << 16 | p8[3][1] << 24;
        a[3] = p8[2][2] | p8[2][3] << 8 | p8[3][2] << 16 | p8[3][3] << 24;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int8_t* vp = vt + (n * 8 + g) * kVTS + sw * NK + st * 32 + 4 * t;
          mma::mma_s8(pv[n], a, ld32(vp), ld32(vp + 16));
        }
      }
    };
    if (tail) pass2(std::true_type{}); else pass2(std::false_type{});
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(kFull, ps0, off);
      ps1 += __shfl_xor_sync(kFull, ps1, off);
    }
    // the row group's first warp adds the splits' int32 sums (exact) and row
    // sums (in split order) and updates the running state
    int* xp = xpv + ((rw * S + sw) * 32 + lane) * XW;
    if (sw > 0) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) xp[4 * n + i] = pv[n][i];
      xp[D / 2] = __float_as_int(ps0);
      xp[D / 2 + 1] = __float_as_int(ps1);
    }
    __syncthreads();
    if (sw == 0) {
#pragma unroll
      for (int j = 1; j < S; ++j) {
        const int* xj = xp + j * 32 * XW;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[n][i] += xj[4 * n + i];
        ps0 += __int_as_float(xj[D / 2]);
        ps1 += __int_as_float(xj[D / 2 + 1]);
      }
      l0 = __fadd_rn(__fmul_rn(l0, a0), ps0);
      l1 = __fadd_rn(__fmul_rn(l1, a1), ps1);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[n][i] = __fadd_rn(__fmul_rn(acc[n][i], i < 2 ? a0 : a1),
                                __fmul_rn(int_to_f(pv[n][i]), scale_pv));
    }
    m0 = mn0;
    m1 = mn1;
    __syncthreads();  // the next block's copy, transpose and hand-over reuse this one's
  }

  if (sw > 0) return;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  T* ob = out + (long long)b * Lq * o_rs + (long long)h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < Lq)
      store2(ob + (long long)r0 * o_rs + n * 8, __fdiv_rn(acc[n][0], den0),
             __fdiv_rn(acc[n][1], den0));
    if (r0 + 8 < Lq)
      store2(ob + (long long)(r0 + 8) * o_rs + n * 8, __fdiv_rn(acc[n][2], den1),
             __fdiv_rn(acc[n][3], den1));
  }
}

int prep_blocks(long long n) {  // one 16-byte load a thread, all in flight at once
  const long long b = (n / 4 + kPrepThreads - 1) / kPrepThreads;
  return (int)(b < 1 ? 1 : b > kPrepBlocks ? kPrepBlocks : b);
}

template <typename T>
cudaError_t quantize(const void* q, const void* k, const void* v, void* q8, void* k8, void* v8,
                     int Lq, int Lk, int heads, int D, long long nq, long long nkv, void* buf,
                     int slot, float root_d, void* scales, cudaStream_t st) {
  const dim3 grid(prep_blocks(nq > nkv ? nq : nkv), 3);
  flash_int8_amax<T><<<grid, kPrepThreads, 0, st>>>((const T*)q, (const T*)k, (const T*)v, nq,
                                                     nkv, (unsigned*)buf, slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_int8_quantize<T><<<grid, kPrepThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (int8_t*)q8, (int8_t*)k8, (int8_t*)v8, Lq, Lk,
      heads, D, nq, nkv, (const unsigned*)buf, slot, root_d, (float*)scales);
  return cudaGetLastError();
}

template <typename T, int D, int W>
cudaError_t launch_one(const void* q, const void* k, const void* v, const void* scales,
                       void* out, int BH, int heads, int Lq, int Lk, long long o_rs, int grid_x,
                       int smem, cudaStream_t st) {
  constexpr int need = smem_bytes<D, W, kSplits>();
  if (smem != need) return cudaErrorInvalidValue;  // the Python geometry and this file disagree
  auto kernel = flash_int8_kernel<T, D, W, kSplits>;
  if (need > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(grid_x, BH), 32 * W * kSplits, need, st>>>((const int8_t*)q, (const int8_t*)k,
                                                (const int8_t*)v, (const float*)scales, (T*)out,
                                                heads, Lq, Lk, o_rs);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(int warps, const void* q, const void* k, const void* v, const void* scales,
                     void* out, int BH, int heads, int Lq, int Lk, long long o_rs, int grid_x,
                     int smem, cudaStream_t st) {
  switch (warps) {
    case 1: return launch_one<T, D, 1>(q, k, v, scales, out, BH, heads, Lq, Lk, o_rs, grid_x,
                                       smem, st);
    case 2: return launch_one<T, D, 2>(q, k, v, scales, out, BH, heads, Lq, Lk, o_rs, grid_x,
                                       smem, st);
    case 4: return launch_one<T, D, 4>(q, k, v, scales, out, BH, heads, Lq, Lk, o_rs, grid_x,
                                       smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(int D, int warps, const void* q, const void* k, const void* v,
                   const void* scales, void* out, int BH, int heads, int Lq, int Lk,
                   long long o_rs, int grid_x, int smem, cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<T, 32>(warps, q, k, v, scales, out, BH, heads, Lq, Lk, o_rs,
                                    grid_x, smem, st);
    case 64: return launch_d<T, 64>(warps, q, k, v, scales, out, BH, heads, Lq, Lk, o_rs,
                                    grid_x, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches 1 and 2: q [B, Lq, heads * D], k / v [B, Lk, heads * D]
// contiguous (nq, nkv elements; D a multiple of 4) -> q8 [B * heads, Lq, D],
// k8 / v8 [B * heads, Lk, D] int8 and scales [2] f32 = (sq * sk / root_d,
// sv / 127); buf [2][4] uint32 of amax slots, `slot` alternating between
// calls; dtype 0 = float32, 1 = bfloat16.
int flash_attn_int8_quantize(const void* q, const void* k, const void* v, void* q8, void* k8,
                             void* v8, int Lq, int Lk, int heads, int D, long long nq,
                             long long nkv, void* buf, int slot, float root_d, void* scales,
                             int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 4 != 0 || nq % 4 != 0 || nkv % 4 != 0 || nq >= (1LL << 31) || nkv >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)quantize<float>(q, k, v, q8, k8, v8, Lq, Lk, heads, D, nq, nkv, buf, slot,
                                root_d, scales, st);
  if (dtype == 1)
    return (int)quantize<__nv_bfloat16>(q, k, v, q8, k8, v8, Lq, Lk, heads, D, nq, nkv, buf,
                                        slot, root_d, scales, st);
  return (int)cudaErrorInvalidValue;
}

// Launch 3: q [BH, Lq, D], k / v [BH, Lk, D] int8 (BH = B * heads);
// scales [2] f32 = (scale_qk, scale_pv); out [B, Lq, heads * D] with rows
// o_rs elements apart; out_dtype 0 = float32, 1 = bfloat16; warps (row
// groups), splits, grid_x and smem from flash_launch_geometry.
int flash_attn_int8_forward(const void* q, const void* k, const void* v, const void* scales,
                            void* out, int BH, int heads, int Lq, int Lk, int D, long long o_rs,
                            int out_dtype, int warps, int splits, int grid_x, int smem,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (splits != kSplits) return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return (int)launch<float>(D, warps, q, k, v, scales, out, BH, heads, Lq, Lk, o_rs, grid_x,
                              smem, st);
  if (out_dtype == 1)
    return (int)launch<__nv_bfloat16>(D, warps, q, k, v, scales, out, BH, heads, Lq, Lk, o_rs,
                                      grid_x, smem, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
