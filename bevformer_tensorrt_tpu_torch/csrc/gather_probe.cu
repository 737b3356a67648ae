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
// the memory time.  At the base cross-attention shape most of those bytes
// are the index and weight streams (692 MB); the rows the kernel gathers are
// far more (86.5 M rows, 11.1 GB of float32), and they come from L1 and L2.
// What holds gather_blend above its bound is delivering them: an SM's L1
// returns at most 128 bytes a clock and serves a load one line at a time,
// rows that miss it come from L2, and the int8 rows' conversion is
// arithmetic of its own.
//
// Design.  gather_rows: one thread per 16-byte piece of an output row, pieces
// of a row on neighbouring threads, so a row moves as one or a few full
// sectors and the writes of a warp are contiguous.
// gather_blend:
//  - each lane loads 16 bytes of a row, so a row group of 8 / 4 / 2 lanes
//    reads a float32 / bfloat16 / int8 row and one warp instruction reads
//    4 / 8 / 16 rows (as phase 2 of csrc/msda.cu does);
//  - a row group owns one (table, query) output, or, where the outputs are
//    too few to fill the card, a 1 / seg share of its chunks
//    (ops/gather_probe.py::gather_blend_geometry), summed by shuffles;
//  - its lanes load one chunk of the output's indices and weights at a time,
//    16 bytes a lane (4 x lanes entries), without allocating them in L1 (the
//    rows keep it); the keys are clamped there, once, and the next chunk is
//    loaded before this one's rows; shuffles inside the group hand each entry
//    round, and a row's address is one multiply-add on the lane's base;
//  - a group loads kBatch rows (8; 4 for bfloat16, whose registers would
//    otherwise cost blocks) before their sums, so a warp has 32-128 rows in
//    flight;
//  - int8 values become floats by a byte permute into the mantissa of 2^23
//    and one subtraction (exact), not by the conversion unit's 16 a clock;
//  - a block owns qt consecutive queries of one table, so the rows its warps
//    read fall in the key window that the workload's locality sets and come
//    from L1 more than once; consecutive blocks take consecutive query tiles,
//    so the card works on a few tables at a time and their rows stay in L2;
//  - a chunk whose entries all count runs without checks; otherwise an entry
//    past the output's count, or of an output past the last query, reads a
//    row of zeros with weight 0;
//  - the first group of an output writes its row, 16 bytes a lane.
// Indices are clamped into the table.  The kernels allocate nothing and
// launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr int kRow = 32;  // channels of a row of gather_blend

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

// a row of kRow values of T, 16 bytes a lane
template <typename T> struct Row {
  static constexpr int kPer = 16 / sizeof(T);     // values a lane holds
  static constexpr int kLanes = kRow / kPer;      // lanes a row group
  static constexpr int kRows = 32 / kLanes;       // rows a warp instruction
  static constexpr int kChunk = 4 * kLanes;       // entries a group loads at once
  static constexpr int kBatch = sizeof(T) == 2 ? 4 : 8;  // rows loaded before their sums
};

// the kPer values of 16 bytes of a row, as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[16]) {
  // x + 128 into the low byte of 2^23's mantissa: 2^23 + 128 + x, exact
  const unsigned v[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                         r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = __uint_as_float(__byte_perm(v[i], 0x4B000000u, 0x7650u | b)) - 8388736.f;
}

__device__ __forceinline__ int comp(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ const uint4 kZeroRow = {0u, 0u, 0u, 0u};  // what an entry past the end reads

// One chunk of a row group's entries: this lane holds entries 4 j .. 4 j + 3
// of it (kv clamped keys, wv weights); entry s comes from lane s / 4 of the
// group.  The rows are read kBatch at a time before their sums.  kChecked:
// only the first `valid` entries count (the others read a row of zeros with
// weight 0); else all kChunk do.  `steps` bounds the entries of any group of
// the warp in this chunk round.
template <typename T, bool kChecked>
__device__ __forceinline__ void blend_chunk(const char* tbase, const int4& kv, const float4& wv,
                                            float (&acc)[Row<T>::kPer], int valid, int steps) {
  using R = Row<T>;
  constexpr int kB = R::kBatch;
#pragma unroll
  for (int s0 = 0; s0 < R::kChunk; s0 += kB) {
    if (kChecked && s0 >= steps) break;
    uint4 raw[kB];
    float wt[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int s = s0 + u;
      const unsigned key = __shfl_sync(kFull, comp(kv, s & 3), s >> 2, R::kLanes);
      float wu = __shfl_sync(kFull, comp(wv, s & 3), s >> 2, R::kLanes);
      const uint4* p = reinterpret_cast<const uint4*>(tbase + (size_t)key * (kRow * sizeof(T)));
      if (kChecked) {
        const bool ok = s < valid;
        p = ok ? p : &kZeroRow;
        wu = ok ? wu : 0.f;
      }
      wt[u] = wu;
      raw[u] = __ldg(p);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      float f[R::kPer];
      unpack(raw[u], f);
#pragma unroll
      for (int k = 0; k < R::kPer; ++k) acc[k] = fmaf(wt[u], f[k], acc[k]);
    }
  }
}

// table [B, keys, 32] of T, idx and w [B * nq, entries] (entries % 4 == 0),
// out [B * nq, 32] float32.  Block: qt consecutive queries of one table;
// warp w: rounds of per_warp = kRows / seg outputs, w * per_warp + k * 8 *
// per_warp; group g of a warp: output g / seg of the round and its chunks
// g % seg, g % seg + seg, ...
template <typename T>
__global__ void __launch_bounds__(kBlock)
gather_blend_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                    const float* __restrict__ w, float* __restrict__ out, const int keys,
                    const int nq, const int entries, const int qt, const int seg) {
  using R = Row<T>;
  const int tiles = (nq + qt - 1) / qt;
  const int b = blockIdx.x / tiles, q0 = blockIdx.x % tiles * qt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane / R::kLanes, j = lane % R::kLanes;
  const int og = g / seg, sg = g % seg, per_warp = R::kRows / seg;
  const int chunks = (entries + R::kChunk - 1) / R::kChunk;
  const char* tbase = reinterpret_cast<const char*>(table + (long long)b * keys * kRow) + 16 * j;
  asm("" : "+l"(tbase));  // kept whole: a row's address is then one multiply-add
  for (int o0 = warp * per_warp; o0 < qt && q0 + o0 < nq; o0 += warps * per_warp) {
    const int q = q0 + o0 + og;
    const bool live = o0 + og < qt && q < nq;
    // every output of the warp's round a query (the same across the warp)
    const bool all_live = o0 + per_warp <= qt && q0 + o0 + per_warp <= nq;
    const long long r = (long long)b * nq + q;
    const int4* iq = reinterpret_cast<const int4*>(idx + r * entries);
    const float4* wq = reinterpret_cast<const float4*>(w + r * entries);
    float acc[R::kPer];
#pragma unroll
    for (int k = 0; k < R::kPer; ++k) acc[k] = 0.f;
    // the group's chunk c: this lane's 4 entries of it, keys clamped, zeros past the end
    auto fetch = [&](int c, int4& kv, float4& wv) {
      const int e = c * R::kChunk + 4 * j;
      if (live && e < entries) {
        asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(kv.x), "=r"(kv.y), "=r"(kv.z), "=r"(kv.w) : "l"(iq + e / 4));
        asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(wv.x), "=f"(wv.y), "=f"(wv.z), "=f"(wv.w) : "l"(wq + e / 4));
        kv = make_int4(clamp_key(kv.x, keys), clamp_key(kv.y, keys), clamp_key(kv.z, keys),
                       clamp_key(kv.w, keys));
      } else {
        kv = make_int4(0, 0, 0, 0);
        wv = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    int4 kv;
    float4 wv;
    fetch(sg, kv, wv);
    for (int c0 = 0; c0 < chunks; c0 += seg) {
      const int c = c0 + sg;
      int4 kn;
      float4 wn;
      fetch(c + seg, kn, wn);  // the next chunk's, ahead of this one's rows
      if (all_live && (c0 + seg) * R::kChunk <= entries) {
        blend_chunk<T, false>(tbase, kv, wv, acc, R::kChunk, R::kChunk);
      } else {
        const int valid = live ? min(max(entries - c * R::kChunk, 0), R::kChunk) : 0;
        blend_chunk<T, true>(tbase, kv, wv, acc, valid, min(R::kChunk, entries - c0 * R::kChunk));
      }
      kv = kn;
      wv = wn;
    }
    for (int d = seg / 2; d > 0; d >>= 1)  // the shares of an output, within its groups
#pragma unroll
      for (int k = 0; k < R::kPer; ++k) acc[k] += __shfl_down_sync(kFull, acc[k], d * R::kLanes);
    if (live && sg == 0) {
      float4* op = reinterpret_cast<float4*>(out + r * kRow) + j * (R::kPer / 4);
#pragma unroll
      for (int k = 0; k < R::kPer / 4; ++k)
        __stcs(op + k, make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]));
    }
  }
}

template <typename T>
cudaError_t launch_blend(const void* table, const void* idx, const void* w, void* out, int B,
                         int keys, int nq, int entries, int qt, int seg, int threads,
                         cudaStream_t stream) {
  // the geometry of ops/gather_probe.py::gather_blend_geometry, checked
  using R = Row<T>;
  if (threads != kBlock || seg < 1 || seg > R::kRows || (seg & (seg - 1)) || qt < 1 ||
      qt % (R::kRows / seg) || entries % 4 || (uintptr_t)table % 16 || (uintptr_t)idx % 16 ||
      (uintptr_t)w % 16 || (uintptr_t)out % 16)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)B * ((nq + qt - 1) / qt);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  gather_blend_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)table, (const int*)idx, (const float*)w, (float*)out, keys, nq, entries, qt, seg);
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
// channels.  idx int32 and w float32 [B, nq, entries]; out float32 [B, nq, 32];
// every pointer 16-byte aligned.  qt, seg and threads: the launch geometry
// (ops/gather_probe.py::gather_blend_geometry).
int gather_blend(const void* table, const void* idx, const void* w, void* out, int B, int keys,
                 int nq, int entries, int dtype, int qt, int seg, int threads, void* stream) {
  if (B < 1 || keys < 1 || nq < 1 || entries < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define BLEND(T) \
  (int)launch_blend<T>(table, idx, w, out, B, keys, nq, entries, qt, seg, threads, st)
  if (dtype == 0) return BLEND(float);
  if (dtype == 1) return BLEND(__nv_bfloat16);
  if (dtype == 2) return BLEND(int8_t);
#undef BLEND
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
