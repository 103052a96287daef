// Fused dequantize + matmul + epilogue for blockwise-quantized weights
// (kernel K1 of the PyTorch port), for sm_90a.
//
// Replaces: embeddings_tpu/ops/qmatmul.py:_qmm_kernel (bf16 mode), the
// Pallas TPU kernel behind qmatmul(). Computes
//     out = epilogue(bf16(x) @ dequant_bf16(W))      (f32 accumulation)
// with W given as codes [K, N] int8 (q4 codes in [-8, 7], q8_0 codes in
// [-127, 127]) or uint8 [K/2, N] in the group-64 nibble layout (byte row r
// of each 64-row group holds weight rows r and r+32), f32 scales [K/32, N]
// and, for q4_1, f32 mins [K/32, N]. The dequantized weight is rounded
// exactly as the TPU kernel rounds it: w = bf16(bf16(level) * bf16(scale)),
// then w = bf16(w + bf16(min)) for q4_1; nf4 levels are the NF4 table
// rounded to bf16.
//
// Epilogues (f32, then one bf16 store): 0 none, 1 bias, 2/3 bias + GELU
// (both the tanh form, as in the TPU kernel), 4 bias + SiLU, 5 bias +
// residual + LayerNorm over the full row.
//
// What bounds it on the H100: at the main-path shapes (M = 32768 tokens,
// K, N in {768, 2304, 3072}) the product is compute-bound in bf16 (about
// 2*K flops per weight byte read). The dequantization is the other cost:
// a TPU grid runs in order and dequantizes a weight tile once per N-tile,
// reusing it for every M-tile; here blocks run in parallel and each one
// dequantizes its own K x 128 weight stripe. The design amortizes that
// over a 128-row M tile (64 rows for the LayerNorm epilogue), so the
// dequantization costs one shared-memory write per 128 (64) multiply-adds
// of each weight value. The product runs on the tensor cores through WMMA
// bf16 fragments with f32 accumulators. The K loop is software-pipelined
// through registers: while the warps multiply chunk k out of shared
// memory, each thread already holds chunk k+1's x vectors and code words
// in flight from device memory, and the plain epilogues double-buffer the
// shared tiles (one barrier per chunk). The LayerNorm epilogue keeps the
// block's full output rows (BM x N f32) in dynamic shared memory, so the
// residual add and the normalization never round-trip through device
// memory; that row buffer leaves room for one shared stage only. Not yet
// used: wgmma, TMA and persistent scheduling.
//
// K1e / K3e, the emission epilogue (replaces embeddings_tpu/ops/
// qmatmul.py:_emit, reached through qmatmul(emit_quantized=)): the f32
// epilogue output is also ("both") or instead ("only") written per-row
// symmetric int8, so = max(max_n |acc|, 1e-12) * (1/127), o8 = rint(acc *
// (1/so)), with the row scales so [M]. The row absmax needs the whole
// output row. The LayerNorm epilogue already holds a block's full f32
// rows in shared memory: it quantizes there, after the normalization, at
// no extra traffic. The other epilogues tile N by 128 columns and the
// whole row of an FFN (N = 3,072 or 4,096) fits no block's shared memory
// at a useful BM, so each tile writes its f32 results to a global staging
// buffer [M, N] and its per-row partial absmax to part [N/128, M], and a
// second launch (emit_rows_kernel, one warp a row) reduces the partials
// and quantizes the staged row. It takes every N % 8 == 0 and costs one
// f32 write and read of the output beyond the product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "int8_rows.cuh"

using namespace nvcuda;

namespace {

enum Kind { Q4_0 = 0, Q4_1 = 1, Q8_0 = 2, NF4 = 3 };
enum Epi { EPI_NONE = 0, EPI_BIAS = 1, EPI_GELU = 2, EPI_GELU_TANH = 3,
           EPI_SILU = 4, EPI_RES_LN = 5 };

constexpr int BN = 128;          // output columns per tile
constexpr int BK = 64;           // K rows per chunk: one group-64 pack
constexpr int THREADS = 256;     // 8 warps
constexpr int XLD = BK + 8;      // x tile row stride (bf16), padded
constexpr int WLD = BN + 8;      // weight tile row stride (bf16), padded
constexpr int SLD = 16 + 4;      // per-warp f32 staging row stride
constexpr int MAX_SMEM = 232448 - 1024;  // H100 per-block opt-in limit

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f, 0.16093020141124725f,
    0.24611230194568634f, 0.33791524171829224f, 0.44070982933044434f,
    0.5626170039176941f, 0.7229568362236023f, 1.0f};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Type conversions run at 1/8 of the f32 multiply rate on sm_90, and
// dequantization is the per-block work that is not amortized by the
// tensor cores, so it avoids them: a code n in [0, 2^23) becomes a float
// through the 2^23 magic number (n lands in the mantissa; the subtraction
// is exact), and the bf16 roundings go two values per instruction.
__device__ __forceinline__ float magic_f32(uint32_t n, float offset) {
  return __uint_as_float(0x4B000000u | n) - offset;
}
constexpr float NIBBLE_OFFSET = 8388616.0f;   // 2^23 + 8: nibble -> n - 8
constexpr float INT8_OFFSET = 8388736.0f;     // 2^23 + 128: (b ^ 0x80) -> b

// two weight values of one row: levels -> bf16(level * scale) (+ bf16 min),
// the TPU kernel's rounding (level and scale are bf16 values, so their
// f32 product is exact and rounds once)
template <int KIND>
__device__ __forceinline__ uint32_t deq2(float l0, float l1, float s0,
                                         float s1, float m0, float m1) {
  __nv_bfloat162 w = __floats2bfloat162_rn(l0 * s0, l1 * s1);
  if (KIND == Q4_1) {
    const float2 f = __bfloat1622float2(w);
    w = __floats2bfloat162_rn(f.x + m0, f.y + m1);
  }
  return *reinterpret_cast<uint32_t*>(&w);
}

__device__ __forceinline__ float activate(float v, int epi) {
  if (epi == EPI_GELU || epi == EPI_GELU_TANH) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * (v * v * v)))));
  }
  if (epi == EPI_SILU) return v * (1.0f / (1.0f + expf(-v)));
  return v;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float m) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The residual + LayerNorm epilogue over a block's BM full output rows,
// parked as f32 in shared memory (row stride ldr): y = row (+ bias) + res,
// LayerNorm over N in f32, one bf16 store (none with EMIT_ONLY). One warp
// per row. bias may be null (K3 adds it in its rescale). With emission
// the normalized row goes back into the buffer, its absmax gives the row
// scale, and the codes go to o8 [M, N], the scales to os [M].
template <int BM>
__device__ __forceinline__ void ln_rows(
    float* rowbuf, int ldr, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ res, const float* __restrict__ lns,
    const float* __restrict__ lnb, __nv_bfloat16* __restrict__ out,
    int8_t* __restrict__ o8, float* __restrict__ os, int emit, int m0,
    int M, int N, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += blockDim.x / 32) {
    const int gr = m0 + r;
    if (gr >= M) continue;
    float* row = rowbuf + r * ldr;
    float sum = 0.f;
    for (int c = lane * 8; c < N; c += 256) {
      float rv[8];
      unpack8(*reinterpret_cast<const uint4*>(res + (size_t)gr * N + c), rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = (bias ? row[c + e] + bias[c + e] : row[c + e]) + rv[e];
        row[c + e] = y;
        sum += y;
      }
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / N;
    float sq = 0.f;
    for (int c = lane * 8; c < N; c += 256)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = row[c + e] - mean;
        sq += d * d;
      }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = rsqrtf(sq / N + eps);
    float amax = 0.f;
    for (int c = lane * 8; c < N; c += 256) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (row[c + e] - mean) * inv * lns[c + e] + lnb[c + e];
        row[c + e] = v[e];
        amax = fmaxf(amax, fabsf(v[e]));
      }
      if (emit != EMIT_ONLY)
        *reinterpret_cast<uint4*>(out + (size_t)gr * N + c) = pack8(v);
    }
    if (emit == EMIT_NO) continue;
    // the row scale, then the codes from the normalized row (each lane
    // rereads the columns it wrote)
    const float so = fmaxf(warp_max(amax), 1e-12f) * INV127;
    const float rs = 1.0f / so;
    if (lane == 0) os[gr] = so;
    for (int c = lane * 8; c < N; c += 256)
      *reinterpret_cast<uint2*>(o8 + (size_t)gr * N + c) = codes8(row + c, rs);
  }
}

// K1e / K3e's second launch for the tiled epilogues: one warp per row
// reduces the row's ntiles partial absmaxes (part [ntiles, M]), writes the
// scale and quantizes the staged f32 row (stg [M, N]) into o8.
__global__ void __launch_bounds__(256) emit_rows_kernel(
    const float* __restrict__ stg, const float* __restrict__ part,
    int ntiles, int8_t* __restrict__ o8, float* __restrict__ os, int M,
    int N) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  float m = 0.f;
  for (int t = lane; t < ntiles; t += 32)
    m = fmaxf(m, part[(size_t)t * M + row]);
  const float so = fmaxf(warp_max(m), 1e-12f) * INV127;
  const float rs = 1.0f / so;
  if (lane == 0) os[row] = so;
  const float* sr = stg + (size_t)row * N;
  for (int c = lane * 8; c < N; c += 256) {
    const float4 a = *reinterpret_cast<const float4*>(sr + c);
    const float4 b = *reinterpret_cast<const float4*>(sr + c + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    *reinterpret_cast<uint2*>(o8 + (size_t)row * N + c) = codes8(v, rs);
  }
}

// a tiled epilogue's emission of one f32 value pair / 8-vector: stage it
// for emit_rows_kernel and fold its absmax into the block's row maxima
// (non-negative floats order as their bit patterns)
__device__ __forceinline__ void stage_emit(float* __restrict__ stg,
                                           unsigned* rmax, int lr,
                                           size_t off, const float* v,
                                           int n) {
  float m = 0.f;
  for (int e = 0; e < n; ++e) {
    stg[off + e] = v[e];
    m = fmaxf(m, fabsf(v[e]));
  }
  atomicMax(rmax + lr, __float_as_uint(m));
}

// What one thread holds of one K-chunk of the weight tile before it is
// dequantized into shared memory: the code words of its 4 columns and
// their bf16-rounded scales (and mins). Columns past N load scale 0 (and
// code 0), so they dequantize to 0.
struct WChunk {
  uint32_t w[8];   // packed: byte rows 4rg..4rg+3; else rows 8rg..8rg+7
  float4 s0, s1, m0, m1;
};

__device__ __forceinline__ float4 bf16r4(float4 v) {
  const float2 a = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  const float2 b = __bfloat1622float2(__floats2bfloat162_rn(v.z, v.w));
  return make_float4(a.x, a.y, b.x, b.y);
}

// the 4 columns' levels of one code word -> 2 packed bf16 pairs
template <int KIND>
__device__ __forceinline__ uint2 deq4(const float* lv, float4 s, float4 m) {
  return make_uint2(deq2<KIND>(lv[0], lv[1], s.x, s.y, m.x, m.y),
                    deq2<KIND>(lv[2], lv[3], s.z, s.w, m.z, m.w));
}

template <int KIND, bool PACKED>
__device__ __forceinline__ void fetch_w(
    WChunk& r, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, const float* __restrict__ mins,
    int N, int K, int k0, int n0, int tid) {
  const int cg = tid % 32;            // columns n0 + 4cg .. +3
  const int rg = tid / 32;            // 8 row groups
  const int n = n0 + 4 * cg;
  const bool col_ok = n < N;          // N % 8 == 0: all four or none
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  r.m0 = r.m1 = r.s1 = z;
  if (PACKED) {
    // packed rows 32g .. 32g+31 hold weight rows 64g .. 64g+63
    const int g = k0 / 64;
    r.s0 = col_ok ? bf16r4(ld4(scales + (size_t)(2 * g) * N + n)) : z;
    r.s1 = col_ok ? bf16r4(ld4(scales + (size_t)(2 * g + 1) * N + n)) : z;
    if (KIND == Q4_1) {
      r.m0 = col_ok ? bf16r4(ld4(mins + (size_t)(2 * g) * N + n)) : z;
      r.m1 = col_ok ? bf16r4(ld4(mins + (size_t)(2 * g + 1) * N + n)) : z;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r.w[i] = col_ok ? *reinterpret_cast<const uint32_t*>(
                            codes + (size_t)(g * 32 + 4 * rg + i) * N + n)
                      : 0u;
  } else {
    // int8 codes [K, N]: rows k0 + 8rg .. +7 share one 32-row scale block
    const int kr = k0 + 8 * rg;
    const bool ok = col_ok && kr < K;  // K % 32 == 0
    const size_t srow = (size_t)(kr / 32) * N + n;
    r.s0 = ok ? bf16r4(ld4(scales + srow)) : z;
    if (KIND == Q4_1) r.m0 = ok ? bf16r4(ld4(mins + srow)) : z;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.w[i] = ok ? *reinterpret_cast<const uint32_t*>(
                        codes + (size_t)(kr + i) * N + n)
                  : 0u;
  }
}

// Dequantize a fetched chunk into ws: weight rows [k0, k0 + 64) x columns
// [n0, n0 + 128), bf16, row stride WLD.
template <int KIND, bool PACKED>
__device__ __forceinline__ void store_w(__nv_bfloat16* ws, const WChunk& r,
                                        const float* nf4, int tid) {
  const int cg = tid % 32;
  const int rg = tid / 32;
  if (PACKED) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t nlo = (r.w[i] >> (8 * j)) & 15;      // code + 8
        const uint32_t nhi = (r.w[i] >> (8 * j + 4)) & 15;
        lo[j] = KIND == NF4 ? nf4[nlo] : magic_f32(nlo, NIBBLE_OFFSET);
        hi[j] = KIND == NF4 ? nf4[nhi] : magic_f32(nhi, NIBBLE_OFFSET);
      }
      const int pr = 4 * rg + i;      // 0 .. 31
      *reinterpret_cast<uint2*>(ws + pr * WLD + 4 * cg) =
          deq4<KIND>(lo, r.s0, r.m0);
      *reinterpret_cast<uint2*>(ws + (pr + 32) * WLD + 4 * cg) =
          deq4<KIND>(hi, r.s1, r.m1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float lv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = (r.w[i] >> (8 * j)) & 0xff;       // int8 code
        lv[j] = KIND == NF4
                    ? nf4[static_cast<int8_t>(b) + 8]
                    : magic_f32(b ^ 0x80u, INT8_OFFSET);
      }
      *reinterpret_cast<uint2*>(ws + (8 * rg + i) * WLD + 4 * cg) =
          deq4<KIND>(lv, r.s0, r.m0);
    }
  }
}

// BM output rows per block; LN: the block walks all N-tiles of its rows
// and applies residual + LayerNorm at the end (else one BM x 128 tile).
// STAGES: shared-memory buffers for the x / weight chunk (1 or 2).
template <int KIND, bool PACKED, int BM, bool LN, int STAGES>
__global__ void __launch_bounds__(THREADS, LN ? 1 : 2) qmm_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, const float* __restrict__ mins,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    __nv_bfloat16* __restrict__ out, int8_t* __restrict__ o8,
    float* __restrict__ os, float* __restrict__ stg,
    float* __restrict__ part, int M, int N, int K, int epi, int emit,
    float eps) {
  constexpr int WARPS_M = BM >= 64 ? 4 : 2;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WTM = BM / WARPS_M;
  constexpr int WTN = BN / WARPS_N;
  constexpr int FM = WTM / 16;
  constexpr int FN = WTN / 16;
  constexpr int XV = BM * (BK / 8) / THREADS;    // x vectors per thread
  constexpr int STAGE = BM * XLD + BK * WLD;     // bf16 per stage

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  float* rowbuf = reinterpret_cast<float*>(stages + STAGES * STAGE);  // LN
  __shared__ float nf4[16];
  __shared__ unsigned rmax[BM];  // the tile's row absmax bits (emission)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  if (tid < 16) nf4[tid] = bf16r(kNF4[tid]);
  for (int i = tid; i < BM; i += THREADS) rmax[i] = 0u;

  const int n_begin = LN ? 0 : blockIdx.y * BN;
  const int ntiles = LN ? (N + BN - 1) / BN : 1;
  const int nchunks = (K + BK - 1) / BK;
  const int total = ntiles * nchunks;
  const int ldr = ((N + BN - 1) / BN) * BN + 4;  // rowbuf row stride

  uint4 xr[XV];
  WChunk wr;
  auto fetch = [&](int t) {
    const int k0 = (t % nchunks) * BK;
    const int n0 = n_begin + (t / nchunks) * BN;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * THREADS;
      const int gr = m0 + idx / (BK / 8);
      const int gc = k0 + (idx % (BK / 8)) * 8;
      xr[v] = (gr < M && gc < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gc)
                  : make_uint4(0, 0, 0, 0);
    }
    fetch_w<KIND, PACKED>(wr, codes, scales, mins, N, K, k0, n0, tid);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  fetch(0);
  __syncthreads();  // nf4 table ready
  for (int t = 0; t < total; ++t) {
    __nv_bfloat16* xs = stages + (STAGES == 2 ? (t & 1) : 0) * STAGE;
    __nv_bfloat16* ws = xs + BM * XLD;
    // one stage: every warp is done reading the previous chunk. Two: the
    // buffer written here was last read two chunks ago, before the
    // barrier of the previous chunk.
    if (STAGES == 1) __syncthreads();
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * THREADS;
      *reinterpret_cast<uint4*>(xs + (idx / (BK / 8)) * XLD +
                                (idx % (BK / 8)) * 8) = xr[v];
    }
    store_w<KIND, PACKED>(ws, wr, nf4, tid);
    __syncthreads();
    if (t + 1 < total) fetch(t + 1);  // in flight during the products

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * WTM + i * 16) * XLD + kk,
                               XLD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * WLD + wn * WTN + j * 16, WLD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }

    if (LN && t % nchunks == nchunks - 1) {
      // park this N-tile's f32 results in the block's row buffer
      const int n0 = (t / nchunks) * BN;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::store_matrix_sync(
              rowbuf + (wm * WTM + i * 16) * ldr + n0 + wn * WTN + j * 16,
              acc[i][j], ldr, wmma::mem_row_major);
          wmma::fill_fragment(acc[i][j], 0.0f);
        }
    }
  }

  if (!LN) {
    __syncthreads();  // every warp is done with the stages: stage over them
    float* stage = reinterpret_cast<float*>(smem) + warp * 16 * SLD;
    const int r = lane / 2;
    const int c = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], SLD, wmma::mem_row_major);
        __syncwarp();
        const int lr = wm * WTM + i * 16 + r;
        const int gr = m0 + lr;
        const int gc = n_begin + wn * WTN + j * 16 + c;
        if (gr < M && gc < N) {
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = stage[r * SLD + c + e];
            if (epi != EPI_NONE) v[e] += bias[gc + e];
            v[e] = activate(v[e], epi);
          }
          if (emit != EMIT_ONLY)
            *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) = pack8(v);
          if (emit != EMIT_NO)
            stage_emit(stg, rmax, lr, (size_t)gr * N + gc, v, 8);
        }
        __syncwarp();
      }
    }
    if (emit != EMIT_NO) {
      __syncthreads();
      for (int i = tid; i < BM && m0 + i < M; i += THREADS)
        part[(size_t)blockIdx.y * M + m0 + i] = __uint_as_float(rmax[i]);
    }
    return;
  }

  __syncthreads();
  ln_rows<BM>(rowbuf, ldr, bias, res, lns, lnb, out, o8, os, emit, m0, M, N,
              eps);
}

template <int KIND, bool PACKED, int BM, bool LN, int STAGES>
size_t smem_bytes(int N) {
  size_t bytes = (size_t)STAGES * (BM * XLD + BK * WLD) * 2;
  if (LN) bytes += (size_t)BM * (((N + BN - 1) / BN) * BN + 4) * 4;
  return bytes;
}

// the emission outputs and scratch of one call (all null without one)
struct EmitArgs {
  void* o8;     // int8 [M, N]
  void* os;     // f32 [M]
  void* stg;    // f32 [M, N], tiled epilogues only
  void* part;   // f32 [ceil(N/128), M], tiled epilogues only
  int emit;
};

// the tiled epilogues' second launch (see emit_rows_kernel)
cudaError_t emit_rows(const EmitArgs& em, int M, int N, cudaStream_t stream) {
  emit_rows_kernel<<<(M + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(em.stg), static_cast<const float*>(em.part),
      (N + BN - 1) / BN, static_cast<int8_t*>(em.o8),
      static_cast<float*>(em.os), M, N);
  return cudaGetLastError();
}

template <int KIND, bool PACKED, int BM, bool LN, int STAGES>
cudaError_t launch(const void* x, const void* codes, const void* scales,
                   const void* mins, const void* bias, const void* res,
                   const void* lns, const void* lnb, void* out,
                   const EmitArgs& em, int M, int N, int K, int epi,
                   float eps, cudaStream_t stream) {
  auto kern = qmm_kernel<KIND, PACKED, BM, LN, STAGES>;
  const size_t smem = smem_bytes<KIND, PACKED, BM, LN, STAGES>(N);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, LN ? 1 : (N + BN - 1) / BN);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(mins),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<__nv_bfloat16*>(out), static_cast<int8_t*>(em.o8),
      static_cast<float*>(em.os), static_cast<float*>(em.stg),
      static_cast<float*>(em.part), M, N, K, epi, em.emit, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || LN || em.emit == EMIT_NO) return err;
  return emit_rows(em, M, N, stream);
}

template <int KIND, bool PACKED>
cudaError_t dispatch_tile(const void* x, const void* codes,
                          const void* scales, const void* mins,
                          const void* bias, const void* res, const void* lns,
                          const void* lnb, void* out, const EmitArgs& em,
                          int M, int N, int K, int epi, float eps,
                          cudaStream_t stream) {
#define QMM_ARGS x, codes, scales, mins, bias, res, lns, lnb, out, em, M, N, \
                 K, epi, eps, stream
  if (epi != EPI_RES_LN)
    return launch<KIND, PACKED, 128, false, 2>(QMM_ARGS);
  if (smem_bytes<KIND, PACKED, 64, true, 1>(N) <= MAX_SMEM)
    return launch<KIND, PACKED, 64, true, 1>(QMM_ARGS);
  if (smem_bytes<KIND, PACKED, 32, true, 1>(N) <= MAX_SMEM)
    return launch<KIND, PACKED, 32, true, 1>(QMM_ARGS);
#undef QMM_ARGS
  return cudaErrorInvalidValue;  // row too wide for shared memory
}


// ---------------------------------------------------------------------------
// K3: the int8 tensor-core mode
//
// Replaces: embeddings_tpu/ops/qmatmul.py:_qmm_int8, the Pallas TPU
// kernel behind qmatmul(int8_compute=True). Computes the TPU kernel's
// result, not its block structure:
//     w   = level * scale (+ min)                          (f32)
//     cs  = max(max_k |w|, 1e-12) * (1/127)   per column n
//     w8  = rint(w * (1/cs))                               (int8)
//     sx  = max(max_k |x|, 1e-12) * (1/127)   per row m
//     q   = rint(x * (1/sx))                               (int8)
//     acc = sum_k q * w8                                   (s32)
//     out = epilogue((float(acc) * cs) * sx + bias)        (f32, one bf16 store)
// rint rounds half to even, like the TPU's round(); the reciprocals are
// IEEE divisions (no fast math), and the products whose rounding the TPU
// keeps separate are written with __fmul_rn / __fadd_rn, so the int8
// operands equal the TPU's bit for bit.
//
// What bounds it on the H100: the product, at 2 * M * N * K int8
// operations (1,979 TOPS dense), at the main-path shapes. The TPU grid
// runs in order and requantizes each weight N-tile once for all M-tiles;
// CUDA blocks run in parallel, so one block redoing the column absmax
// over all of K would spend more time on scalar dequantization than on
// its products. The design splits the work into three launches on one
// stream: (1) the weight's per-column requantization, written transposed
// as w8t [N, K] so both tensor-core operands are K-contiguous; (2) the
// rows' quantization into q [M, K]; (3) the s8 x s8 -> s32 product on
// the tensor cores (mma.sync m16n8k32), cp.async double-buffered
// 128 x 128 x 64 tiles, with the rescale and K1's epilogues (residual +
// LayerNorm through the same full-row shared buffer). Not yet used:
// wgmma, TMA, and a w8 cached across calls.
//
// K3x, pre-quantized input (replaces _qmm_int8's sx_ref path): the caller
// hands q [M, K] int8 and sx [M] f32 (an emission of the previous layer,
// or quantize_act), launch (2) is skipped and (3) reads them as they are:
// the x read is half the bf16 bytes and no row absmax is recomputed.
// ---------------------------------------------------------------------------

constexpr int I8_BK = 64;           // K bytes per chunk
constexpr int I8_LD = I8_BK + 16;    // smem row stride (bytes): no conflicts

// one dequantized weight value w[k][n], f32, TPU rounding (no contraction)
template <int KIND, bool PACKED>
__device__ __forceinline__ float wval(const uint8_t* __restrict__ codes,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ mins, int N,
                                      int k, int n) {
  float lv;
  if (PACKED) {
    const int r = k % 64;
    const uint32_t b = codes[(size_t)((k / 64) * 32 + (r & 31)) * N + n];
    const uint32_t nib = r < 32 ? (b & 15u) : (b >> 4);
    lv = KIND == NF4 ? kNF4[nib] : (float)((int)nib - 8);
  } else {
    const int c = (int)static_cast<int8_t>(codes[(size_t)k * N + n]);
    lv = KIND == NF4 ? kNF4[c + 8] : (float)c;
  }
  const size_t s = (size_t)(k / 32) * N + n;
  float w = __fmul_rn(lv, scales[s]);
  if (KIND == Q4_1) w = __fadd_rn(w, mins[s]);
  return w;
}

// (1) per-column requantization: block = 32 columns x 8 row groups
template <int KIND, bool PACKED>
__global__ void __launch_bounds__(256) requant_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ scales,
    const float* __restrict__ mins, int8_t* __restrict__ w8t,
    float* __restrict__ cs, int N, int K) {
  __shared__ float red[8][32];
  __shared__ float inv[32];
  __shared__ __align__(16) int8_t tile[32][I8_BK + 4];
  const int cg = threadIdx.x % 32;
  const int rg = threadIdx.x / 32;
  const int n0 = blockIdx.x * 32;
  const int n = n0 + cg;
  const bool ok = n < N;
  float m = 0.f;
  if (ok)
    for (int k = rg; k < K; k += 8)
      m = fmaxf(m, fabsf(wval<KIND, PACKED>(codes, scales, mins, N, k, n)));
  red[rg][cg] = m;
  __syncthreads();
  if (rg == 0) {
    for (int i = 1; i < 8; ++i) m = fmaxf(m, red[i][cg]);
    const float c = fmaxf(m, 1e-12f) * INV127;
    inv[cg] = 1.0f / c;
    if (ok) cs[n] = c;
  }
  __syncthreads();
  const int ncols = min(32, N - n0);
  for (int k0 = 0; k0 < K; k0 += I8_BK) {
    if (ok)
      for (int kk = rg; kk < I8_BK && k0 + kk < K; kk += 8)
        tile[cg][kk] = static_cast<int8_t>(__float2int_rn(
            wval<KIND, PACKED>(codes, scales, mins, N, k0 + kk, n) *
            inv[cg]));
    __syncthreads();
    // transposed write-out: column c's 64 bytes as 16 words, K-contiguous
    for (int wi = threadIdx.x; wi < 32 * (I8_BK / 4); wi += 256) {
      const int c = wi / (I8_BK / 4);
      const int kw = (wi % (I8_BK / 4)) * 4;
      if (c < ncols && k0 + kw < K)
        *reinterpret_cast<uint32_t*>(w8t + (size_t)(n0 + c) * K + k0 + kw) =
            *reinterpret_cast<const uint32_t*>(&tile[c][kw]);
    }
    __syncthreads();
  }
}

// (2) per-row activation quantization: one warp per row, 8 rows a block
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
    float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * K;
  float m = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = fmaxf(m, 1e-12f) * INV127;
  const float inv = 1.0f / s;
  if (lane == 0) sx[row] = s;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e / 4] |= (uint32_t)(__float2int_rn(v[e] * inv) & 0xff) << (8 * (e % 4));
    *reinterpret_cast<uint2*>(q + (size_t)row * K + c) = make_uint2(w[0], w[1]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the rescale of one accumulator: (float(acc) * cs) * sx (+ bias)
__device__ __forceinline__ float rescale(int acc, float c, float s, float b,
                                         bool add_bias) {
  const float v = __fmul_rn(__fmul_rn((float)acc, c), s);
  return add_bias ? __fadd_rn(v, b) : v;
}

// (3) q [M, K] x w8t [N, K]^T on the tensor cores, rescale, epilogue.
// BM output rows per block; LN: the block walks all N-tiles of its rows
// and applies residual + LayerNorm at the end (else one BM x 128 tile).
template <int BM, bool LN>
__global__ void __launch_bounds__(THREADS, LN ? 1 : 2) qmm_int8_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ sx,
    const int8_t* __restrict__ w8t, const float* __restrict__ cs,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    __nv_bfloat16* __restrict__ out, int8_t* __restrict__ o8,
    float* __restrict__ os, float* __restrict__ stg,
    float* __restrict__ part, int M, int N, int K, int epi, int emit,
    float eps) {
  constexpr int WARPS_M = BM >= 64 ? 4 : 2;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WTM = BM / WARPS_M;
  constexpr int WTN = BN / WARPS_N;
  constexpr int FM = WTM / 16;
  constexpr int FN = WTN / 8;
  constexpr int STAGE = (BM + BN) * I8_LD;        // bytes per stage
  constexpr int CH = I8_BK / 16;                   // 16-byte chunks a row

  extern __shared__ __align__(128) unsigned char smem[];
  float* rowbuf = reinterpret_cast<float*>(smem + 2 * STAGE);  // LN only
  __shared__ unsigned rmax[BM];  // the tile's row absmax bits (emission)
  for (int i = threadIdx.x; i < BM; i += THREADS) rmax[i] = 0u;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;          // mma groupID
  const int t4 = lane % 4;         // mma threadID_in_group
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  const int n_begin = LN ? 0 : blockIdx.y * BN;
  const int ntiles = LN ? (N + BN - 1) / BN : 1;
  const int nchunks = (K + I8_BK - 1) / I8_BK;
  const int total = ntiles * nchunks;
  const int ldr = ((N + BN - 1) / BN) * BN + 4;
  const bool add_bias = epi != EPI_NONE;

  auto load = [&](int t) {
    unsigned char* a = smem + (t & 1) * STAGE;
    unsigned char* b = a + BM * I8_LD;
    const int k0 = (t % nchunks) * I8_BK;
    const int n0 = n_begin + (t / nchunks) * BN;
    for (int i = tid; i < (BM + BN) * CH; i += THREADS) {
      const int r = i / CH;
      const int kc = k0 + (i % CH) * 16;
      if (r < BM) {
        const bool p = m0 + r < M && kc < K;
        cp_async16(a + r * I8_LD + (i % CH) * 16,
                   p ? q + (size_t)(m0 + r) * K + kc : q, p);
      } else {
        const int rn = r - BM;
        const bool p = n0 + rn < N && kc < K;
        cp_async16(b + rn * I8_LD + (i % CH) * 16,
                   p ? w8t + (size_t)(n0 + rn) * K + kc : w8t, p);
      }
    }
  };

  int acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0);
  cp_async_commit();
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) load(t + 1);
    cp_async_commit();
    cp_async_wait1();  // chunk t has landed
    __syncthreads();
    const unsigned char* a = smem + (t & 1) * STAGE;
    const unsigned char* b = a + BM * I8_LD;
#pragma unroll
    for (int ks = 0; ks < I8_BK; ks += 32) {
      uint32_t af[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const unsigned char* p = a + (wm * WTM + i * 16 + g) * I8_LD + ks +
                                 t4 * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * I8_LD);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * I8_LD + 16);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const unsigned char* p = b + (wn * WTN + j * 8 + g) * I8_LD + ks +
                                 t4 * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int i = 0; i < FM; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled by the load of chunk t + 2

    if (LN && t % nchunks == nchunks - 1) {
      // park this N-tile's rescaled results (bias included) as f32 rows
      const int n0 = (t / nchunks) * BN;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = wm * WTM + i * 16 + g + (e / 2) * 8;
            const int cc = n0 + wn * WTN + j * 8 + t4 * 2 + (e % 2);
            const bool ok = m0 + rr < M && cc < N;
            rowbuf[rr * ldr + cc] =
                ok ? rescale(acc[i][j][e], cs[cc], sx[m0 + rr], bias[cc], true)
                   : 0.f;
            acc[i][j][e] = 0;
          }
    }
  }

  if (!LN) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int cc = n_begin + wn * WTN + j * 8 + t4 * 2;
        if (cc >= N) continue;  // N % 8 == 0: the pair is whole or absent
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = wm * WTM + i * 16 + g + h * 8;
          const int gr = m0 + lr;
          if (gr >= M) continue;
          const float s = sx[gr];
          const float v[2] = {
              activate(rescale(acc[i][j][2 * h], cs[cc], s, bias[cc],
                               add_bias), epi),
              activate(rescale(acc[i][j][2 * h + 1], cs[cc + 1], s,
                               bias[cc + 1], add_bias), epi)};
          if (emit != EMIT_ONLY)
            *reinterpret_cast<uint32_t*>(out + (size_t)gr * N + cc) =
                pack2(v[0], v[1]);
          if (emit != EMIT_NO)
            stage_emit(stg, rmax, lr, (size_t)gr * N + cc, v, 2);
        }
      }
    if (emit != EMIT_NO) {
      __syncthreads();
      for (int i = threadIdx.x; i < BM && m0 + i < M; i += THREADS)
        part[(size_t)blockIdx.y * M + m0 + i] = __uint_as_float(rmax[i]);
    }
    return;
  }
  __syncthreads();
  ln_rows<BM>(rowbuf, ldr, nullptr, res, lns, lnb, out, o8, os, emit, m0, M,
              N, eps);
}

template <int BM, bool LN>
size_t int8_smem_bytes(int N) {
  size_t bytes = 2ull * (BM + BN) * I8_LD;
  if (LN) bytes += (size_t)BM * (((N + BN - 1) / BN) * BN + 4) * 4;
  return bytes;
}

template <int BM, bool LN>
cudaError_t launch_int8(const int8_t* q, const float* sx, const int8_t* w8t,
                        const float* cs, const void* bias, const void* res,
                        const void* lns, const void* lnb, void* out,
                        const EmitArgs& em, int M, int N, int K, int epi,
                        float eps, cudaStream_t stream) {
  auto kern = qmm_int8_kernel<BM, LN>;
  const size_t smem = int8_smem_bytes<BM, LN>(N);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, LN ? 1 : (N + BN - 1) / BN);
  kern<<<grid, THREADS, smem, stream>>>(
      q, sx, w8t, cs, static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<__nv_bfloat16*>(out),
      static_cast<int8_t*>(em.o8), static_cast<float*>(em.os),
      static_cast<float*>(em.stg), static_cast<float*>(em.part), M, N, K,
      epi, em.emit, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || LN || em.emit == EMIT_NO) return err;
  return emit_rows(em, M, N, stream);
}

template <int KIND, bool PACKED>
cudaError_t requant(const void* codes, const void* scales, const void* mins,
                    int8_t* w8t, float* cs, int N, int K,
                    cudaStream_t stream) {
  requant_kernel<KIND, PACKED><<<(N + 31) / 32, 256, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const float*>(mins), w8t, cs, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers; mins, bias, res, lns, lnb may be null
// where the kind / epilogue does not read them. Shapes: x [M, K] bf16,
// codes [K, N] int8 or [K/2, N] uint8 (packed), scales/mins [K/32, N] f32,
// bias/lns/lnb [N] f32, res/out [M, N] bf16. emit: 0 none, 1 both (out
// and o8 [M, N] int8 + os [M] f32), 2 only (o8 and os; out may be null);
// with emission and an epilogue other than residual + LayerNorm, stg f32
// [M, N] and part f32 [ceil(N/128), M] are scratch (else may be null).
// Requires N % 8 == 0, K % 32 == 0 (K % 64 == 0 when packed), 16-byte
// aligned pointers. Returns a cudaError_t.
int qmm_launch(const void* x, const void* codes, const void* scales,
               const void* mins, const void* bias, const void* res,
               const void* lns, const void* lnb, void* out, void* o8,
               void* os, void* stg, void* part, int M, int N, int K,
               int kind, int packed, int epi, int emit, float eps,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const EmitArgs em{o8, os, stg, part, emit};
#define QMM_ARGS x, codes, scales, mins, bias, res, lns, lnb, out, em, M, N, \
                 K, epi, eps, st
  switch (kind * 2 + (packed ? 1 : 0)) {
    case Q4_0 * 2: return dispatch_tile<Q4_0, false>(QMM_ARGS);
    case Q4_0 * 2 + 1: return dispatch_tile<Q4_0, true>(QMM_ARGS);
    case Q4_1 * 2: return dispatch_tile<Q4_1, false>(QMM_ARGS);
    case Q4_1 * 2 + 1: return dispatch_tile<Q4_1, true>(QMM_ARGS);
    case Q8_0 * 2: return dispatch_tile<Q8_0, false>(QMM_ARGS);
    case NF4 * 2: return dispatch_tile<NF4, false>(QMM_ARGS);
    case NF4 * 2 + 1: return dispatch_tile<NF4, true>(QMM_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef QMM_ARGS
}

// K3, the int8 mode: three launches on `stream` (weight requantization
// into w8t [N, K] int8 + cs [N] f32, row quantization into q [M, K] int8 +
// sx [M] f32, then the int8 product with the rescale and the epilogue).
// Pointers and shapes as qmm_launch; w8t, cs, q, sx are device scratch of
// those shapes. x_int8 (K3x): q and sx are the caller's pre-quantized rows
// and row scales, x is not read and the row quantization is skipped.
// emit, o8, os, stg, part as qmm_launch (K3e). Requires N % 8 == 0,
// K % 32 == 0 (K % 64 == 0 packed). Returns a cudaError_t.
int qmm_int8_launch(const void* x, const void* codes, const void* scales,
                    const void* mins, const void* bias, const void* res,
                    const void* lns, const void* lnb, void* w8t, void* cs,
                    void* q, void* sx, void* out, void* o8, void* os,
                    void* stg, void* part, int M, int N, int K, int kind,
                    int packed, int epi, int emit, int x_int8, float eps,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const EmitArgs em{o8, os, stg, part, emit};
  int8_t* w8 = static_cast<int8_t*>(w8t);
  float* c = static_cast<float*>(cs);
  cudaError_t err;
#define RQ_ARGS codes, scales, mins, w8, c, N, K, st
  switch (kind * 2 + (packed ? 1 : 0)) {
    case Q4_0 * 2: err = requant<Q4_0, false>(RQ_ARGS); break;
    case Q4_0 * 2 + 1: err = requant<Q4_0, true>(RQ_ARGS); break;
    case Q4_1 * 2: err = requant<Q4_1, false>(RQ_ARGS); break;
    case Q4_1 * 2 + 1: err = requant<Q4_1, true>(RQ_ARGS); break;
    case Q8_0 * 2: err = requant<Q8_0, false>(RQ_ARGS); break;
    case NF4 * 2: err = requant<NF4, false>(RQ_ARGS); break;
    case NF4 * 2 + 1: err = requant<NF4, true>(RQ_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef RQ_ARGS
  if (err != cudaSuccess) return err;
  int8_t* q8 = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(sx);
  if (!x_int8) {
    quant_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q8, s, M, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#define I8_ARGS q8, s, w8, c, bias, res, lns, lnb, out, em, M, N, K, epi, \
                eps, st
  if (epi != EPI_RES_LN) return launch_int8<128, false>(I8_ARGS);
  if (int8_smem_bytes<64, true>(N) <= MAX_SMEM)
    return launch_int8<64, true>(I8_ARGS);
  if (int8_smem_bytes<32, true>(N) <= MAX_SMEM)
    return launch_int8<32, true>(I8_ARGS);
#undef I8_ARGS
  return cudaErrorInvalidValue;  // row too wide for shared memory
}

const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
