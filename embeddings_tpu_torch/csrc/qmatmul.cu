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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
    __nv_bfloat16* __restrict__ out, int M, int N, int K, int epi,
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

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  if (tid < 16) nf4[tid] = bf16r(kNF4[tid]);

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
        const int gr = m0 + wm * WTM + i * 16 + r;
        const int gc = n_begin + wn * WTN + j * 16 + c;
        if (gr < M && gc < N) {
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = stage[r * SLD + c + e];
            if (epi != EPI_NONE) v[e] += bias[gc + e];
            v[e] = activate(v[e], epi);
          }
          *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) = pack8(v);
        }
        __syncwarp();
      }
    }
    return;
  }

  __syncthreads();
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int gr = m0 + r;
    if (gr >= M) continue;
    float* row = rowbuf + r * ldr;
    float sum = 0.f;
    for (int c = lane * 8; c < N; c += 256) {
      float rv[8];
      unpack8(*reinterpret_cast<const uint4*>(res + (size_t)gr * N + c), rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = row[c + e] + bias[c + e] + rv[e];
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
    for (int c = lane * 8; c < N; c += 256) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (row[c + e] - mean) * inv * lns[c + e] + lnb[c + e];
      *reinterpret_cast<uint4*>(out + (size_t)gr * N + c) = pack8(v);
    }
  }
}

template <int KIND, bool PACKED, int BM, bool LN, int STAGES>
size_t smem_bytes(int N) {
  size_t bytes = (size_t)STAGES * (BM * XLD + BK * WLD) * 2;
  if (LN) bytes += (size_t)BM * (((N + BN - 1) / BN) * BN + 4) * 4;
  return bytes;
}

template <int KIND, bool PACKED, int BM, bool LN, int STAGES>
cudaError_t launch(const void* x, const void* codes, const void* scales,
                   const void* mins, const void* bias, const void* res,
                   const void* lns, const void* lnb, void* out, int M, int N,
                   int K, int epi, float eps, cudaStream_t stream) {
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
      static_cast<__nv_bfloat16*>(out), M, N, K, epi, eps);
  return cudaGetLastError();
}

template <int KIND, bool PACKED>
cudaError_t dispatch_tile(const void* x, const void* codes,
                          const void* scales, const void* mins,
                          const void* bias, const void* res, const void* lns,
                          const void* lnb, void* out, int M, int N, int K,
                          int epi, float eps, cudaStream_t stream) {
#define QMM_ARGS x, codes, scales, mins, bias, res, lns, lnb, out, M, N, K, \
                 epi, eps, stream
  if (epi != EPI_RES_LN)
    return launch<KIND, PACKED, 128, false, 2>(QMM_ARGS);
  if (smem_bytes<KIND, PACKED, 64, true, 1>(N) <= MAX_SMEM)
    return launch<KIND, PACKED, 64, true, 1>(QMM_ARGS);
  if (smem_bytes<KIND, PACKED, 32, true, 1>(N) <= MAX_SMEM)
    return launch<KIND, PACKED, 32, true, 1>(QMM_ARGS);
#undef QMM_ARGS
  return cudaErrorInvalidValue;  // row too wide for shared memory
}

}  // namespace

extern "C" {

// All pointers are device pointers; mins, bias, res, lns, lnb may be null
// where the kind / epilogue does not read them. Shapes: x [M, K] bf16,
// codes [K, N] int8 or [K/2, N] uint8 (packed), scales/mins [K/32, N] f32,
// bias/lns/lnb [N] f32, res/out [M, N] bf16. Requires N % 8 == 0,
// K % 32 == 0 (K % 64 == 0 when packed), 16-byte aligned pointers.
// Returns a cudaError_t.
int qmm_launch(const void* x, const void* codes, const void* scales,
               const void* mins, const void* bias, const void* res,
               const void* lns, const void* lnb, void* out, int M, int N,
               int K, int kind, int packed, int epi, float eps,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QMM_ARGS x, codes, scales, mins, bias, res, lns, lnb, out, M, N, K, \
                 epi, eps, st
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

const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
