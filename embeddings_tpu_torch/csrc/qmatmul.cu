// Fused dequantize + matmul + epilogue for blockwise-quantized weights
// (kernel K1 of the PyTorch port) and its int8 tensor-core mode (K3, an
// s8 instantiation of the same kernel: see the K3 section below), for
// sm_90a.
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
// residual + LayerNorm over the full row (two-pass: the mean, then the
// mean of squared deviations).
//
// What bounds it on the H100: at the main-path shapes (M = 16,384-32,768
// tokens, K, N in 256 .. 8,960) the product is compute-bound in bf16
// (about 2*K flops per weight byte read). The dequantization is the other
// cost: a TPU grid runs in order and dequantizes a weight tile once per
// N-tile, reusing it for every M-tile; CUDA blocks run in parallel and
// each dequantizes the weight stripe of its own tile. The design (Hopper):
// - products on wgmma (m64n128k16, bf16 x bf16 -> f32 in registers), two
//   consumer warpgroups of BM/2 rows each, tiles of BM = 256 (or 128,
//   where 256 would leave SMs idle: the caller picks by shape) x BN = 128,
//   so the dequantization is one shared-memory write per 256 (128)
//   multiply-adds of each weight value;
// - a producer warpgroup (setmaxnreg: it gives registers to the
//   consumers) keeps a ring of 4 stages (3 with LayerNorm) in flight with
//   mbarrier full / empty pairs: x tiles come by TMA into
//   128-byte-swizzled shared memory, and the producer's threads fetch
//   the raw codes and scales of the chunks ahead into registers (two
//   ahead for packed q4_0 / nf4) while they dequantize the current one
//   straight into the bf16 weight tile, in the same swizzled K-major
//   layout that wgmma reads (so dequantization overlaps the products; the
//   weight is not wgmma's register operand, as in CUTLASS's mixed-input
//   GEMMs, because that would put the dequantization back on the
//   consumers' issue slots). The producer bounds the main loop: at
//   BM = 256 its dequantization of a chunk takes longer than the
//   chunk's products;
// - persistent blocks, one per SM, walk the output tiles; the tiled
//   epilogues (bias, activation) stage each 64-row block's bf16 output in
//   swizzled shared memory and store it by TMA, which runs on while the
//   next tile's products start; the activation is compiled per epilogue
//   (a runtime choice is if-converted into tanh, exp and a divide for
//   every value);
// - the residual + LayerNorm epilogue runs as a thread-block cluster of
//   cs = ceil(N / 128) blocks along N (up to 16, non-portable beyond 8;
//   256 rows up to 8 blocks, 128 beyond): each block prefetches its
//   tile's residual into shared memory (cp.async at the tile's start,
//   landing during the products), keeps its BM x 128 tile in registers,
//   exchanges per-row partial sums with the other blocks through
//   distributed shared memory (mbarrier signalled, one arrival a block,
//   so the producers never stop for the cluster), once for the mean and
//   once for the squared deviations, normalizes its own columns in place
//   of the residual and stores them by TMA. Every exchange is a point
//   where the cluster's blocks wait for each other, and it is these
//   waits, not the arithmetic, that make the LayerNorm tiles slower than
//   the tiled ones. Rows wider than 16 x 128 are refused.
//
// K1e / K3e, the emission epilogue (replaces embeddings_tpu/ops/
// qmatmul.py:_emit, reached through qmatmul(emit_quantized=)): the f32
// epilogue output is also ("both") or instead ("only") written per-row
// symmetric int8, so = max(max_n |acc|, 1e-12) * (1/127), o8 = rint(acc *
// (1/so)), with the row scales so [M]. The row absmax needs the whole
// output row. The LayerNorm cluster (K1's and K3's) takes it in a third
// exchange and each block quantizes its own columns. The other
// epilogues tile N by 128 columns, so each tile writes its f32 results to
// a global staging buffer [M, N] and its per-row partial absmax to part
// [N/128, M], and a second launch (emit_rows_kernel, one warp a row)
// reduces the partials and quantizes the staged row. It takes every N % 8
// == 0 and costs one f32 write and read of the output beyond the product.

#include <cuda.h>  // CUtensorMap (types only: the driver call is looked up)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_rows.cuh"
#include "sm90.cuh"

namespace {

// the weight kinds K1 dequantizes, and S8: K3's operands, int8 q [M, K]
// and the requantized weight w8t [N, K], both read as they are
enum Kind { Q4_0 = 0, Q4_1 = 1, Q8_0 = 2, NF4 = 3, S8 = 4 };
enum Epi { EPI_NONE = 0, EPI_BIAS = 1, EPI_GELU = 2, EPI_GELU_TANH = 3,
           EPI_SILU = 4, EPI_RES_LN = 5 };

constexpr int BN = 128;          // output columns per tile
constexpr int BK = 64;           // K rows per chunk: one group-64 pack

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f, 0.16093020141124725f,
    0.24611230194568634f, 0.33791524171829224f, 0.44070982933044434f,
    0.5626170039176941f, 0.7229568362236023f, 1.0f};

// Type conversions run at 1/8 of the f32 multiply rate on sm_90, and
// dequantization is the per-block work that is not amortized by the
// tensor cores, so it avoids them: a code n in [0, 2^23) becomes a float
// through the 2^23 magic number (n lands in the mantissa; the subtraction
// is exact). The packed nibbles take the same route in bf16 (128 + n).
__device__ __forceinline__ float magic_f32(uint32_t n, float offset) {
  return __uint_as_float(0x4B000000u | n) - offset;
}
constexpr float INT8_OFFSET = 8388736.0f;     // 2^23 + 128: (b ^ 0x80) -> b

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
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

// ---------------------------------------------------------------------------
// K1 on Hopper: a persistent, warp-specialized wgmma kernel
// ---------------------------------------------------------------------------

constexpr int K1_THREADS = 384;       // consumer warpgroups 0, 1; producer 2
constexpr int K1_MAX_STAGES = 4;      // the shared-memory ring (3 with LN)
constexpr int K1_CLUSTER_MAX = 16;    // LayerNorm rows up to 16 x BN wide
constexpr int K1_PRODUCER_REGS = 96;  // setmaxnreg: 96 + 2 x 200 <= 3 x 168
constexpr int K1_CONSUMER_REGS = 200;
constexpr int B_TILE_BYTES = BN * BK * 2;  // the bf16 weight tile, 16 KB
constexpr uint32_t BF2_ONE = 0x3F803F80u;      // bf16x2 (1, 1)
constexpr uint32_t BF2_NEG136 = 0xC308C308u;   // bf16x2 (-136, -136)
constexpr uint32_t BF2_NEG0 = 0x80008000u;     // bf16x2 (-0, -0)
constexpr uint32_t BF2_128 = 0x43004300u;      // bf16x2 (128, 128)

constexpr int OUT_STAGE_BYTES = 64 * BN * 2;  // a warpgroup's 64 output rows

// Shared memory of one block, from a 1024-byte aligned base: the ring of
// x tiles (stages x BM x 64 bf16, 128-byte swizzled, written by TMA) and
// weight tiles (stages x BN x 64 bf16 in the same swizzled K-major
// layout, written by the producer); then, with the LayerNorm epilogue,
// the tile's residual prefetched by the consumers (BM x BN bf16 as two
// 64-column halves in the 128-byte swizzle; the normalized output
// replaces it in place for the TMA store) and two exchange buffers
// [cs][BM] f32 that the cluster's blocks write into; else each consumer
// warpgroup's staging of 64 bf16 output rows for the TMA store (two
// 64-column halves); then the mbarriers: full[4], empty[4], exchange[2].
// The LayerNorm ring has 3 stages, to leave room for the residual.
__host__ __device__ constexpr int k1_stages(bool ln) { return ln ? 3 : 4; }
__host__ __device__ constexpr size_t k1_a_bytes(int bm) {
  return (size_t)bm * BK * 2;
}
__host__ __device__ constexpr size_t k1_region_off(int bm, bool ln) {
  return k1_stages(ln) * (k1_a_bytes(bm) + B_TILE_BYTES);
}
__host__ __device__ constexpr size_t k1_res_bytes(int bm) {
  return (size_t)bm * BN * 2;
}
__host__ __device__ constexpr size_t k1_bar_off(int bm, bool ln, int cs) {
  return k1_region_off(bm, ln) + (ln ? k1_res_bytes(bm) + 2ull * cs * bm * 4
                                     : 2ull * OUT_STAGE_BYTES);
}
__host__ __device__ constexpr size_t k1_smem_bytes(int bm, bool ln, int cs) {
  return 1024 + k1_bar_off(bm, ln, cs) + (2 * K1_MAX_STAGES + 2) * 8;
}
// the widest LayerNorm cluster at 256 rows (wider ones take 128 rows)
constexpr int K1_CLUSTER_BM256 = 8;
// (the kernel's static shared memory: 3 x BN f32 of staged epilogue
// parameters and the bf16 NF4 table)
static_assert(k1_smem_bytes(256, true, K1_CLUSTER_BM256) + 3 * BN * 4 + 32
                  <= 232448, "a LayerNorm cluster block of 256 rows");
static_assert(k1_smem_bytes(128, true, K1_CLUSTER_MAX) + 3 * BN * 4 + 32
                  <= 232448, "a LayerNorm cluster block of 128 rows");
static_assert(k1_smem_bytes(256, false, 0) + 3 * BN * 4 + 32 <= 232448,
              "a tiled block of 256 rows");

struct K1Args {
  const uint8_t* codes;
  const float* scales;
  const float* mins;
  const float* bias;
  const __nv_bfloat16* res;
  const float* lns;
  const float* lnb;
  __nv_bfloat16* out;
  int8_t* o8;
  float* os;
  float* stg;
  float* part;
  int M, N, K, epi, emit, cs;
  float eps;
  const float* wscale;  // K3: the weight's column scales [N]
  const float* xscale;  // K3: the rows' scales [M]
};

// d = a * b + c on bf16 pairs, rounded once (a * b + c is exact first)
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// four f32 values -> their bf16 roundings, packed (columns 0, 1 | 2, 3)
__device__ __forceinline__ uint2 bf16x4(float4 v) {
  return make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// column i's bf16 of a bf16x4, in both halves of a bf16x2
__device__ __forceinline__ uint32_t bcast(uint2 w, int i) {
  return __byte_perm(w.x, w.y, 2 * i * 0x1111u + 0x1010u);
}

// What one producer thread holds of one raw weight chunk (64 K rows x 128
// columns) before it dequantizes it: the code words of 4 columns (packed:
// byte rows 8rg .. 8rg+7 of the chunk's 32, which hold weight rows 8rg ..
// and 32 + 8rg ..; else rows 16rg .. 16rg+15) and their scales (and mins)
// for the 32-row groups those rows fall in. Columns past N, and rows past
// K, load code 0 and scale 0, so they dequantize to 0.
template <bool PACKED>
struct RawChunk {
  uint32_t w[PACKED ? 8 : 16];
  float4 s0, s1, m0, m1;
};

template <int KIND, bool PACKED>
__device__ __forceinline__ void fetch_raw(RawChunk<PACKED>& r,
                                          const K1Args& a, int k0, int n0,
                                          int cg, int rg) {
  const int n = n0 + 4 * cg;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  r.s0 = r.s1 = r.m0 = r.m1 = z;
#pragma unroll
  for (int i = 0; i < (PACKED ? 8 : 16); ++i) r.w[i] = 0u;
  if (n >= a.N) return;  // N % 8 == 0: all four columns or none
  const size_t N = a.N;
  if (PACKED) {
    const int g = k0 / 64;
    r.s0 = ld4(a.scales + (2 * g) * N + n);
    r.s1 = ld4(a.scales + (2 * g + 1) * N + n);
    if (KIND == Q4_1) {
      r.m0 = ld4(a.mins + (2 * g) * N + n);
      r.m1 = ld4(a.mins + (2 * g + 1) * N + n);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.w[i] = *reinterpret_cast<const uint32_t*>(
          a.codes + (size_t)(g * 32 + 8 * rg + i) * N + n);
  } else {
    const int kr = k0 + 16 * rg;  // K % 32 == 0: 16 rows in or all out
    if (kr >= a.K) return;
    r.s0 = ld4(a.scales + (size_t)(kr / 32) * N + n);
    if (KIND == Q4_1) r.m0 = ld4(a.mins + (size_t)(kr / 32) * N + n);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      r.w[i] = *reinterpret_cast<const uint32_t*>(a.codes +
                                                  (size_t)(kr + i) * N + n);
  }
}

// the bf16 weight of two codes of one column (rows k, k+1 in bytes 0 and 2
// of b: nibbles for packed codes, int8 otherwise) with the TPU kernel's
// rounding: bf16(level * bf16(scale)) (+ bf16(min), rounded again)
template <int KIND, bool PACKED>
__device__ __forceinline__ uint32_t deq_pair(uint32_t b, int hi, uint32_t s2,
                                             float sf, uint32_t m2,
                                             const uint16_t* nf4) {
  uint32_t w;
  if (PACKED) {
    const uint32_t nib = (hi ? b >> 4 : b) & 0x000F000Fu;
    uint32_t lv;
    if (KIND == NF4)
      lv = nf4[nib & 15] | ((uint32_t)nf4[nib >> 16] << 16);
    else  // (128 + n) - 136 = n - 8, exact in bf16
      lv = bf2_fma(nib | BF2_128, BF2_ONE, BF2_NEG136);
    w = bf2_fma(lv, s2, BF2_NEG0);
  } else {
    // int8 codes: levels and products exact in f32, one rounding to bf16
    const uint32_t c0 = b & 0xff, c1 = (b >> 16) & 0xff;
    float l0, l1;
    if (KIND == NF4) {
      l0 = __uint_as_float((uint32_t)nf4[(int)(int8_t)c0 + 8] << 16);
      l1 = __uint_as_float((uint32_t)nf4[(int)(int8_t)c1 + 8] << 16);
    } else {
      l0 = magic_f32(c0 ^ 0x80u, INT8_OFFSET);
      l1 = magic_f32(c1 ^ 0x80u, INT8_OFFSET);
    }
    w = pack2(l0 * sf, l1 * sf);
  }
  if (KIND == Q4_1) w = bf2_fma(w, BF2_ONE, m2);
  return w;
}

// Dequantize a fetched chunk into the weight tile at bs: element (n, k)
// of the 128 x 64 K-major tile at byte n*128 + ((k/8) ^ (n%8))*16 +
// (k%8)*2, the layout TMA's 128-byte swizzle gives the x tile. Each store
// is 8 k values of one column; a thread walks its 4 columns in a rotated
// order so that the 8 threads of a store phase hit 8 different 16-byte
// bank groups.
template <int KIND, bool PACKED>
__device__ __forceinline__ void store_b(const RawChunk<PACKED>& r,
                                        uint32_t bs, int cg, int rg,
                                        const uint16_t* nf4) {
  // the 4 columns' scales (and mins) rounded to bf16 once; each column's
  // is then one byte permute away
  const uint2 s0 = bf16x4(r.s0), s1 = bf16x4(r.s1);
  const uint2 m0 = KIND == Q4_1 ? bf16x4(r.m0) : make_uint2(0u, 0u);
  const uint2 m1 = KIND == Q4_1 ? bf16x4(r.m1) : make_uint2(0u, 0u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jj = (j + (cg >> 1)) & 3;
    const int n = 4 * cg + jj;
    const uint32_t sel = jj * 0x1111u + 0x4400u;  // bytes jj of two words
    const uint32_t row = bs + n * 128;
    if (PACKED) {
      const uint32_t s2lo = bcast(s0, jj), s2hi = bcast(s1, jj);
      const uint32_t m2lo = KIND == Q4_1 ? bcast(m0, jj) : 0u;
      const uint32_t m2hi = KIND == Q4_1 ? bcast(m1, jj) : 0u;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b = __byte_perm(r.w[2 * i], r.w[2 * i + 1], sel);
        lo[i] = deq_pair<KIND, PACKED>(b, 0, s2lo, 0.f, m2lo, nf4);
        hi[i] = deq_pair<KIND, PACKED>(b, 1, s2hi, 0.f, m2hi, nf4);
      }
      st_shared16(row + ((rg ^ (n & 7)) << 4),
                  make_uint4(lo[0], lo[1], lo[2], lo[3]));
      st_shared16(row + (((4 + rg) ^ (n & 7)) << 4),
                  make_uint4(hi[0], hi[1], hi[2], hi[3]));
    } else {
      // the bf16 scale as an f32 (the upper half of its bf16x2)
      const float sf = __uint_as_float(bcast(s0, jj) & 0xFFFF0000u);
      const uint32_t m2 = KIND == Q4_1 ? bcast(m0, jj) : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t b = __byte_perm(r.w[8 * h + 2 * i],
                                         r.w[8 * h + 2 * i + 1], sel);
          v[i] = deq_pair<KIND, PACKED>(b, 0, 0u, sf, m2, nf4);
        }
        st_shared16(row + (((2 * rg + h) ^ (n & 7)) << 4),
                    make_uint4(v[0], v[1], v[2], v[3]));
      }
    }
  }
}

// the cluster exchange of the LayerNorm epilogue: this thread's values
// for its 2 * MT rows (v, already reduced over the 4 lanes of each row)
// go to every block's exchange buffer, one lane of each row quad writing
// them as one vector to the quad's slot [rank][slot] (slot = warp * 8 +
// lane / 4: the same rows in every block); after a barrier of the
// block's consumers one thread arrives on each block's barrier (one
// remote arrival a block, not one a warp: the arrivals are on the
// critical path of every exchange); once every block has arrived, v
// becomes the sum (or max) over the cs blocks, taken in rank order so
// every block computes the same value
template <int MT, bool MAX>
__device__ __forceinline__ void exchange(float (&v)[2 * MT], float* xch,
                                         uint32_t bar, int cs, int rank,
                                         int BMr, uint32_t parity,
                                         bool writer, int slot) {
  const float* mine = xch + slot * 2 * MT;
  if (writer) {
    const uint32_t at = smem_u32(mine + rank * BMr);
    for (int r = 0; r < cs; ++r) {
      const uint32_t dst = map_rank(at, r);
      if (MT == 2)
        asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
                     ::"r"(dst), "f"(v[0]), "f"(v[1]), "f"(v[2 % (2 * MT)]),
                     "f"(v[3 % (2 * MT)]) : "memory");
      else
        asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(dst),
                     "f"(v[0]), "f"(v[1]) : "memory");
    }
  }
  // every consumer's writes are ordered before thread 0's release
  named_bar(1, 256);
  if (threadIdx.x == 0)
    for (int r = 0; r < cs; ++r) arrive_cluster(map_rank(bar, r));
  mbar_wait_cluster(bar, parity);
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    float t = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float x = mine[r * BMr + i];
      t = MAX ? fmaxf(t, x) : t + x;
    }
    v[i] = t;
  }
}

// the activation of a tiled epilogue, resolved at compile time (a runtime
// choice is if-converted: every value through tanh, exp and a divide).
// GELU's tanh form as v * sigmoid(2u), u = sqrt(2/pi) (v + 0.044715 v^3),
// which equals v * 0.5 (1 + tanh(u)); SiLU v * sigmoid(v); the sigmoid
// through the fast exp2 and reciprocal, a few f32 ulps from the library
// functions, far inside the bf16 output's rounding
template <int EPI>
__device__ __forceinline__ float act(float v) {
  if (EPI == EPI_GELU) {
    const float u = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    return v * __fdividef(1.0f, 1.0f + __expf(-2.0f * u));
  }
  if (EPI == EPI_SILU) return v * __fdividef(1.0f, 1.0f + __expf(-v));
  return v;
}

// The tiled epilogue of one consumer warpgroup (thread wt of 128, warp w4)
// over its MT 64-row blocks of the tile: bias and activation in f32, then
// each block's bf16 rows go through this warpgroup's staging (swizzled,
// conflict-free) to one TMA store per 64-column half, which clips rows
// past M and columns past N and runs on while the next tile's products
// start. Emission stages the f32 values in global memory for
// emit_rows_kernel and leaves each row's absmax over this tile's columns
// in amax. NO_BIAS: acc holds K3's rescaled values, bias already added.
template <int EPI, int MT, bool NO_BIAS>
__device__ __forceinline__ void tiled_epilogue(
    float (&acc)[MT][64], const K1Args& a, const CUtensorMap* omap,
    uint32_t stage, float* sbias, int m_wg, int n0, int nj, int w4,
    int lane, int wt, int wg, float (&amax)[2 * MT]) {
  const int cq = 2 * (lane & 3);
  // the tile's bias, one column a thread, in this warpgroup's shared row
  // (its last readers passed the previous tile's final barrier)
  sbias[wt] = (EPI != EPI_NONE && !NO_BIAS && n0 + wt < a.N)
                  ? a.bias[n0 + wt] : 0.f;
  const bool out = a.emit != EMIT_ONLY;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // the staging is free once the last store has read it
    if (out && wt == 0) bulk_wait_read();
    named_bar(2 + wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w4 * 16 + (lane >> 2) + 8 * h;  // row in the block
      const int gr = m_wg + mt * 64 + r;
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (j >= nj) break;  // N % 8 == 0: a column pair is whole
        const float2 b = *reinterpret_cast<const float2*>(sbias + 8 * j + cq);
        const float v0 = act<EPI>(acc[mt][4 * j + 2 * h] + b.x);
        const float v1 = act<EPI>(acc[mt][4 * j + 2 * h + 1] + b.y);
        if (out) {
          const uint32_t addr = stage + (j >> 3) * (OUT_STAGE_BYTES / 2) +
                                r * 128 + (((j & 7) ^ (r & 7)) << 4) +
                                (cq << 1);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(pack2(v0, v1)) : "memory");
        }
        if (a.emit != EMIT_NO && gr < a.M)
          *reinterpret_cast<float2*>(a.stg + (size_t)gr * a.N + n0 + 8 * j +
                                     cq) = make_float2(v0, v1);
        m = fmaxf(m, fmaxf(fabsf(v0), fabsf(v1)));
      }
      amax[2 * mt + h] = m;
    }
    if (out) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(2 + wg, 128);
      if (wt == 0) {
        const int row = m_wg + mt * 64;
        tma_store_2d(omap, stage, n0, row);
        if (n0 + 64 < a.N)
          tma_store_2d(omap, stage + OUT_STAGE_BYTES / 2, n0 + 64, row);
        bulk_commit();
      }
    }
  }
  // without a store, nothing else orders the bias reads before the next
  // tile's bias writes
  if (!out) named_bar(2 + wg, 128);
}

// K3's rescale in front of the epilogues: acc = (f32(s32) * cs[n]) *
// sx[m] (+ bias[n] unless the epilogue is "none"), each step rounded on
// its own as the plain version rounds it (no contraction into an FMA);
// columns past N and rows past M give 0. grow: this thread's 2 * MT
// global rows, cq its column pair in each group of 8.
template <int MT>
__device__ __forceinline__ void rescale_s8(const uint32_t (&iacc)[MT][64],
                                           float (&acc)[MT][64],
                                           const K1Args& a, const int* grow,
                                           int n0, int nj, int cq) {
  const bool bias = a.epi != EPI_NONE;
  float sx[2 * MT];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i)
    sx[i] = grow[i] < a.M ? a.xscale[grow[i]] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float2 c = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    if (j < nj) {
      c = *reinterpret_cast<const float2*>(a.wscale + n0 + 8 * j + cq);
      if (bias) b = *reinterpret_cast<const float2*>(a.bias + n0 + 8 * j + cq);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * j + 2 * h + e;
          const float v = __fmul_rn(
              __fmul_rn((float)(int)iacc[mt][k], e ? c.y : c.x),
              sx[2 * mt + h]);
          acc[mt][k] = bias ? __fadd_rn(v, e ? b.y : b.x) : v;
        }
  }
}

// K1 (KIND a weight kind) and K3 (KIND == S8). BM output rows x BN
// columns a tile. LN: the residual + LayerNorm epilogue, launched as
// clusters of cs = ceil(N / BN) blocks along N (block rank = blockIdx.x =
// its N tile), each cluster walking M tiles blockIdx.y, + gridDim.y, ...;
// else the blocks walk the M x N tiles blockIdx.x, + gridDim.x, ... (N
// tiles fastest). wmap: K3's weight w8t [N, K] (unused by K1).
template <int KIND, bool PACKED, int BM, bool LN>
__global__ void __launch_bounds__(K1_THREADS, 1) qmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap omap, const K1Args a) {
  constexpr int MT = BM / 128;  // m64 tiles per consumer warpgroup
  constexpr int STAGES = k1_stages(LN);
  // K3 (S8): both operands int8, a chunk is 128 K values (128 bytes, as
  // K1's 64 bf16), both tiles come by TMA
  constexpr bool I8 = KIND == S8;
  constexpr int CK = I8 ? 128 : BK;  // K values per chunk
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint16_t nf4[16];
  __shared__ float lnp[3][BN];  // LN: bias, LN scale, LN bias
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw_base);
  const uint32_t a_tiles = base;
  const uint32_t b_tiles = base + STAGES * (uint32_t)k1_a_bytes(BM);
  // the region: LN's residual / output tile then its exchange buffers, or
  // the tiled epilogue's output staging
  const uint32_t region = base + (uint32_t)k1_region_off(BM, LN);
  float* xch = reinterpret_cast<float*>(sbase + k1_region_off(BM, LN) +
                                        k1_res_bytes(BM));
  const uint32_t bars = base + (uint32_t)k1_bar_off(BM, LN, LN ? a.cs : 0);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (K1_MAX_STAGES + s); };
  auto xch_bar = [&](int b) { return bars + 8 * (2 * K1_MAX_STAGES + b); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the x (and K3's w8t) bytes, + K1's producer threads
      mbar_init(full_bar(s), I8 ? 1 : 1 + 128);
      mbar_init(empty_bar(s), 8);       // one lane per consumer warp
    }
    if (LN) {
      mbar_init(xch_bar(0), a.cs);  // one arrival a block of the cluster
      mbar_init(xch_bar(1), a.cs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 16) nf4[tid] = (uint16_t)bf16_bits(kNF4[tid]);
  if (LN)
    cluster_sync_all();  // every block's barriers exist before any arrive
  else
    __syncthreads();

  const int ntn = (a.N + BN - 1) / BN;
  const int ntm = (a.M + BM - 1) / BM;
  const int nk = (a.K + CK - 1) / CK;
  const int t_first = LN ? blockIdx.y : blockIdx.x;
  const int t_step = LN ? gridDim.y : gridDim.x;
  const int t_count = LN ? ntm : ntm * ntn;
  const int rank = LN ? blockIdx.x : 0;

  if (tid >= 256) {
    // ---- producer: x tiles by TMA, weight tiles dequantized (K1) or
    // by TMA too (K3) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        K1_PRODUCER_REGS));
    const int pt = tid - 256;
    if constexpr (I8) {
      // K3: q's and w8t's tiles by TMA, one thread issuing
      if (pt == 0) {
        int stage = 0;
        uint32_t phase = 0;
        for (int t = t_first; t < t_count; t += t_step) {
          const int m0 = (LN ? t : t / ntn) * BM;
          const int n0 = LN ? rank * BN : (t % ntn) * BN;
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(empty_bar(stage), phase ^ 1);
            mbar_expect_tx(full_bar(stage),
                           (uint32_t)k1_a_bytes(BM) + B_TILE_BYTES);
            tma_load_2d(a_tiles + stage * (uint32_t)k1_a_bytes(BM), &xmap,
                        kc * CK, m0, full_bar(stage));
            tma_load_2d(b_tiles + stage * B_TILE_BYTES, &wmap, kc * CK, n0,
                        full_bar(stage));
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else {
      const int cg = pt & 31;
      const int rg = pt >> 5;
      // The raw words of the next chunks are in flight while this one is
      // dequantized: two chunks ahead for the packed 4-bit codes (three
      // register sets fit the producer's registers), one for the rest.
      constexpr bool DEEP = PACKED && KIND != Q4_1;
      RawChunk<PACKED> cur, nxt, far;
      auto n_of = [&](int tt) { return LN ? rank * BN : (tt % ntn) * BN; };
      auto advance = [&](int& tt, int& kk) {
        if (++kk == nk) {
          kk = 0;
          tt += t_step;
        }
      };
      int t = t_first, kc = 0;     // the chunk dequantized now
      int t1 = t, kc1 = kc;        // the next one
      advance(t1, kc1);
      int t2 = t1, kc2 = kc1;      // the one after
      advance(t2, kc2);
      if (t < t_count) fetch_raw<KIND, PACKED>(cur, a, 0, n_of(t), cg, rg);
      if (DEEP && t1 < t_count)
        fetch_raw<KIND, PACKED>(nxt, a, kc1 * BK, n_of(t1), cg, rg);
      int stage = 0;
      uint32_t phase = 0;
      while (t < t_count) {
        const int m0 = (LN ? t : t / ntn) * BM;
        if (DEEP) {
          if (t2 < t_count)
            fetch_raw<KIND, PACKED>(far, a, kc2 * BK, n_of(t2), cg, rg);
        } else if (t1 < t_count) {
          fetch_raw<KIND, PACKED>(nxt, a, kc1 * BK, n_of(t1), cg, rg);
        }
        mbar_wait(empty_bar(stage), phase ^ 1);
        if (pt == 0) {
          mbar_expect_tx(full_bar(stage), (uint32_t)k1_a_bytes(BM));
          tma_load_2d(a_tiles + stage * (uint32_t)k1_a_bytes(BM), &xmap,
                      kc * BK, m0, full_bar(stage));
        }
        store_b<KIND, PACKED>(cur, b_tiles + stage * B_TILE_BYTES, cg, rg,
                              nf4);
        // the generic-proxy stores become visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full_bar(stage));
        cur = nxt;
        if (DEEP) nxt = far;
        t = t1;
        kc = kc1;
        t1 = t2;
        kc1 = kc2;
        advance(t2, kc2);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }  // K1's producer
    if (LN) cluster_sync_all();
  } else {
    // ---- consumers: wgmma on the ring, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        K1_CONSUMER_REGS));
    const int wg = tid / 128;
    const int w4 = (tid % 128) / 32;
    const int lane = tid % 32;
    float acc[MT][64];
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    int xstep = 0;  // LayerNorm exchanges so far (buffer = xstep & 1)
    // this thread's rows of the tile (block-local): [mt][half]
    int rows[2 * MT];
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i)
      rows[i] = wg * (BM / 2) + (i / 2) * 64 + w4 * 16 + (lane >> 2) +
                8 * (i % 2);
    const int cq = 2 * (lane & 3);  // this thread's column pair in an 8
    if (LN) {
      // a LayerNorm block's N tile is its rank for the whole kernel: its
      // bias, LN scale and LN bias (0 past N) go to shared memory once
      for (int c = tid; c < BN; c += 256) {
        const int gc = rank * BN + c;
        const bool ok = gc < a.N;
        lnp[0][c] = ok && !I8 ? a.bias[gc] : 0.f;  // K3: in its rescale
        lnp[1][c] = ok ? a.lns[gc] : 0.f;
        lnp[2][c] = ok ? a.lnb[gc] : 0.f;
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // consumers only
    }

    for (int t = t_first; t < t_count; t += t_step) {
      const int m0 = (LN ? t : t / ntn) * BM;
      const int n0 = LN ? rank * BN : (t % ntn) * BN;
      if (LN) {
        // the tile's residual rows go to shared memory while the products
        // run (16-byte copies, zeros past M and N), once the last tile's
        // output store has read the buffer
        if (tid == 0) bulk_wait_read();
        named_bar(1, 256);
#pragma unroll
        for (int k = 0; k < BM / 16; ++k) {
          const int vi = tid + 256 * k;
          const int r = vi >> 4, g = vi & 15;
          const bool ok = m0 + r < a.M && n0 + 8 * g < a.N;
          cp_async16_to(region + (g >> 3) * (BM * 128) + r * 128 +
                            (((g & 7) ^ (r & 7)) << 4),
                        ok ? a.res + (size_t)(m0 + r) * a.N + n0 + 8 * g
                           : a.res,
                        ok);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      // K3's s32 sums, this tile's only: the rescale below is their last
      // read, so they are not live beside acc through the epilogue (the
      // wgmma operands are read-write, so sums declared for the whole
      // walk would stay live into the next tile's first product)
      uint32_t iacc[I8 ? MT : 1][64];
      if constexpr (I8) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 64; ++i) iacc[mt][i] = 0u;
      }
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(full_bar(stage), phase);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (I8)
            fence_regs<64>(iacc[mt]);
          else
            fence_acc(acc[mt]);
        }
        wgmma_fence();
        const uint32_t at = a_tiles + stage * (uint32_t)k1_a_bytes(BM) +
                            (wg * MT) * 64 * 128;
        const uint32_t bt = b_tiles + stage * B_TILE_BYTES;
        // 4 steps of 32 bytes along K: k16 in bf16, k32 in s8
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint64_t da = sw128_desc(at + mt * 64 * 128 + kk * 32);
            const uint64_t db = sw128_desc(bt + kk * 32);
            if constexpr (I8)
              wgmma_s8_m64n128k32(iacc[mt], da, db, (kc | kk) != 0);
            else
              wgmma_m64n128k16(acc[mt], da, db, (kc | kk) != 0);
          }
        wgmma_commit();
        if (kc > 0) {  // the previous chunk's products are done: free it
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty_bar(prev));
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (I8)
          fence_regs<64>(iacc[mt]);
        else
          fence_acc(acc[mt]);
      }
      if (lane == 0) mbar_arrive(empty_bar(prev));

      // the epilogues walk this thread's columns outermost (a column's
      // bias and LayerNorm parameters load once, for all its rows) and
      // its 2 * MT rows inside: acc[i / 2][4 * j + 2 * (i % 2) + e] is row
      // rows[i], column n0 + 8 * j + cq + e
      const int nj = min(BN / 8, (a.N - n0 + 7) / 8);  // 8-column groups < N
      int grow[2 * MT];
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) grow[i] = m0 + rows[i];
      if constexpr (I8) rescale_s8<MT>(iacc, acc, a, grow, n0, nj, cq);
      float v[2 * MT];  // per row: partial sums, then absmax
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) v[i] = 0.f;

      if (!LN) {
        const uint32_t stage_wg = region + wg * OUT_STAGE_BYTES;
        const int m_wg = m0 + wg * (BM / 2);
        const int wt = tid % 128;
#define K1_TILED(E)                                                     \
  tiled_epilogue<E, MT, I8>(acc, a, &omap, stage_wg, lnp[wg], m_wg, n0, \
                            nj, w4, lane, wt, wg, v)
        switch (a.epi) {
          case EPI_NONE: K1_TILED(EPI_NONE); break;
          case EPI_BIAS: K1_TILED(EPI_BIAS); break;
          case EPI_GELU:
          case EPI_GELU_TANH: K1_TILED(EPI_GELU); break;
          default: K1_TILED(EPI_SILU); break;
        }
#undef K1_TILED
        if (a.emit != EMIT_NO) {
#pragma unroll
          for (int i = 0; i < 2 * MT; ++i) {
            const float amax = quad_max(v[i]);
            if ((lane & 3) == 0 && grow[i] < a.M)
              a.part[(size_t)(n0 / BN) * a.M + grow[i]] = amax;
          }
        }
        continue;
      }

      // residual + LayerNorm over the cluster's full rows: y = acc + bias
      // + res kept in acc (0 past N), then two exchanges (sum, then the
      // sum of squared deviations from the mean), normalize this block's
      // columns
      const bool writer = (lane & 3) == 0;
      const float inv_n = 1.0f / a.N;
      // the residual tile has landed (this thread's copies, then all's)
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      named_bar(1, 256);
      // (row rows[i], column pair 8j + cq) of the residual / output tile
      auto res_addr = [&](int i, int j) {
        return region + (j >> 3) * (BM * 128) + rows[i] * 128 +
               (((j & 7) ^ (rows[i] & 7)) << 4) + (cq << 1);
      };
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + cq;
          const bool ok = j < nj;
          float* p = &acc[i / 2][4 * j + 2 * (i % 2)];
          uint32_t rb;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rb)
                       : "r"(res_addr(i, j)));
          const float2 rv =
              __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&rb));
          const float y0 = ok ? (p[0] + lnp[0][c]) + rv.x : 0.f;
          const float y1 = ok ? (p[1] + lnp[0][c + 1]) + rv.y : 0.f;
          p[0] = y0;
          p[1] = y1;
          v[i] += y0 + y1;
        }
      }
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) v[i] = quad_sum(v[i]);
      exchange<MT, false>(v, xch + (xstep & 1) * a.cs * BM,
                          xch_bar(xstep & 1), a.cs, rank, BM,
                          (xstep >> 1) & 1, writer, tid / 32 * 8 + lane / 4);
      ++xstep;
      float mean[2 * MT];
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
        mean[i] = v[i] * inv_n;
        v[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int i = 0; i < 2 * MT; ++i) {
          const float* p = &acc[i / 2][4 * j + 2 * (i % 2)];
          const float d0 = p[0] - mean[i], d1 = p[1] - mean[i];
          v[i] += d0 * d0 + d1 * d1;
        }
      }
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) v[i] = quad_sum(v[i]);
      exchange<MT, false>(v, xch + (xstep & 1) * a.cs * BM,
                          xch_bar(xstep & 1), a.cs, rank, BM,
                          (xstep >> 1) & 1, writer, tid / 32 * 8 + lane / 4);
      ++xstep;
      float inv[2 * MT];
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
        inv[i] = rsqrtf(v[i] * inv_n + a.eps);
        v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if (j >= nj) break;
          const int c = 8 * j + cq;
          float* p = &acc[i / 2][4 * j + 2 * (i % 2)];
          const float o0 = (p[0] - mean[i]) * inv[i] * lnp[1][c] + lnp[2][c];
          const float o1 =
              (p[1] - mean[i]) * inv[i] * lnp[1][c + 1] + lnp[2][c + 1];
          p[0] = o0;
          p[1] = o1;
          // the output replaces the residual this thread read there
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(res_addr(i, j)),
                       "r"(pack2(o0, o1)) : "memory");
          v[i] = fmaxf(v[i], fmaxf(fabsf(o0), fabsf(o1)));
        }
      }
      if (a.emit != EMIT_ONLY) {
        // the block's BM x BN output: one TMA store per 64-column half,
        // clipped at M and N
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_bar(1, 256);
        if (tid == 0) {
          tma_store_2d(&omap, region, n0, m0);
          if (n0 + 64 < a.N)
            tma_store_2d(&omap, region + BM * 128, n0 + 64, m0);
          bulk_commit();
        }
      }
      if (a.emit == EMIT_NO) continue;
      // K1e: a third exchange gives the row absmax; each block writes the
      // codes of its own columns, rank 0 the row scale
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) v[i] = quad_max(v[i]);
      exchange<MT, true>(v, xch + (xstep & 1) * a.cs * BM,
                         xch_bar(xstep & 1), a.cs, rank, BM,
                         (xstep >> 1) & 1, writer, tid / 32 * 8 + lane / 4);
      ++xstep;
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
        const float so = fmaxf(v[i], 1e-12f) * INV127;
        v[i] = 1.0f / so;
        if (rank == 0 && writer && grow[i] < a.M) a.os[grow[i]] = so;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (j >= nj) break;
        const int gc = n0 + 8 * j + cq;
#pragma unroll
        for (int i = 0; i < 2 * MT; ++i) {
          if (grow[i] >= a.M) continue;
          const float* p = &acc[i / 2][4 * j + 2 * (i % 2)];
          const uint32_t c0 = __float2int_rn(p[0] * v[i]) & 0xff;
          const uint32_t c1 = __float2int_rn(p[1] * v[i]) & 0xff;
          *reinterpret_cast<uint16_t*>(a.o8 + (size_t)grow[i] * a.N + gc) =
              (uint16_t)(c0 | (c1 << 8));
        }
      }
    }
    if (tid % 128 == 0) bulk_wait();  // the last output stores are done
    if (LN) cluster_sync_all();
  }
}

// a row-major [rows, cols] matrix of bf16 (esize 2: x, out) or int8
// (esize 1: K3's q and w8t) as TMA boxes of 128 bytes of a row (64 bf16
// or 128 int8 values) x box_rows rows, 128-byte swizzled (loads: rows and
// columns past the matrix read as zeros; stores: clipped at its edges)
cudaError_t tensor_map(CUtensorMap* map, const void* p, int rows, int cols,
                       int esize, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(p), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the caches below are per device, indexed by the current one, which the
// caller sets to the operands' card before each launch (a launch on a
// device past MAX_DEVICES is refused)
constexpr int MAX_DEVICES = 64;

int sm_count(int dev) {
  static int n[MAX_DEVICES] = {};
  if (n[dev] == 0)
    cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

template <int KIND, bool PACKED, int BM, bool LN>
cudaError_t launch_k1(const CUtensorMap& xmap, const CUtensorMap& wmap,
                      const CUtensorMap& omap, const K1Args& a,
                      cudaStream_t stream) {
  auto kern = qmm_wgmma_kernel<KIND, PACKED, BM, LN>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const size_t smem = k1_smem_bytes(BM, LN, LN ? a.cs : 0);
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntm = (a.M + BM - 1) / BM;
  const int ntn = (a.N + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(K1_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (LN) {
    // clusters of cs blocks along N; as many clusters as fit at once
    // (persistent), each walking M tiles
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(a.cs, ntm);
    // clusters at once, by device and cs
    static int fits[MAX_DEVICES][K1_CLUSTER_MAX + 1] = {};
    int& fit = fits[dev][a.cs];
    if (fit == 0) {
      err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
      if (err != cudaSuccess) return err;
      if (fit < 1) return cudaErrorInvalidConfiguration;
    }
    cfg.gridDim = dim3(a.cs, ntm < fit ? ntm : fit);
  } else {
    const int tiles = ntm * ntn;
    const int sms = sm_count(dev);
    cfg.gridDim = dim3(tiles < sms ? tiles : sms);
  }
  void* args[] = {const_cast<CUtensorMap*>(&xmap),
                  const_cast<CUtensorMap*>(&wmap),
                  const_cast<CUtensorMap*>(&omap), const_cast<K1Args*>(&a)};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KIND, bool PACKED>
cudaError_t dispatch_k1(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const CUtensorMap& omap, const K1Args& a, int bm,
                        cudaStream_t stream) {
  const bool ln = a.epi == EPI_RES_LN;
  if (ln && bm == 256 && a.cs > K1_CLUSTER_BM256) return cudaErrorInvalidValue;
#define K1_MAPS xmap, wmap, omap, a, stream
  if (bm == 256)
    return ln ? launch_k1<KIND, PACKED, 256, true>(K1_MAPS)
              : launch_k1<KIND, PACKED, 256, false>(K1_MAPS);
  if (bm == 128)
    return ln ? launch_k1<KIND, PACKED, 128, true>(K1_MAPS)
              : launch_k1<KIND, PACKED, 128, false>(K1_MAPS);
#undef K1_MAPS
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K3: the int8 tensor-core mode
//
// Replaces: embeddings_tpu/ops/qmatmul.py:_qmm_int8 (with its sx_ref path,
// K3x, and _emit, K3e), the Pallas TPU kernel behind
// qmatmul(int8_compute=True). Computes the TPU kernel's result, not its
// block structure:
//     w   = level * scale (+ min)                          (f32)
//     cs  = max(max_k |w|, 1e-12) * (1/127)   per column n
//     w8  = rint(w * (1/cs))                               (int8)
//     sx  = max(max_k |x|, 1e-12) * (1/127)   per row m
//     q   = rint(x * (1/sx))                               (int8)
//     acc = sum_k q * w8                                   (s32)
//     out = epilogue((f32(acc) * cs) * sx + bias)          (f32, one bf16 store)
// rint rounds half to even, like the TPU's round(); the reciprocals are
// IEEE divisions (no fast math), and the products whose rounding the TPU
// keeps separate are written with __fmul_rn / __fadd_rn, so the int8
// operands equal the TPU's bit for bit.
//
// What bounds it on the H100: at the main-path shapes (M = 32,768 tokens,
// K, N in 768 .. 3,072) the product, 2 * M * N * K int8 operations at
// 1,979 TOP/s dense, or, at o-proj's 768 x 768, the bytes of x, the
// residual and the output. The design:
// - the weight is requantized once per weight, not once per call:
//   requant_kernel writes w8t [N, K] (K-contiguous, as int8 wgmma reads
//   both operands) and cs [N]; the wrapper keeps them with the weight
//   (the TPU kernel requantizes each N-tile in VMEM on every call: the
//   values are the same);
// - the rows quantize in a launch of their own (quant_rows_kernel) into
//   q [M, K] + sx [M], or arrive quantized (K3x: an emission of the
//   previous layer, or quantize_act; no launch);
// - the product is K1's kernel instantiated for S8: the same persistent
//   tile walk, ring, consumer warpgroups and epilogues, with q and w8t
//   both by TMA (int8 tensor maps, 128-byte swizzled chunks of 128 K
//   values) issued by one producer thread, s8 x s8 -> s32 on wgmma
//   m64n128k32, and the rescale (rescale_s8) in front of the epilogue;
//   the residual-LayerNorm epilogue runs as K1's cluster along N, and
//   K3e's emission is K1e's.
// ---------------------------------------------------------------------------

constexpr int RQ_BK = 64;  // requant_kernel: K rows per staged tile

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

// the weight's per-column requantization into w8t [N, K] and cs [N]
// (once per weight): block = 32 columns x 8 row groups
template <int KIND, bool PACKED>
__global__ void __launch_bounds__(256) requant_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ scales,
    const float* __restrict__ mins, int8_t* __restrict__ w8t,
    float* __restrict__ cs, int N, int K) {
  __shared__ float red[8][32];
  __shared__ float inv[32];
  __shared__ __align__(16) int8_t tile[32][RQ_BK + 4];
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
  for (int k0 = 0; k0 < K; k0 += RQ_BK) {
    if (ok)
      for (int kk = rg; kk < RQ_BK && k0 + kk < K; kk += 8)
        tile[cg][kk] = static_cast<int8_t>(__float2int_rn(
            wval<KIND, PACKED>(codes, scales, mins, N, k0 + kk, n) *
            inv[cg]));
    __syncthreads();
    // transposed write-out: column c's 64 bytes as 16 words, K-contiguous
    for (int wi = threadIdx.x; wi < 32 * (RQ_BK / 4); wi += 256) {
      const int c = wi / (RQ_BK / 4);
      const int kw = (wi % (RQ_BK / 4)) * 4;
      if (c < ncols && k0 + kw < K)
        *reinterpret_cast<uint32_t*>(w8t + (size_t)(n0 + c) * K + k0 + kw) =
            *reinterpret_cast<const uint32_t*>(&tile[c][kw]);
    }
    __syncthreads();
  }
}

// the rows' quantization into q [M, K] and sx [M]: one warp per row, 8
// rows a block. NV > 0: the row is held in registers (NV 16-byte loads a
// lane, K <= 256 * NV), so x is read once; NV == 0: any K, two passes
// over the row (its second read mostly from cache)
template <int NV>
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
    float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * K;
  int8_t* qr = q + (size_t)row * K;
  float m = 0.f;
  if constexpr (NV > 0) {
    uint4 raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (lane + 32 * i) * 8;
      raw[i] = c < K ? *reinterpret_cast<const uint4*>(xr + c)
                     : make_uint4(0u, 0u, 0u, 0u);
      float v[8];
      unpack8(raw[i], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
    }
    const float s = fmaxf(warp_max(m), 1e-12f) * INV127;
    const float inv = 1.0f / s;
    if (lane == 0) sx[row] = s;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= K) break;
      float v[8];
      unpack8(raw[i], v);
      *reinterpret_cast<uint2*>(qr + c) = codes8(v, inv);
    }
  } else {
    for (int c = lane * 8; c < K; c += 256) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
    }
    const float s = fmaxf(warp_max(m), 1e-12f) * INV127;
    const float inv = 1.0f / s;
    if (lane == 0) sx[row] = s;
    for (int c = lane * 8; c < K; c += 256) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
      *reinterpret_cast<uint2*>(qr + c) = codes8(v, inv);
    }
  }
}

template <int KIND, bool PACKED>
cudaError_t requant(const void* codes, const void* scales, const void* mins,
                    void* w8t, void* cs, int N, int K, cudaStream_t stream) {
  requant_kernel<KIND, PACKED><<<(N + 31) / 32, 256, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const float*>(mins), static_cast<int8_t*>(w8t),
      static_cast<float*>(cs), N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. All pointers are device pointers; mins, bias, res, lns, lnb may be
// null where the kind / epilogue does not read them. Shapes: x [M, K]
// bf16, codes [K, N] int8 or [K/2, N] uint8 (packed), scales/mins [K/32,
// N] f32, bias/lns/lnb [N] f32, res/out [M, N] bf16. emit: 0 none, 1 both
// (out and o8 [M, N] int8 + os [M] f32), 2 only (o8 and os; out may be
// null); with emission and an epilogue other than residual + LayerNorm,
// stg f32 [M, N] and part f32 [ceil(N/128), M] are scratch (else may be
// null). bm: the tile's rows, 128 or 256 (the caller's choice by shape).
// Requires N % 8 == 0, K % 32 == 0 (K % 64 == 0 when packed), N <= 16 *
// 128 with residual + LayerNorm, 16-byte aligned pointers. Returns a
// cudaError_t; a cluster the card cannot place is refused, not rerouted.
int qmm_launch(const void* x, const void* codes, const void* scales,
               const void* mins, const void* bias, const void* res,
               const void* lns, const void* lnb, void* out, void* o8,
               void* os, void* stg, void* part, int M, int N, int K,
               int kind, int packed, int epi, int emit, int bm, float eps,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cs = (N + BN - 1) / BN;
  if (N % 8 || K % 32 || (packed && K % 64) || M < 1) return cudaErrorInvalidValue;
  if (epi == EPI_RES_LN && cs > K1_CLUSTER_MAX) return cudaErrorInvalidValue;
  CUtensorMap xmap, omap;
  cudaError_t err = tensor_map(&xmap, x, M, K, 2, bm);
  if (err != cudaSuccess) return err;
  // the output's TMA boxes: a warpgroup's 64 rows (tiled epilogues) or
  // the block's bm rows (LayerNorm); with emission "only" there is no
  // out and the map is never used
  err = tensor_map(&omap, out ? out : x, M, out ? N : K, 2,
                   epi == EPI_RES_LN ? bm : 64);
  if (err != cudaSuccess) return err;
  const K1Args a{static_cast<const uint8_t*>(codes),
                 static_cast<const float*>(scales),
                 static_cast<const float*>(mins),
                 static_cast<const float*>(bias),
                 static_cast<const __nv_bfloat16*>(res),
                 static_cast<const float*>(lns),
                 static_cast<const float*>(lnb),
                 static_cast<__nv_bfloat16*>(out),
                 static_cast<int8_t*>(o8),
                 static_cast<float*>(os),
                 static_cast<float*>(stg),
                 static_cast<float*>(part),
                 M, N, K, epi, emit, epi == EPI_RES_LN ? cs : 0, eps,
                 nullptr, nullptr};
  // (K1 reads no weight map: xmap stands in for it)
#define K1_ARGS xmap, xmap, omap, a, bm, st
  switch (kind * 2 + (packed ? 1 : 0)) {
    case Q4_0 * 2: err = dispatch_k1<Q4_0, false>(K1_ARGS); break;
    case Q4_0 * 2 + 1: err = dispatch_k1<Q4_0, true>(K1_ARGS); break;
    case Q4_1 * 2: err = dispatch_k1<Q4_1, false>(K1_ARGS); break;
    case Q4_1 * 2 + 1: err = dispatch_k1<Q4_1, true>(K1_ARGS); break;
    case Q8_0 * 2: err = dispatch_k1<Q8_0, false>(K1_ARGS); break;
    case NF4 * 2: err = dispatch_k1<NF4, false>(K1_ARGS); break;
    case NF4 * 2 + 1: err = dispatch_k1<NF4, true>(K1_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef K1_ARGS
  if (err != cudaSuccess || epi == EPI_RES_LN || emit == EMIT_NO) return err;
  return emit_rows(EmitArgs{o8, os, stg, part, emit}, M, N, st);
}

// K3's weight requantization (once per weight): codes, scales, mins as
// qmm_launch; w8t [N, K] int8 and cs [N] f32 outputs. Requires K % 32 ==
// 0 (K % 64 == 0 packed). Returns a cudaError_t.
int qmm_requant_launch(const void* codes, const void* scales,
                       const void* mins, void* w8t, void* cs, int N, int K,
                       int kind, int packed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || K % 32 || (packed && K % 64)) return cudaErrorInvalidValue;
#define RQ_ARGS codes, scales, mins, w8t, cs, N, K, st
  switch (kind * 2 + (packed ? 1 : 0)) {
    case Q4_0 * 2: return requant<Q4_0, false>(RQ_ARGS);
    case Q4_0 * 2 + 1: return requant<Q4_0, true>(RQ_ARGS);
    case Q4_1 * 2: return requant<Q4_1, false>(RQ_ARGS);
    case Q4_1 * 2 + 1: return requant<Q4_1, true>(RQ_ARGS);
    case Q8_0 * 2: return requant<Q8_0, false>(RQ_ARGS);
    case NF4 * 2: return requant<NF4, false>(RQ_ARGS);
    case NF4 * 2 + 1: return requant<NF4, true>(RQ_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef RQ_ARGS
}

// K3's row quantization: x [M, K] bf16 -> q [M, K] int8 + sx [M] f32.
// Requires K % 8 == 0, 16-byte aligned rows. Returns a cudaError_t.
int qmm_quant_rows_launch(const void* x, void* q, void* sx, int M, int K,
                          void* stream) {
  if (M < 1 || K % 8) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* q8 = static_cast<int8_t*>(q);
  auto* s = static_cast<float*>(sx);
  const dim3 grid((M + 7) / 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = (K + 255) / 256;  // 16-byte loads a lane
  if (nv <= 4)
    quant_rows_kernel<4><<<grid, 256, 0, st>>>(xb, q8, s, M, K);
  else if (nv <= 8)
    quant_rows_kernel<8><<<grid, 256, 0, st>>>(xb, q8, s, M, K);
  else if (nv <= 16)
    quant_rows_kernel<16><<<grid, 256, 0, st>>>(xb, q8, s, M, K);
  else
    quant_rows_kernel<0><<<grid, 256, 0, st>>>(xb, q8, s, M, K);
  return cudaGetLastError();
}

// K3's product: q [M, K] int8 (16-byte aligned) with its row scales sx
// [M] f32 against the kept weight w8t [N, K] int8 with its column scales
// cs [N] f32, rescaled, then the epilogue; bias, res, lns, lnb, out, o8,
// os, stg, part, epi, emit and bm as qmm_launch (K3e: the emission). One
// launch of qmm_wgmma_kernel<S8, false, bm, LN> (plus emit_rows_kernel
// for a tiled epilogue's emission). Requires N % 8 == 0, K % 32 == 0, N
// <= 16 * 128 with residual + LayerNorm. Returns a cudaError_t.
int qmm_int8_launch(const void* q, const void* sx, const void* w8t,
                    const void* cs, const void* bias, const void* res,
                    const void* lns, const void* lnb, void* out, void* o8,
                    void* os, void* stg, void* part, int M, int N, int K,
                    int epi, int emit, int bm, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ncs = (N + BN - 1) / BN;
  if (N % 8 || K % 32 || M < 1) return cudaErrorInvalidValue;
  if (epi == EPI_RES_LN && ncs > K1_CLUSTER_MAX) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, omap;
  cudaError_t err = tensor_map(&xmap, q, M, K, 1, bm);
  if (err != cudaSuccess) return err;
  err = tensor_map(&wmap, w8t, N, K, 1, BN);
  if (err != cudaSuccess) return err;
  // (as qmm_launch: with emission "only" the output map is never used)
  err = tensor_map(&omap, out ? out : w8t, out ? M : N, out ? N : K,
                   out ? 2 : 1, epi == EPI_RES_LN ? bm : 64);
  if (err != cudaSuccess) return err;
  const K1Args a{nullptr, nullptr, nullptr,
                 static_cast<const float*>(bias),
                 static_cast<const __nv_bfloat16*>(res),
                 static_cast<const float*>(lns),
                 static_cast<const float*>(lnb),
                 static_cast<__nv_bfloat16*>(out),
                 static_cast<int8_t*>(o8),
                 static_cast<float*>(os),
                 static_cast<float*>(stg),
                 static_cast<float*>(part),
                 M, N, K, epi, emit, epi == EPI_RES_LN ? ncs : 0, eps,
                 static_cast<const float*>(cs),
                 static_cast<const float*>(sx)};
  err = dispatch_k1<S8, false>(xmap, wmap, omap, a, bm, st);
  if (err != cudaSuccess || epi == EPI_RES_LN || emit == EMIT_NO) return err;
  return emit_rows(EmitArgs{o8, os, stg, part, emit}, M, N, st);
}

const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
