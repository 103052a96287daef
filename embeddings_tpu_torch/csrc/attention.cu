// Fused multi-head self-attention over the fused QKV projection, for
// sm_90a: kernels K5 and K6w of the PyTorch port and K2's int8-scores
// mode (K2i8, with or without emission), as mask modes of one WMMA kernel
// and the int8 kernel attn_i8_kernel. K2 (with its emission K2e), K4
// (with its emission K4e), K7, K6, K6c, K6ca and the context-parallel
// K8a and K8b run on the Hopper kernel in attention_sm90.cu (wgmma, a TMA
// ring); ops/attention.py:attention_kernel routes, and this library
// refuses those modes (0 without int8 scores, 1, 3, 4, 5, 7 and 8).
//
// Replaces (embeddings_tpu/ops/attention.py, the Pallas TPU kernels):
//   mode 2, K5: _attn_kernel_seg_window, behind
//               fused_attention_segmented_blockskip();
//   mode 6, K6w: _attn_kernel_stream in its span + window (banded) mode,
//               behind fused_attention_window() (ModernBERT's local
//               layers).
// For each sequence (packed row) b, head h and query i, reading q, k and
// v as column slices of the fused qkv [B*L, 3E] (q at h*D, k at E + h*D,
// v at 2E + h*D), with d = q . k_j accumulated in f32:
//   mode 2: s = clamp(d * s2, -100, hi) (scaled after the dot, in f32, as
//           the TPU's kernels do), key j valid iff seg[b,i] == seg[b,j]
//           and seg[b,j] >= 0, over key blocks kbs .. min(kbs + W - 1,
//           kbe) of the query's 128-row block only (block_ranges); blocks
//           past the cap W are dropped, every other key block is skipped
//           unread;
//   mode 6: s = clamp(d * s2, -100, hi), key j valid iff j < len[b] and
//           |i - j| <= W (W = window // 2), over the 64-key tiles that
//           meet [q0 - W, q_last + W] only: O(L * window) work;
//   p_j = bf16(exp2(s)) if valid else 0
//   out = (sum_j p_j v_j) / max(sum_j p_j, 1e-30)           (f32 sums)
// written as bf16 to ctx [B*L, E] at column h*D. s2 = log2(e)/sqrt(D);
// hi = 127 - ceil(log2 n) for n = min(W*128, L) keys in mode 2; in mode 6
// n is the whole row L, as the TPU's _stream_call sizes it, not the band.
// There is no max-subtraction: the clamp keeps exp2 and the sum finite
// for any row length, as in the TPU kernels, so key tiles only ADD into
// the output and the denominator; nothing is rescaled. A row with no
// valid key (len 0, or a pad query) gives exactly 0. Mode 6 skips the
// tiles outside the band and those wholly past len[b]: every p there is
// an exact zero. The multiply-adds the plain version rounds separately
// are written __fmul_rn / __fadd_rn, so nvcc's FMA contraction cannot
// change a score.
//
// What bounds it on the H100: at 32,768 packed tokens (mode 2 at L=1024,
// W=3) the function moves ~201 MB (qkv in, context out) for ~19 GFLOP,
// so it is bound by device memory, not by the tensor cores. At K6w's
// (mode 6) 32,768 tokens and window 128 the same 201 MB carries ~13
// GFLOP: bound by bytes; a 64-query block walks 3 key tiles (129 keys of
// the band, at most 192 visited). The design reads q, k and v in place
// from the fused projection (no transpose pass through memory), and
// keeps scores and probabilities in shared memory and registers: one
// block per (64-query tile, head, sequence), 4 warps of 16 query rows,
// 64-key tiles of K and V (and their segment ids) staged in shared
// memory, both products on the tensor cores (WMMA bf16, f32
// accumulators). Not yet used here: cp.async/TMA double buffering of the
// key tiles and wgmma (attention_sm90.cu has both).
//
// K2i8's emission (replaces embeddings_tpu/ops/attention.py:
// _emit_int8_rows, called from _attn_kernel's int8-scores branch): the
// context is also ("both") or instead ("only") written per-row symmetric
// int8 over all E = H*D columns, so = max(max_e |ctx|, 1e-30) * (1/127),
// o8 = rint(ctx * (1/so)); "both" quantizes the bf16-rounded context it
// writes, "only" the f32 one (the TPU's f32 staging). The row absmax
// spans every head, but a block holds one head: the H blocks of one query
// tile run as a thread-block cluster (H <= 16, non-portable above 8) and
// read each other's per-row maxima through distributed shared memory, so
// the context never makes a round trip through device memory.
//
// K2i8, int8 scores (replaces the int8_scores branch of _attn_kernel;
// attn_i8_kernel below, prefix mask only): both products run s8 x s8 ->
// s32 on the tensor cores (mma.sync m16n8k32). Per head: q and k rows
// and v columns (over all L rows, pads included) quantize symmetrically
// with the floor 1e-30 (q not pre-scaled); s = (f32(s32) * (sq * s2)) *
// sk, keys j >= len[b] at -1e30; m = the max of s over the whole key row;
// p8 = rint(exp2(s - m + log2(127))) in [0, 127]; out = (f32(p8 . v8) *
// sv) * (127 / max(f32(127 * sum p8), 1)). m and sv need the whole row
// before the first p8, so a block makes a pre-pass over v's column
// maxima and one over the key tiles for m, then the product pass. A
// len-0 row has m = -1e30 and p8 = 127 on every key, as on the TPU.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "int8_rows.cuh"

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

constexpr int QT = 64;        // query rows per block
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int SP = KT + 4;    // f32 score staging row stride
constexpr int PP = KT + 8;    // bf16 probability row stride
constexpr int BQ = 128;       // query/key block of mode 2 (block_ranges)

// modes 0 without int8 scores, 1, 3, 4, 5, 7 and 8 are attention_sm90.cu's
enum Mode { PREFIX = 0, WINDOW = 2, BAND = 6 };
constexpr float LOG2_127 = 6.9886846867721655f;
constexpr int MAX_CLUSTER = 16;  // heads a cluster can hold (H100)
constexpr float ABSENT = -3.0e38f;  // K2i8's score of a key past L

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
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}


template <int D>
struct Layout {
  static constexpr int DP = D + 8;                  // bf16 q/k/v row stride
  static constexpr int OP = D + 4;                  // f32 output staging
  static constexpr int F = 16 * (SP > OP ? SP : OP);  // f32 per warp
  static constexpr size_t qkv_bytes = 3ull * 64 * DP * sizeof(__nv_bfloat16);
  static constexpr size_t f_bytes = 4ull * F * sizeof(float);
  static constexpr size_t p_bytes = 4ull * 16 * PP * sizeof(__nv_bfloat16);
  static constexpr size_t smem = qkv_bytes + f_bytes + p_bytes;
};

// The last step of every mode: this warp's 16 query rows of one head,
// parked as f32 in fsc (row stride D + 4), times inv, written as bf16 to
// out at row orow (unless EMIT_ONLY), and with emission quantized per
// row over all H heads: each block posts its rows' absmax in crow [QT],
// the cluster of the query tile's H blocks syncs, each block takes the
// maximum over the H posts through distributed shared memory and writes
// its head's codes; head 0 writes the scale. Every thread of the block
// must call it (the cluster barrier).
template <int D, int EMIT>
__device__ __forceinline__ void finish_rows(
    const float* fsc, float inv, int qrow, int L, size_t orow, int h, int E,
    __nv_bfloat16* __restrict__ out, int8_t* __restrict__ o8,
    float* __restrict__ os, float* crow) {
  constexpr int OP = Layout<D>::OP;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (D / 2);
  float amax = 0.f;
  for (int c = c0; c < c0 + D / 2; c += 8) {
    float f[8];
    for (int e = 0; e < 8; ++e) f[e] = fsc[r * OP + c + e] * inv;
    if (EMIT != EMIT_ONLY && qrow < L)
      *reinterpret_cast<uint4*>(out + orow * E + h * D + c) = pack8(f);
    for (int e = 0; e < 8; ++e)
      amax = fmaxf(amax, fabsf(EMIT == EMIT_BOTH ? bf16r(f[e]) : f[e]));
  }
  if constexpr (EMIT != EMIT_NO) {
    const int lr = (threadIdx.x / 32) * 16 + r;
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    if ((lane & 1) == 0) crow[lr] = amax;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    float m = 0.f;
    for (unsigned k = 0; k < cluster.num_blocks(); ++k)
      m = fmaxf(m, cluster.map_shared_rank(crow, k)[lr]);
    cluster.sync();  // no block leaves while a peer still reads its crow
    const float so = fmaxf(m, 1e-30f) * INV127;
    const float rs = 1.0f / so;
    if (qrow < L) {
      for (int c = c0; c < c0 + D / 2; c += 8) {
        float f[8];
        for (int e = 0; e < 8; ++e) {
          f[e] = fsc[r * OP + c + e] * inv;
          if (EMIT == EMIT_BOTH) f[e] = bf16r(f[e]);
        }
        *reinterpret_cast<uint2*>(o8 + orow * E + h * D + c) = codes8(f, rs);
      }
      if (h == 0 && (lane & 1) == 0) os[orow] = so;
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(THREADS) attn_kernel(
    const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ lengths,
    const int* __restrict__ seg, const int* __restrict__ kbs,
    const int* __restrict__ kbe, __nv_bfloat16* __restrict__ out, int L,
    int H, int W, float s2, float hi) {
  using Lay = Layout<D>;
  constexpr int DP = Lay::DP;
  constexpr int OP = Lay::OP;
  constexpr int F = Lay::F;
  constexpr int DV = D / 8;  // 16-byte vectors per head row

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int segk[KT];  // the key tile's segment ids (mode 2)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [QT][DP]
  __nv_bfloat16* ks = qs + QT * DP;                              // [KT][DP]
  __nv_bfloat16* vs = ks + KT * DP;                              // [KT][DP]
  float* fbase = reinterpret_cast<float*>(smem + Lay::qkv_bytes);
  __nv_bfloat16* pbase =
      reinterpret_cast<__nv_bfloat16*>(smem + Lay::qkv_bytes + Lay::f_bytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = H * D;
  const size_t ld = 3 * (size_t)E;
  const int len = MODE == BAND ? lengths[b] : 0;
  const __nv_bfloat16* rows = qkv + (size_t)b * L * ld;
  float* fsc = fbase + warp * F;
  __nv_bfloat16* ps = pbase + warp * 16 * PP;

  // q tile (the scores are scaled after the dot, in f32)
  for (int v = tid; v < QT * DV; v += THREADS) {
    const int r = v / DV;
    const int c = (v % DV) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (q0 + r < L)
      u = *reinterpret_cast<const uint4*>(rows + (size_t)(q0 + r) * ld +
                                          h * D + c);
    *reinterpret_cast<uint4*>(qs + r * DP + c) = u;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[D / 16];
  for (int d = 0; d < D / 16; ++d)
    wmma::load_matrix_sync(qa[d], qs + warp * 16 * DP + d * 16, DP);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
  for (int d = 0; d < D / 16; ++d) wmma::fill_fragment(acc[d], 0.0f);
  float rowsum = 0.f;

  const int r = lane >> 1;          // this lane's query row in the warp
  const int c0 = (lane & 1) * 32;   // and its half of the key tile
  const int qrow = q0 + warp * 16 + r;
  const int sq = (MODE == WINDOW && qrow < L)
                     ? seg[(size_t)b * L + qrow] : -1;
  int k_begin = 0, k_end = L;
  if (MODE == WINDOW) {
    // key blocks kbs .. min(kbs + W - 1, kbe) of this 128-query block
    const int nQ = L / BQ;
    const int qb = q0 / BQ;
    const int lo = kbs[b * nQ + qb];
    const int last = min(lo + W - 1, kbe[b * nQ + qb]);
    k_begin = lo * BQ;
    k_end = last >= lo ? (last + 1) * BQ : k_begin;
  }
  if (MODE == BAND) {
    // the 64-key tiles that meet [q0 - W, q0 + QT - 1 + W] (W = window //
    // 2), short of the first tile wholly past len[b] (tiles past it would
    // add exact zeros)
    k_begin = max(0, q0 - W) / KT * KT;
    k_end = min(min(L, (len + KT - 1) / KT * KT),
                (q0 + QT - 1 + W) / KT * KT + KT);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    if (MODE == WINDOW && tid < KT)
      segk[tid] = k0 + tid < L ? seg[(size_t)b * L + k0 + tid] : -1;
    for (int v = tid; v < KT * DV; v += THREADS) {
      const int kr = v / DV;
      const int c = (v % DV) * 8;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + kr < L) {
        const __nv_bfloat16* src =
            rows + (size_t)(k0 + kr) * ld + E + h * D + c;
        kk = *reinterpret_cast<const uint4*>(src);
        vv = *reinterpret_cast<const uint4*>(src + E);
      }
      *reinterpret_cast<uint4*>(ks + kr * DP + c) = kk;
      *reinterpret_cast<uint4*>(vs + kr * DP + c) = vv;
    }
    __syncthreads();

    // scores for this warp's 16 queries x 64 keys
    for (int n = 0; n < KT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
      for (int d = 0; d < D / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + n * 16 * DP + d * 16, DP);
        wmma::mma_sync(s, qa[d], kb, s);
      }
      wmma::store_matrix_sync(fsc + n * 16, s, SP, wmma::mem_row_major);
    }
    __syncwarp();
    for (int c4 = c0; c4 < c0 + 32; c4 += 4) {
      for (int e = 0; e < 4; ++e) {
        const int c = c4 + e;
        const int kj = k0 + c;
        bool ok = MODE == BAND ? kj < len : segk[c] == sq && segk[c] >= 0;
        if constexpr (MODE == BAND) ok = ok && abs(qrow - kj) <= W;
        const float raw = fsc[r * SP + c] * s2;
        const float sc = fminf(fmaxf(raw, -100.0f), hi);
        const float p = ok ? exp2f(sc) : 0.0f;
        const __nv_bfloat16 pb = __float2bfloat16_rn(p);
        ps[r * PP + c] = pb;
        rowsum += __bfloat162float(pb);
      }
    }
    __syncwarp();

    // acc += P V
    for (int kc = 0; kc < KT / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa;
      wmma::load_matrix_sync(pa, ps + kc * 16, PP);
      for (int d = 0; d < D / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kc * 16 * DP + d * 16, DP);
        wmma::mma_sync(acc[d], pa, vb, acc[d]);
      }
    }
  }

  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
  __syncwarp();
  for (int d = 0; d < D / 16; ++d)
    wmma::store_matrix_sync(fsc + d * 16, acc[d], OP, wmma::mem_row_major);
  __syncwarp();
  finish_rows<D, EMIT_NO>(fsc, 1.0f / fmaxf(rowsum, 1e-30f), qrow, L,
                          (size_t)b * L + qrow, h, E, out, nullptr, nullptr,
                          nullptr);
}

// int8 scores (K2i8): the shared-memory layout of one block (bytes). q8
// and k8 rows hold D codes (row stride D + 16), vt holds v8 transposed
// ([D][KT], stride KT + 16) so both products read K-contiguous operands,
// p8 one warp's 16 x KT probabilities, fo the f32 outputs for
// finish_rows.
template <int D>
struct I8Layout {
  static constexpr int KP = D + 16;
  static constexpr int TP = KT + 16;
  static constexpr size_t q8 = 0;
  static constexpr size_t k8 = q8 + (size_t)QT * KP;
  static constexpr size_t vt = k8 + (size_t)KT * KP;
  static constexpr size_t p8 = vt + (size_t)D * TP;
  static constexpr size_t fo = p8 + 4ull * 16 * TP;
  static constexpr size_t smem = fo + 4ull * 16 * Layout<D>::OP * 4;
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one 16-row A fragment of m16n8k32 (rows g, g + 8; bytes k0 + 4t4 ..)
// from a row-major int8 tile with row stride ld
__device__ __forceinline__ void frag_a(uint32_t* a, const int8_t* base,
                                       int ld, int g, int t4, int k0) {
  const int8_t* p = base + g * ld + k0 + t4 * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 16);
}

// 64 rows of D bf16 values at src (row stride ld, rows past nrows read as
// 0), quantized per row: codes to dst [64][ldd] (transposed to dst
// [D][ldd] when TRANS, with per-column scales cscale instead), row
// scales to rsc. Two threads a row, D/2 columns each.
template <int D, bool TRANS>
__device__ __forceinline__ void quant_tile(
    const __nv_bfloat16* __restrict__ src, size_t ld, int nrows,
    int8_t* dst, int ldd, float* rsc, const float* cscale) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (D / 2);
  const bool ok = r < nrows;
  float rs = 1.0f;
  if (!TRANS) {
    float m = 0.f;
    for (int c = c0; c < c0 + D / 2 && ok; c += 8) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(src + r * ld + c), v);
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    const float s = fmaxf(m, 1e-30f) * INV127;
    rs = 1.0f / s;
    if ((threadIdx.x & 1) == 0) rsc[r] = s;
  }
  for (int c = c0; c < c0 + D / 2; c += 8) {
    float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (ok) unpack8(*reinterpret_cast<const uint4*>(src + r * ld + c), v);
    if (TRANS) {
      for (int e = 0; e < 8; ++e)
        dst[(c + e) * ldd + r] =
            static_cast<int8_t>(__float2int_rn(v[e] * (1.0f / cscale[c + e])));
    } else {
      *reinterpret_cast<uint2*>(dst + r * ldd + c) = codes8(v, rs);
    }
  }
}

template <int D, int EMIT>
__global__ void __launch_bounds__(THREADS) attn_i8_kernel(
    const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int8_t* __restrict__ o8,
    float* __restrict__ os, int L, int H, float s2) {
  using Lay = I8Layout<D>;
  constexpr int KP = Lay::KP;
  constexpr int TP = Lay::TP;
  constexpr int OP = Layout<D>::OP;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + Lay::q8);
  int8_t* k8 = reinterpret_cast<int8_t*>(smem + Lay::k8);
  int8_t* vt = reinterpret_cast<int8_t*>(smem + Lay::vt);
  __shared__ float sq[QT], sk[KT], sv[128], red[THREADS], crow[QT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = H * D;
  const size_t ld = 3 * (size_t)E;
  const int len = lengths[b];
  const __nv_bfloat16* rows = qkv + (size_t)b * L * ld;
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + Lay::p8) + warp * 16 * TP;
  float* fo = reinterpret_cast<float*>(smem + Lay::fo) + warp * 16 * OP;

  // v's per-column scales over all L rows of the head (pads included)
  {
    constexpr int RS = THREADS / D > 0 ? THREADS / D : 1;
    const int d = tid % D;
    float m = 0.f;
    if (tid < RS * D)
      for (int j = tid / D; j < L; j += RS)
        m = fmaxf(m, fabsf(__bfloat162float(
                         rows[(size_t)j * ld + 2 * E + h * D + d])));
    red[tid] = m;
    __syncthreads();
    if (tid < D) {
      for (int k = 1; k < RS; ++k) m = fmaxf(m, red[tid + k * D]);
      sv[tid] = fmaxf(m, 1e-30f) * INV127;
    }
  }
  // this block's query rows, quantized per row (q is not pre-scaled)
  quant_tile<D, false>(rows + (size_t)q0 * ld + h * D, ld, L - q0, q8, KP,
                       sq, nullptr);
  __syncthreads();

  // a len-0 row keeps every key (all at -1e30, p8 = 127), as the TPU's
  // whole-row tile does; otherwise tiles past len add exact zeros
  const int k_end = len > 0 ? min(L, (len + KT - 1) / KT * KT) : L;
  float qs2[2];
  for (int hh = 0; hh < 2; ++hh) qs2[hh] = __fmul_rn(sq[warp * 16 + g + hh * 8], s2);

  // scores of this warp's rows g, g + 8 against key tile k0 into sc[8][4]
  auto scores = [&](int k0, float (&sc)[8][4]) {
    int acc[8][4];
    for (int j = 0; j < 8; ++j)
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    for (int kk = 0; kk < D; kk += 32) {
      uint32_t a[4];
      frag_a(a, q8 + warp * 16 * KP, KP, g, t4, kk);
      for (int j = 0; j < 8; ++j) {
        const int8_t* p = k8 + (j * 8 + g) * KP + kk + t4 * 4;
        mma_s8(acc[j], a, *reinterpret_cast<const uint32_t*>(p),
               *reinterpret_cast<const uint32_t*>(p + 16));
      }
    }
    for (int j = 0; j < 8; ++j)
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + t4 * 2 + (e & 1);
        const int kj = k0 + kl;
        const float s = __fmul_rn(__fmul_rn((float)acc[j][e], qs2[e >> 1]),
                                  sk[kl]);
        // keys past len are masked; keys past L do not exist (ABSENT:
        // below every real score, and exp2 of it is 0 at any m)
        sc[j][e] = kj >= L ? ABSENT : kj >= len ? -1e30f : s;
      }
  };
  auto load_k = [&](int k0) {
    __syncthreads();  // every warp is done with the previous tile
    quant_tile<D, false>(rows + (size_t)k0 * ld + E + h * D, ld, L - k0, k8,
                         KP, sk, nullptr);
  };

  // pass 1: the row max m over the whole key row
  float m[2] = {ABSENT, ABSENT};
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    load_k(k0);
    __syncthreads();
    float sc[8][4];
    scores(k0, sc);
    for (int j = 0; j < 8; ++j)
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], sc[j][e]);
  }
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
  }

  // pass 2: p8 = rint(exp2(s - m + log2 127)), acc += p8 . v8, den += p8
  int pacc[D / 8][4];
  for (int j = 0; j < D / 8; ++j)
    for (int e = 0; e < 4; ++e) pacc[j][e] = 0;
  int den[2] = {0, 0};
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    load_k(k0);
    quant_tile<D, true>(rows + (size_t)k0 * ld + 2 * E + h * D, ld, L - k0,
                        vt, TP, nullptr, sv);
    __syncthreads();
    float sc[8][4];
    scores(k0, sc);
    for (int j = 0; j < 8; ++j)
      for (int e = 0; e < 4; ++e) {
        const int p = __float2int_rn(exp2f(
            __fadd_rn(__fsub_rn(sc[j][e], m[e >> 1]), LOG2_127)));
        p8[(g + (e >> 1) * 8) * TP + j * 8 + t4 * 2 + (e & 1)] =
            static_cast<int8_t>(p);
        den[e >> 1] += p;
      }
    __syncwarp();
    for (int kk = 0; kk < KT; kk += 32) {
      uint32_t a[4];
      frag_a(a, p8, TP, g, t4, kk);
      for (int j = 0; j < D / 8; ++j) {
        const int8_t* p = vt + (j * 8 + g) * TP + kk + t4 * 4;
        mma_s8(pacc[j], a, *reinterpret_cast<const uint32_t*>(p),
               *reinterpret_cast<const uint32_t*>(p + 16));
      }
    }
    __syncwarp();  // p8 is rewritten by the next tile
  }
  for (int hh = 0; hh < 2; ++hh) {
    den[hh] += __shfl_xor_sync(0xffffffffu, den[hh], 1);
    den[hh] += __shfl_xor_sync(0xffffffffu, den[hh], 2);
  }
  // out = (f32(acc) * sv) * (127 / max(f32(127 * den), 1)), parked in fo
  for (int hh = 0; hh < 2; ++hh) {
    const float r127 = 127.0f / fmaxf((float)(den[hh] * 127), 1.0f);
    for (int j = 0; j < D / 8; ++j)
      for (int e = 0; e < 2; ++e) {
        const int d = j * 8 + t4 * 2 + e;
        fo[(g + hh * 8) * OP + d] =
            __fmul_rn(__fmul_rn((float)pacc[j][hh * 2 + e], sv[d]), r127);
      }
  }
  __syncwarp();
  const int qrow = q0 + warp * 16 + (lane >> 1);
  finish_rows<D, EMIT>(fo, 1.0f, qrow, L, (size_t)b * L + qrow, h, E, out,
                       o8, os, crow);
}

// launch with the H blocks of one query tile as a cluster (emission)
template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, dim3 grid, size_t smem, int H,
                           cudaStream_t stream, Args... args) {
  if (H > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = H;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D, int MODE>
cudaError_t launch(const void* qkv, const void* lengths, const void* seg,
                   const void* kbs, const void* kbe, void* out, int B, int L,
                   int H, int W, float s2, float hi, cudaStream_t stream) {
  const size_t smem = Layout<D>::smem;
  auto kern = attn_kernel<D, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + QT - 1) / QT, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(lengths),
      static_cast<const int*>(seg), static_cast<const int*>(kbs),
      static_cast<const int*>(kbe), static_cast<__nv_bfloat16*>(out), L, H,
      W, s2, hi);
  return cudaGetLastError();
}

template <int D, int EMIT>
cudaError_t launch_i8(const void* qkv, const void* lengths, void* out,
                      void* o8, void* os, int B, int L, int H, float s2,
                      cudaStream_t stream) {
  const size_t smem = I8Layout<D>::smem;
  auto kern = attn_i8_kernel<D, EMIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + QT - 1) / QT, H, B);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* ln = static_cast<const int*>(lengths);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* c8 = static_cast<int8_t*>(o8);
  auto* cs = static_cast<float*>(os);
  if (EMIT != EMIT_NO)
    return launch_cluster(kern, grid, smem, H, stream, q, ln, o, c8, cs, L, H,
                          s2);
  kern<<<grid, THREADS, smem, stream>>>(q, ln, o, c8, cs, L, H, s2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mode(int mode, int emit, int i8s, const void* qkv,
                        const void* lengths, const void* seg,
                        const void* kbs, const void* kbe, void* out,
                        void* o8, void* os, int B, int L, int H, int W,
                        float s2, float hi, cudaStream_t stream) {
#define ATTN_ARGS qkv, lengths, seg, kbs, kbe, out, B, L, H, W, s2, hi, stream
#define I8_ARGS qkv, lengths, out, o8, os, B, L, H, s2, stream
  if (i8s) {  // K2i8: prefix mask only
    if (mode != PREFIX) return cudaErrorInvalidValue;
    switch (emit) {
      case EMIT_NO: return launch_i8<D, EMIT_NO>(I8_ARGS);
      case EMIT_BOTH: return launch_i8<D, EMIT_BOTH>(I8_ARGS);
      case EMIT_ONLY: return launch_i8<D, EMIT_ONLY>(I8_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  // K2e and K4e (emission without int8 scores) are attention_sm90.cu's
  if (emit != EMIT_NO) return cudaErrorInvalidValue;
  switch (mode) {
    case WINDOW:
      if (L % BQ) return cudaErrorInvalidValue;
      return launch<D, WINDOW>(ATTN_ARGS);
    case BAND:
      if (W < 0) return cudaErrorInvalidValue;
      return launch<D, BAND>(ATTN_ARGS);
    default:  // 0 without int8 scores, 1, 3, 4, 5, 7, 8: attention_sm90.cu
      return cudaErrorInvalidValue;
  }
#undef I8_ARGS
#undef ATTN_ARGS
}

}  // namespace

extern "C" {

// qkv [B*L, 3*H*D] bf16 (16-byte aligned), out [B*L, H*D] bf16 (device
// pointers). Mode 0 with i8s (K2i8) and mode 6 read lengths [B] int32;
// mode 2 reads seg [B, L] int32 (-1 on pads), kbs, kbe [B, L/128] int32
// and the block cap W (L % 128 == 0); mode 6 takes the half window W =
// window // 2. Unused pointers may be null. L % 8 == 0. s2 =
// log2(e)/sqrt(D) as f32; hi = the score clamp bound. D must be 32, 64 or
// 128. emit (with i8s only, H <= 16): 1 also writes o8 [B*L, E] int8 and
// os [B*L] f32, 2 writes only those (out may be null). Every other mode,
// and mode 0 without i8s, is attention_sm90.cu's: refused. Returns a
// cudaError_t.
int attn_launch(const void* qkv, const void* lengths, const void* seg,
                const void* kbs, const void* kbe, void* out, void* o8,
                void* os, int mode, int emit, int i8s, int B, int L, int H,
                int D, int W, float s2, float hi, void* stream) {
  if (B < 0 || L <= 0 || L % 8 || H <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATTN_ARGS mode, emit, i8s, qkv, lengths, seg, kbs, kbe, out, o8, os, \
                  B, L, H, W, s2, hi, st
  switch (D) {
    case 32: return launch_mode<32>(ATTN_ARGS);
    case 64: return launch_mode<64>(ATTN_ARGS);
    case 128: return launch_mode<128>(ATTN_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_ARGS
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
