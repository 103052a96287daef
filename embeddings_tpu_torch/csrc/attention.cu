// Fused multi-head self-attention over the fused QKV projection, for
// sm_90a: kernels K2, K4, K5, K6 (with its banded mode K6w and its causal
// mode K6c) and K7 of the PyTorch port, as eight mask modes of one kernel.
//
// Replaces (embeddings_tpu/ops/attention.py, the Pallas TPU kernels):
//   mode 0, K2: _attn_kernel (its bf16 branch), behind fused_attention();
//   mode 1, K4: _attn_kernel_segmented, behind fused_attention_segmented();
//   mode 2, K5: _attn_kernel_seg_window, behind
//               fused_attention_segmented_blockskip();
//   mode 3, K7: _attn_kernel_bias, behind fused_attention_bias();
//   modes 4, 5, K6: _attn_kernel_stream in its plain and ALiBi modes,
//               behind fused_attention_stream();
//   mode 6, K6w: _attn_kernel_stream in its span + window (banded) mode,
//               behind fused_attention_window() (ModernBERT's local
//               layers);
//   mode 7, K6c: _attn_kernel_stream in its causal mode, behind
//               fused_attention_stream(causal=True) (the Qwen2 decoder
//               embedders).
// For each sequence (packed row) b, head h and query i, with q, k, v read
// as column slices of the fused qkv buffer [B*L, 3E] (q at h*D, k at
// E + h*D, v at 2E + h*D), and d = q . k_j accumulated in f32:
//   mode 0: s = clamp(bf16(q * s2) . k_j, -100, hi) (q pre-scaled and
//           rounded, the TPU's K2 rounding), key j valid iff j < len[b];
//   mode 1: s = clamp(d * s2, -100, hi) (scaled after the dot, in f32, as
//           the TPU's other kernels do), key j valid iff seg[b,i] ==
//           seg[b,j] and seg[b,j] >= 0;
//   mode 2: mode 1, over key blocks kbs .. min(kbs + W - 1, kbe) of the
//           query's 128-row block only (block_ranges); blocks past the cap
//           W are dropped, every other key block is skipped unread;
//   mode 3: s = clamp(d * s2 + bias[h, i, j], -100, hi) (bias f32 [H, L,
//           L], log2-scaled), key j valid iff j < len[b];
//   mode 4: s = clamp(d * s2, -100, hi), key j valid iff j < len[b];
//   mode 5: s = clamp(d * s2 - slope[h] * (f32(|i - j|) * log2(e)), -100,
//           hi), key j valid iff j < len[b] (jina-bert-v2's ALiBi from
//           positions, no bias array);
//   mode 6: s = clamp(d * s2, -100, hi), key j valid iff j < len[b] and
//           |i - j| <= W (W = window // 2), over the 64-key tiles that
//           meet [q0 - W, q_last + W] only: O(L * window) work;
//   mode 7: s = clamp(d * s2, -100, hi), key j valid iff j < len[b] and
//           j <= i, over the 64-key tiles up to the block's last query
//           row only: about half of mode 4's work.
//   p_j = bf16(exp2(s)) if valid else 0
//   out = (sum_j p_j v_j) / max(sum_j p_j, 1e-30)           (f32 sums)
// written as bf16 to ctx [B*L, E] at column h*D. s2 = log2(e)/sqrt(D); hi
// = 127 - ceil(log2 n) for n = L keys (n = min(W*128, L) in mode 2; in
// modes 6 and 7 n is the whole row L, as the TPU's _stream_call sizes
// it, not the band or the causal prefix). There
// is no max-subtraction: the clamp keeps exp2 and the sum finite for any
// row length, as in the TPU kernels, so key tiles only ADD into the
// output and the denominator; nothing is rescaled. That also makes every
// mode a streaming kernel: no state beyond one 64-key tile and the
// running sums, so K6's long rows need nothing K2 does not have. A row
// with no valid key (len 0, or a pad query) gives exactly 0. Prefix modes
// stop at the first 64-key tile past len[b] (those tiles add exact
// zeros); ALiBi tiles far from the diagonal clamp at -100 and still add
// exp2(-100), so they are not skipped. Mode 6 skips the tiles outside the
// band, and mode 7 the tiles past the block's last query row, for the
// same reason as the prefix stop: every p there is an exact zero (keys at
// or below the diagonal that the mask drops still cost their dot: only
// whole tiles are skipped). The multiply-adds the plain
// version rounds separately are written __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc's FMA contraction cannot change a score.
//
// What bounds it on the H100: at B=128, L=256, H=12, D=64 (modes 0, 3),
// or 32,768 packed tokens (modes 1 and 2), the function moves ~201 MB
// (qkv in, context out; mode 3 adds the 3.1 MB bias, which stays in the
// 50 MB L2 across the batch) for ~26 GFLOP (mode 2 at L=1024, W=3: ~19
// GFLOP), so it is bound by device memory, not by the tensor cores. At
// K6's L=8192 (B=4) the same 201 MB carries ~825 GFLOP of products and
// 3.2 G exp2: there it is bound by operations (tensor cores, then the
// exp2 unit). Mode 6 at 32,768 tokens and window 128 needs ~13 GFLOP for
// the same 201 MB: bound by bytes; a 64-query block walks 3 key tiles
// (129 keys of the band, at most 192 visited). Mode 7 at Qwen2's B=4,
// L=4,096, H=12, D=128 needs ~206 GFLOP for ~201 MB: bound by
// operations, as K6 plain is at that length; its blocks near the end of
// a row walk 64 key tiles, those at its start one. The design reads q, k
// and v in place from the fused projection (no transpose pass through memory), and keeps scores and
// probabilities in shared memory and registers: one block per (64-query
// tile, head, sequence), 4 warps of 16 query rows, 64-key tiles of K and
// V (and their segment ids) staged in shared memory, both products on the
// tensor cores (WMMA bf16, f32 accumulators). The bias of mode 3 is read
// in place from device memory (L2), four scores to a 16-byte load. Not
// yet used: cp.async/TMA double buffering of the key tiles, wgmma, and
// skipping key tiles outside a K4 row's segments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int QT = 64;        // query rows per block
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int SP = KT + 4;    // f32 score staging row stride
constexpr int PP = KT + 8;    // bf16 probability row stride
constexpr int BQ = 128;       // query/key block of mode 2 (block_ranges)
constexpr float LOG2E_F = 1.4426950408889634f;
static_assert(QT == KT, "mode 7's diagonal stop needs QT == KT");

enum Mode { PREFIX = 0, SEGMENT = 1, WINDOW = 2, BIAS = 3, STREAM = 4,
            ALIBI = 5, BAND = 6, CAUSAL = 7 };

// modes whose key mask is the prefix j < len[b]
__host__ __device__ constexpr bool prefix_masked(int mode) {
  return mode == PREFIX || mode >= BIAS;
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

template <int D, int MODE>
__global__ void __launch_bounds__(THREADS) attn_kernel(
    const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ lengths,
    const int* __restrict__ seg, const int* __restrict__ kbs,
    const int* __restrict__ kbe, const float* __restrict__ bias,
    const float* __restrict__ slopes, __nv_bfloat16* __restrict__ out,
    int L, int H, int W, float s2, float hi) {
  using Lay = Layout<D>;
  constexpr int DP = Lay::DP;
  constexpr int OP = Lay::OP;
  constexpr int F = Lay::F;
  constexpr int DV = D / 8;  // 16-byte vectors per head row

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int segk[KT];  // the key tile's segment ids (modes 1, 2)
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
  const int len = prefix_masked(MODE) ? lengths[b] : 0;
  const __nv_bfloat16* rows = qkv + (size_t)b * L * ld;
  float* fsc = fbase + warp * F;
  __nv_bfloat16* ps = pbase + warp * 16 * PP;

  // q tile; mode 0 pre-scales it by s2 and rounds to bf16 (the TPU's K2
  // rounding), modes 1 and 2 scale the f32 scores instead
  const float qscale = MODE == PREFIX ? s2 : 1.0f;
  for (int v = tid; v < QT * DV; v += THREADS) {
    const int r = v / DV;
    const int c = (v % DV) * 8;
    float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + r < L) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          rows + (size_t)(q0 + r) * ld + h * D + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(p[i]);
        f[2 * i] = t.x * qscale;
        f[2 * i + 1] = t.y * qscale;
      }
    }
    uint4 o;
    __nv_bfloat162 t;
    t = __floats2bfloat162_rn(f[0], f[1]); o.x = *reinterpret_cast<uint32_t*>(&t);
    t = __floats2bfloat162_rn(f[2], f[3]); o.y = *reinterpret_cast<uint32_t*>(&t);
    t = __floats2bfloat162_rn(f[4], f[5]); o.z = *reinterpret_cast<uint32_t*>(&t);
    t = __floats2bfloat162_rn(f[6], f[7]); o.w = *reinterpret_cast<uint32_t*>(&t);
    *reinterpret_cast<uint4*>(qs + r * DP + c) = o;
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
  const int sq = (!prefix_masked(MODE) && qrow < L)
                     ? seg[(size_t)b * L + qrow] : -1;
  // mode 3: this query's bias row (rows past L, never written, read row
  // L - 1); mode 5: this head's slope
  const float* brow =
      MODE == BIAS ? bias + ((size_t)h * L + min(qrow, L - 1)) * L : nullptr;
  const float slope = MODE == ALIBI ? slopes[h] : 0.0f;
  int k_begin = 0, k_end = L;
  if (prefix_masked(MODE)) {
    // key tiles wholly past len[b] would add exact zeros: stop before them
    k_end = min(L, (len + KT - 1) / KT * KT);
  }
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
    // 2); the prefix stop above still applies
    k_begin = max(0, q0 - W) / KT * KT;
    k_end = min(k_end, (q0 + QT - 1 + W) / KT * KT + KT);
  }
  if (MODE == CAUSAL) {
    // no query row of this block sees a key past q0 + QT - 1: stop at
    // the tile after the diagonal (QT == KT); the prefix stop still
    // applies
    k_end = min(k_end, q0 + QT);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    if (!prefix_masked(MODE) && tid < KT)
      segk[tid] = k0 + tid < L ? seg[(size_t)b * L + k0 + tid] : -1;
    for (int v = tid; v < KT * DV; v += THREADS) {
      const int kr = v / DV;
      const int c = (v % DV) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + kr < L) {
        const __nv_bfloat16* src = rows + (size_t)(k0 + kr) * ld + h * D + c;
        kv = *reinterpret_cast<const uint4*>(src + E);
        vv = *reinterpret_cast<const uint4*>(src + 2 * E);
      }
      *reinterpret_cast<uint4*>(ks + kr * DP + c) = kv;
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
      // mode 3: four bias values in one 16-byte load (L % 8 == 0 and
      // k0 + c4 < len <= L keep it in the row and aligned)
      float4 bv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (MODE == BIAS) {
        if (k0 + c4 < len) bv = *reinterpret_cast<const float4*>(brow + k0 + c4);
      }
      const float bias4[4] = {bv.x, bv.y, bv.z, bv.w};
      for (int e = 0; e < 4; ++e) {
        const int c = c4 + e;
        const int kj = k0 + c;
        bool ok = prefix_masked(MODE) ? kj < len
                                      : segk[c] == sq && segk[c] >= 0;
        if constexpr (MODE == BAND) ok = ok && abs(qrow - kj) <= W;
        if constexpr (MODE == CAUSAL) ok = ok && kj <= qrow;
        float raw = fsc[r * SP + c];
        if constexpr (MODE == BIAS) {
          raw = __fadd_rn(__fmul_rn(raw, s2), bias4[e]);
        } else if constexpr (MODE == ALIBI) {
          const float dist = __fmul_rn((float)abs(qrow - kj), LOG2E_F);
          raw = __fsub_rn(__fmul_rn(raw, s2), __fmul_rn(slope, dist));
        } else if constexpr (MODE != PREFIX) {
          raw = raw * s2;
        }
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
  if (qrow < L) {
    const float inv = 1.0f / fmaxf(rowsum, 1e-30f);
    __nv_bfloat16* dst = out + ((size_t)b * L + qrow) * E + h * D;
    for (int c = (lane & 1) * (D / 2); c < (lane & 1) * (D / 2) + D / 2;
         c += 8) {
      float f[8];
      for (int e = 0; e < 8; ++e) f[e] = fsc[r * OP + c + e] * inv;
      uint4 o;
      __nv_bfloat162 t;
      t = __floats2bfloat162_rn(f[0], f[1]); o.x = *reinterpret_cast<uint32_t*>(&t);
      t = __floats2bfloat162_rn(f[2], f[3]); o.y = *reinterpret_cast<uint32_t*>(&t);
      t = __floats2bfloat162_rn(f[4], f[5]); o.z = *reinterpret_cast<uint32_t*>(&t);
      t = __floats2bfloat162_rn(f[6], f[7]); o.w = *reinterpret_cast<uint32_t*>(&t);
      *reinterpret_cast<uint4*>(dst + c) = o;
    }
  }
}

template <int D, int MODE>
cudaError_t launch(const void* qkv, const void* lengths, const void* seg,
                   const void* kbs, const void* kbe, const void* bias,
                   const void* slopes, void* out, int B, int L, int H, int W,
                   float s2, float hi, cudaStream_t stream) {
  const size_t smem = Layout<D>::smem;
  auto kern = attn_kernel<D, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + QT - 1) / QT, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(lengths),
      static_cast<const int*>(seg), static_cast<const int*>(kbs),
      static_cast<const int*>(kbe), static_cast<const float*>(bias),
      static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out), L,
      H, W, s2, hi);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mode(int mode, const void* qkv, const void* lengths,
                        const void* seg, const void* kbs, const void* kbe,
                        const void* bias, const void* slopes, void* out,
                        int B, int L, int H, int W, float s2, float hi,
                        cudaStream_t stream) {
#define ATTN_ARGS \
  qkv, lengths, seg, kbs, kbe, bias, slopes, out, B, L, H, W, s2, hi, stream
  switch (mode) {
    case PREFIX: return launch<D, PREFIX>(ATTN_ARGS);
    case SEGMENT: return launch<D, SEGMENT>(ATTN_ARGS);
    case WINDOW:
      if (L % BQ) return cudaErrorInvalidValue;
      return launch<D, WINDOW>(ATTN_ARGS);
    case BIAS:
      if (bias == nullptr) return cudaErrorInvalidValue;
      return launch<D, BIAS>(ATTN_ARGS);
    case STREAM: return launch<D, STREAM>(ATTN_ARGS);
    case ALIBI:
      if (slopes == nullptr) return cudaErrorInvalidValue;
      return launch<D, ALIBI>(ATTN_ARGS);
    case BAND:
      if (W < 0) return cudaErrorInvalidValue;
      return launch<D, BAND>(ATTN_ARGS);
    case CAUSAL: return launch<D, CAUSAL>(ATTN_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_ARGS
}

}  // namespace

extern "C" {

// qkv [B*L, 3*H*D] bf16 and out [B*L, H*D] bf16 (device pointers). Modes
// 0 and 3-7 read lengths [B] int32; modes 1 and 2 read seg [B, L]
// int32 (-1 on pads); mode 2 also kbs, kbe [B, L/128] int32 and the block
// cap W (L % 128 == 0); mode 3 reads bias [H, L, L] f32 (log2-scaled);
// mode 5 reads slopes [H] f32; mode 6 takes the half window W =
// window // 2. Unused pointers may be null. s2 =
// log2(e)/sqrt(D) as f32; hi = the score clamp bound. D must be 32, 64 or
// 128. Returns a cudaError_t.
int attn_launch(const void* qkv, const void* lengths, const void* seg,
                const void* kbs, const void* kbe, const void* bias,
                const void* slopes, void* out, int mode, int B, int L, int H,
                int D, int W, float s2, float hi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATTN_ARGS \
  mode, qkv, lengths, seg, kbs, kbe, bias, slopes, out, B, L, H, W, s2, hi, st
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
