// Banded (sliding-window) multi-head self-attention over the fused QKV
// projection, for sm_90a: kernel K6w of the PyTorch port, on WMMA. Every
// other attention kernel (K2 with K2e and K2i8, K4 with K4e, K5, K7, K6,
// K6c, K6ca and the context-parallel K8a and K8b) runs on the Hopper
// kernel in attention_sm90.cu (wgmma, a TMA ring);
// ops/attention.py:attention_kernel routes, and this library refuses
// every mode but 6.
//
// Replaces (embeddings_tpu/ops/attention.py, the Pallas TPU kernels):
//   mode 6, K6w: _attn_kernel_stream in its span + window (banded) mode,
//               behind fused_attention_window() (ModernBERT's local
//               layers).
// For each sequence b, head h and query i, reading q, k and v as column
// slices of the fused qkv [B*L, 3E] (q at h*D, k at E + h*D, v at 2E +
// h*D), with d = q . k_j accumulated in f32:
//   s = clamp(d * s2, -100, hi), key j valid iff j < len[b] and |i - j|
//   <= W (W = window // 2), over the 64-key tiles that meet [q0 - W,
//   q_last + W] only: O(L * window) work;
//   p_j = bf16(exp2(s)) if valid else 0
//   out = (sum_j p_j v_j) / max(sum_j p_j, 1e-30)           (f32 sums)
// written as bf16 to ctx [B*L, E] at column h*D. s2 = log2(e)/sqrt(D);
// hi = 127 - ceil(log2 L): sized to the whole row, as the TPU's
// _stream_call sizes it, not to the band. There is no max-subtraction:
// the clamp keeps exp2 and the sum finite for any row length, as in the
// TPU kernels, so key tiles only ADD into the output and the denominator;
// nothing is rescaled. A row with no valid key (len 0) gives exactly 0.
// The tiles outside the band and those wholly past len[b] are skipped:
// every p there is an exact zero. The multiply-adds the plain version
// rounds separately are written __fmul_rn / __fadd_rn, so nvcc's FMA
// contraction cannot change a score.
//
// What bounds it on the H100: at 32,768 tokens (B=32, L=1,024, or B=4,
// L=8,192) and window 128 the function moves ~201 MB (qkv in, context
// out) for ~13 GFLOP: bound by bytes (0.06 ms); a 64-query block walks 3
// key tiles (129 keys of the band, at most 192 visited). The design
// reads q, k and v in place from the fused projection (no transpose pass
// through memory), and keeps scores and probabilities in shared memory
// and registers: one block per (64-query tile, head, sequence), 4 warps of
// 16 query rows, 64-key tiles of K and V staged in shared memory, both
// products on the tensor cores (WMMA bf16, f32 accumulators). Not yet
// used here: TMA double buffering of the key tiles and wgmma
// (attention_sm90.cu has both).

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

// every other mode is attention_sm90.cu's
constexpr int BAND = 6;

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
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

// The last step: this warp's 16 query rows of one head, parked as f32 in
// fsc (row stride D + 4), times inv, written as bf16 to out at row orow
// (rows past L are not written); two lanes a row, D/2 columns each.
template <int D>
__device__ __forceinline__ void finish_rows(const float* fsc, float inv,
                                            int qrow, int L, size_t orow,
                                            int h, int E,
                                            __nv_bfloat16* __restrict__ out) {
  constexpr int OP = Layout<D>::OP;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (D / 2);
  if (qrow >= L) return;
  for (int c = c0; c < c0 + D / 2; c += 8) {
    float f[8];
    for (int e = 0; e < 8; ++e) f[e] = fsc[r * OP + c + e] * inv;
    *reinterpret_cast<uint4*>(out + orow * E + h * D + c) = pack8(f);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) attn_kernel(
    const __nv_bfloat16* __restrict__ qkv, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int L, int H, int W, float s2,
    float hi) {
  using Lay = Layout<D>;
  constexpr int DP = Lay::DP;
  constexpr int OP = Lay::OP;
  constexpr int F = Lay::F;
  constexpr int DV = D / 8;  // 16-byte vectors per head row

  extern __shared__ __align__(128) unsigned char smem[];
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
  const int len = lengths[b];
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
  // the 64-key tiles that meet [q0 - W, q0 + QT - 1 + W] (W = window //
  // 2), short of the first tile wholly past len[b] (tiles past it would
  // add exact zeros)
  const int k_begin = max(0, q0 - W) / KT * KT;
  const int k_end = min(min(L, (len + KT - 1) / KT * KT),
                        (q0 + QT - 1 + W) / KT * KT + KT);
  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();  // every warp is done with the previous K/V tile
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
        const bool ok = kj < len && abs(qrow - kj) <= W;
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
  finish_rows<D>(fsc, 1.0f / fmaxf(rowsum, 1e-30f), qrow, L,
                 (size_t)b * L + qrow, h, E, out);
}

template <int D>
cudaError_t launch(const void* qkv, const void* lengths, void* out, int B,
                   int L, int H, int W, float s2, float hi,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::smem;
  auto kern = attn_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + QT - 1) / QT, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), L, H, W, s2, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B*L, 3*H*D] bf16 (16-byte aligned), lengths [B] int32, out [B*L,
// H*D] bf16 (device pointers). mode must be 6 (K6w; every other mode is
// attention_sm90.cu's: refused); W = window // 2 >= 0. L % 8 == 0. s2 =
// log2(e)/sqrt(D) as f32; hi = the score clamp bound. D must be 32, 64 or
// 128. Returns a cudaError_t.
int attn_launch(const void* qkv, const void* lengths, void* out, int mode,
                int B, int L, int H, int D, int W, float s2, float hi,
                void* stream) {
  if (mode != BAND || B < 0 || L <= 0 || L % 8 || H <= 0 || W < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qkv, lengths, out, B, L, H, W, s2, hi, st);
    case 64: return launch<64>(qkv, lengths, out, B, L, H, W, s2, hi, st);
    case 128: return launch<128>(qkv, lengths, out, B, L, H, W, s2, hi, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
