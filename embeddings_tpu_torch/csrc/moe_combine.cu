// The routed experts' combine of the PyTorch port's sparse MoE FFN
// (ops/moe.py moe_ffn_ragged), for sm_90a.
//
// Replaces no TPU kernel: the JAX package combines the experts' rows with
// XLA's segment sum (embeddings_tpu/ops/moe.py), which the port first
// wrote as five f32 torch passes (cast, bias gather, weighting, an atomic
// index_add_, the casts of the shared expert and the result). For every
// token t, with pos[t, j] the row of its pair (t, j) in the expert-sorted
// rows y:
//     acc = sum_{j<k} w[t, j] * (f32(y[pos[t, j]]) + down_b[e[t, j]])
//     acc += bias;  acc += f32(shared[t]);  out[t] = acc in y's dtype
// down_b, bias and shared each optional (nomic-embed-text-v2-moe: the
// per-expert down bias and the output bias; DeepSeek-V2: the shared
// expert). Every product and add is one rounded f32 operation (no FMA
// contraction), in j order, with no atomics: the result repeats bit for
// bit, and equals the plain version (moe.py _combine_plain), which does
// the same operations in the same order.
//
// What bounds it on the H100: bytes. A token reads k rows of D and the
// shared row and writes one row (DeepSeek-V2, k = 6, D = 2,048, bf16:
// 32 KB a token, 4.4 ms a call of 40,960 tokens through 11 layers at
// 3.35 TB/s); the indices and weights are ~72 B a token. The design:
// - pos, the inverse of the sort (pos[order[i]] = i), comes from a
//   scatter kernel first (4 B a pair), so the weights and experts are read
//   in their [T, k] order and no weight is gathered through the sort;
// - threads run along D in 16-byte vectors, neighbouring threads on
//   neighbouring addresses; a thread issues all k row loads (up to 8 at a
//   time) before its first add, so k x 16 B are in flight a thread;
// - a block of 256 threads covers one token (D = 2,048 bf16) or several
//   (256 / ceil32(D / 8) of them), so a 1,024 bucket's 8,192 tokens make
//   8,192 blocks on 132 SMs;
// - widths whose rows are not 16-byte aligned (D * size % 16 != 0, or an
//   operand off a 16-byte boundary) take the scalar instantiation.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int KCHUNK = 8;  // row loads a thread keeps in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// VEC elements of T in one load: 16 bytes, or one element (VEC == 1)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

__global__ void __launch_bounds__(THREADS) moe_positions_kernel(
    const int64_t* __restrict__ order, int* __restrict__ pos, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) pos[order[i]] = i;
}

// grid: ceil(T / blockDim.y) blocks; threadIdx.y picks the token,
// threadIdx.x walks its vectors
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) moe_combine_kernel(
    const T* __restrict__ y, const int* __restrict__ pos,
    const float* __restrict__ w, int ldw, const int64_t* __restrict__ experts,
    const float* __restrict__ down_b, const float* __restrict__ bias,
    const T* __restrict__ shared, T* __restrict__ out, int n_tok, int k,
    int D) {
  const int t = blockIdx.x * blockDim.y + threadIdx.y;
  if (t >= n_tok) return;
  const int* pt = pos + (size_t)t * k;
  const float* wt = w + (size_t)t * ldw;
  const int64_t* et = experts + (size_t)t * k;
  using P = Pack<T, VEC>;
  for (int c = threadIdx.x * VEC; c < D; c += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < k; j0 += KCHUNK) {
      P raw[KCHUNK];
#pragma unroll
      for (int i = 0; i < KCHUNK; ++i)
        if (j0 + i < k)
          raw[i] = *reinterpret_cast<const P*>(y + (size_t)pt[j0 + i] * D + c);
#pragma unroll
      for (int i = 0; i < KCHUNK; ++i) {
        if (j0 + i >= k) break;
        const float wj = wt[j0 + i];
        float b[VEC];
        if (down_b) load_f32<VEC>(down_b + (size_t)et[j0 + i] * D + c, b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float v = to_f32(raw[i].e[e]);
          if (down_b) v = __fadd_rn(v, b[e]);
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wj, v));
        }
      }
    }
    if (bias) {
      float b[VEC];
      load_f32<VEC>(bias + c, b);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], b[e]);
    }
    if (shared) {
      const P s = *reinterpret_cast<const P*>(shared + (size_t)t * D + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = __fadd_rn(acc[e], to_f32(s.e[e]));
    }
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.e[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<P*>(out + (size_t)t * D + c) = o;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int VEC>
cudaError_t launch_combine(const void* y, const int* pos, const float* w,
                           int ldw, const int64_t* experts,
                           const float* down_b, const float* bias,
                           const void* shared, void* out, int n_tok, int k,
                           int D, cudaStream_t stream) {
  const int vecs = (D + VEC - 1) / VEC;
  const int bx = vecs >= THREADS ? THREADS : (vecs + 31) / 32 * 32;
  const dim3 block(bx, THREADS / bx);
  const unsigned grid = (n_tok + block.y - 1) / block.y;
  moe_combine_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(y), pos, w, ldw, experts, down_b, bias,
      static_cast<const T*>(shared), static_cast<T*>(out), n_tok, k, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* y, const int* pos, const float* w, int ldw,
                     const int64_t* experts, const float* down_b,
                     const float* bias, const void* shared, void* out,
                     int n_tok, int k, int D, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // 16-byte loads need every row, and every bias row, on a 16-byte
  // boundary: D a multiple of VEC and each base pointer aligned
  const bool vec = D % VEC == 0 && aligned16(y) && aligned16(out) &&
                   (!shared || aligned16(shared)) &&
                   (!down_b || aligned16(down_b)) &&
                   (!bias || aligned16(bias));
  return vec ? launch_combine<T, VEC>(y, pos, w, ldw, experts, down_b, bias,
                                      shared, out, n_tok, k, D, stream)
             : launch_combine<T, 1>(y, pos, w, ldw, experts, down_b, bias,
                                    shared, out, n_tok, k, D, stream);
}

}  // namespace

extern "C" {

// All pointers are device pointers. y [T*k, D] (the expert-sorted rows),
// shared [T, D] and out [T, D] in one dtype (0 bf16, 1 f16, 2 f32); order
// [T*k] int64 (the sort: sorted row i holds pair order[i] = t*k + j); pos
// [T*k] int32, scratch the first kernel fills; w [T, k] f32 with row
// stride ldw; experts [T*k] int64 (read only with down_b); down_b [E, D]
// and bias [D] f32. down_b, bias and shared may be null.
int moe_combine_launch(const void* y, const int64_t* order, int* pos,
                       const float* w, int ldw, const int64_t* experts,
                       const float* down_b, const float* bias,
                       const void* shared, void* out, int n_tok, int k, int D,
                       int dtype, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n = n_tok * k;
  moe_positions_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      order, pos, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return dispatch<__nv_bfloat16>(y, pos, w, ldw, experts, down_b, bias,
                                     shared, out, n_tok, k, D, stream);
    case 1:
      return dispatch<__half>(y, pos, w, ldw, experts, down_b, bias, shared,
                              out, n_tok, k, D, stream);
    case 2:
      return dispatch<float>(y, pos, w, ldw, experts, down_b, bias, shared,
                             out, n_tok, k, D, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
