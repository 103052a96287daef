// Per-row int8 emission, shared by qmatmul.cu (K1e/K3e) and
// attention_sm90.cu (K2e/K4e, and K2i8's): the emit modes and the packing
// of eight f32 values into their int8 codes, rint(v * (1/scale)) with the
// reciprocal taken once a row.
#pragma once

#include <stdint.h>

// emission: none, the output and its int8 rows, the int8 rows only
enum Emit { EMIT_NO = 0, EMIT_BOTH = 1, EMIT_ONLY = 2 };
constexpr float INV127 = (float)(1.0 / 127.0);

// eight f32 values -> their int8 codes rint(v * rs), packed little-endian
__device__ __forceinline__ uint2 codes8(const float* v, float rs) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e / 4] |= (uint32_t)(__float2int_rn(v[e] * rs) & 0xff) << (8 * (e % 4));
  return make_uint2(w[0], w[1]);
}
