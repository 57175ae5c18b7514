// rope8: GPT-NeoX rotary of one 8-column chunk, x·cos + rotate_half(x)·sin
// with each product and the sum rounded through bf16, as the TPU kernel
// rotates in bf16 (esm2_stack_tpu.py:164-176); the ESM2 kernels' staging
// launches use it (esm2_rope.cuh).
#pragma once

#include "common.cuh"

namespace b3 {

// Rotary of one 8-column chunk at column c: x·cos + rotate_half(x)·sin,
// where rotate_half gives -x[c + DH/2] in the first half, x[c - DH/2] in
// the second (`partner` holds those columns).
template <int DH>
__device__ __forceinline__ void rope8(int c, const float *x, const float *partner,
                                      const float *cs, const float *sn, float *out) {
  const float sign = c < DH / 2 ? -1.f : 1.f;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = round_bf16(round_bf16(x[e] * cs[e]) + round_bf16(sign * partner[e] * sn[e]));
}

}  // namespace b3
