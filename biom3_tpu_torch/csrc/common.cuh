// Shared device helpers for the biom3_tpu_torch kernels (sm_90a).
//
// Every exported entry point is a plain C function: it launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define B3_EXPORT extern "C" __attribute__((visibility("default")))

// GELU variants of the JAX reference (ops/pallas/fused_layer_tpu.py:61-79),
// and their derivatives (layer_block_tpu.py:71-81) for the backward GEMM's
// epilogue, which multiplies by gelu'(h) of a stored pre-activation h.
enum { ACT_NONE = 0, ACT_GELU_ERF = 1, ACT_GELU_TANH = 2, ACT_DGELU_ERF = 3, ACT_DGELU_TANH = 4 };

__device__ __forceinline__ float apply_act(float x, int act) {
  if (act == ACT_GELU_ERF) return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
  if (act == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  return x;
}

__device__ __forceinline__ float gelu_grad(float x, int act) {
  if (act == ACT_DGELU_ERF) {
    const float phi = 0.5f * (1.0f + erff(x * 0.7071067811865476f));
    return phi + x * __expf(-0.5f * x * x) * 0.3989422804014327f;
  }
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
}

// Round an f32 value through bf16, to mirror a rounding point of the
// reference where the kernel keeps the value in a register.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (max, Σexp(x − max)) of two sets of values → of their union; a set of
// no values is (−inf, 0).
__device__ __forceinline__ void merge_stats(float &m, float &s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;
  s = s * __expf(m - mn) + so * __expf(mo - mn);
  m = mn;
}

// Unpack 8 bf16 values held in a 16-byte vector.
__device__ __forceinline__ void unpack8(const uint4 &u, float *f) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float *f) {
  uint4 u;
  __nv_bfloat162 *h = reinterpret_cast<__nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
