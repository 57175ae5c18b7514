// local_window_attention: standalone 3-window band attention on (B, H, L, D)
// q, k, v — each window of W queries attends to the keys of windows w-1, w,
// w+1 under one softmax, out-of-range windows masked (lucidrains local
// attention, non-causal, look_backward = look_forward = 1).
//
// Replaces biom3_tpu/ops/pallas/local_attention_tpu.py:73
// (local_window_attention_pallas → pallas_call :101), the kernel behind
// ProteoScribe(attn_impl="pallas"); here it backs attn_impl="kernel".  It
// keeps that kernel's rounding points, which differ from the plain
// lucidrains form (ops/local_attention.py): q is scaled by D^-0.5 in f32
// before the dot (:34); e = exp(s - m) is rounded to v's dtype
// unnormalised before the AV product, and the f32 sum is divided by the f32
// denominator after it (:52-68).  A masked window's keys score -1e9 there
// and weigh exp(-1e9 - m) = 0, so the band is clipped to the windows that
// exist here.
//
// What bounds it on an H100: 4·W·3W·D FLOP per (window, head) against a
// (3W, D) key and value band read once per query tile, so the score work
// dominates; on CUDA cores here.  Design: one block per (query tile of one
// window, batch·head), S = 4 threads per query row, each walking every S-th
// key of the band with q in registers; the band streams through shared
// memory in f32 tiles of TK rows, twice: pass 1 finds each row's max, pass
// 2 forms e, the f32 denominator and the AV sums, which merge across the S
// threads by shuffles.  Tensor-core tiles are later work (ROADMAP queue 2b).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int S = 4;    // threads per query row
constexpr int TK = 64;  // key rows per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float *p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16 *p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(D == 32 ? 512 : 256)
local_attn_kernel(const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,
                  T *__restrict__ out, int L, int window, int tq, float scale) {
  __shared__ float Ks[TK][D + 4];
  __shared__ float Vs[TK][D + 4];
  const size_t head = (size_t)blockIdx.y * L * D;
  const int q0 = blockIdx.x * tq, w = q0 / window;
  const int lo = max(0, (w - 1) * window), hi = min(L, (w + 2) * window);
  const int t = threadIdx.x, sub = t % S;
  const size_t qrow = head + (size_t)(q0 + t / S) * D;  // tq divides L: every row exists

  float qv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qv[c] = to_f32(q[qrow + c]) * scale;

  auto load_tile = [&](const T *src, float (*dst)[D + 4], int k0, int n) {
    for (int e = t; e < n * D; e += blockDim.x)
      dst[e / D][e % D] = to_f32(src[head + (size_t)(k0 + e / D) * D + e % D]);
  };
  auto score = [&](int j) {
    float sc = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) sc = fmaf(qv[c], Ks[j][c], sc);
    return sc;
  };

  // pass 1: the row max of the band's scores
  float m = -INFINITY;
  for (int k0 = lo; k0 < hi; k0 += TK) {
    const int n = min(TK, hi - k0);
    __syncthreads();
    load_tile(k, Ks, k0, n);
    __syncthreads();
    for (int j = sub; j < n; j += S) m = fmaxf(m, score(j));
  }
#pragma unroll
  for (int off = 1; off < S; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  // pass 2: e = exp(s - m), its f32 sum, and Σ round(e)·v
  float den = 0.f, acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += TK) {
    const int n = min(TK, hi - k0);
    __syncthreads();
    load_tile(k, Ks, k0, n);
    load_tile(v, Vs, k0, n);
    __syncthreads();
    for (int j = sub; j < n; j += S) {
      const float e = expf(score(j) - m);
      den += e;
      const float p = std::is_same_v<T, bf16> ? round_bf16(e) : e;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, Vs[j][c], acc[c]);
    }
  }
#pragma unroll
  for (int off = 1; off < S; off <<= 1) {
    den += __shfl_xor_sync(0xffffffffu, den, off);
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  constexpr int PER = D / S;  // output channels written by this thread
#pragma unroll
  for (int c = 0; c < D; ++c)
    if (c / PER == sub) store(out + qrow + c, acc[c] / den);
}

template <typename T, int D>
int launch(const void *q, const void *k, const void *v, void *out, int BH, int L, int window,
           int tq, float scale, cudaStream_t stream) {
  dim3 grid(L / tq, BH);
  local_attn_kernel<T, D><<<grid, tq * S, 0, stream>>>(
      static_cast<const T *>(q), static_cast<const T *>(k), static_cast<const T *>(v),
      static_cast<T *>(out), L, window, tq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (B·H, L, D) contiguous, f32 (is_f32) or bf16; D 32 or 64;
// L % window == 0 and window % tq == 0, tq ≤ 128 (checked by the wrapper);
// scale = D^-0.5.
B3_EXPORT int b3_local_window_attention(const void *q, const void *k, const void *v, void *out,
                                        int BH, int L, int D, int window, int tq, float scale,
                                        int is_f32, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return is_f32 ? launch<float, 32>(q, k, v, out, BH, L, window, tq, scale, s)
                  : launch<bf16, 32>(q, k, v, out, BH, L, window, tq, scale, s);
  if (D == 64)
    return is_f32 ? launch<float, 64>(q, k, v, out, BH, L, window, tq, scale, s)
                  : launch<bf16, 64>(q, k, v, out, BH, L, window, tq, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
