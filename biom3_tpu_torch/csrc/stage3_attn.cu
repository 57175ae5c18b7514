// stage3_attention_core: the attention of one ProteoScribe layer, from the
// fused q/k/v projection (B, L, 3d) to the head outputs (B, L, d), local
// heads first (biom3_tpu/models/proteoscribe.py:115-117,184).
//
// Replaces the attention core of the TPU kernels
// biom3_tpu/ops/pallas/fused_layer_tpu.py:186 (fused_attn_half) and
// stack_kernel_tpu.py:60/312 (_attn_core_t, _attn_global_t inside
// fused_stack_logits).
//
// * Band-local heads: one block per (query tile, head, batch row).  A query
//   of window w sees the keys of windows w-1..w+1 — 3W keys, or 2W at the
//   edges with no padding, which equals the -1e9-masked form of
//   biom3_tpu/ops/local_attention.py:26-31,78-80 — under one joint f32
//   softmax.  What bounds it: 2·W·3W·Dh FLOP per (window, head) against a
//   (3W, Dh) K/V band that is read once per block, so the score work, not
//   memory, dominates; the band streams through shared memory and scores
//   never leave registers (attn_common.cuh).
// * Linear heads: one block per (head, batch row).  k' = softmax(k over
//   the sequence) needs a max/sum pass over all L before use; then
//   ctx = k'ᵀv (Dh x Dh, in shared memory) and out = q'·ctx with
//   q' = softmax(q over Dh)·Dh^-0.5 (stack_kernel_tpu.py:312-329).  The
//   work is O(L·Dh²) and tiny; the bf16 rounding points of the reference
//   (k', ctx and q' stored as bf16) are kept.
#include "attn_common.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(512)
local_heads_kernel(const bf16 *__restrict__ qkv, bf16 *__restrict__ out, int L, int d,
                   int window, int tq) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * tq;
  const int w = q0 / window;
  const int lo = max(0, (w - 1) * window), hi = min(L, (w + 2) * window);
  const bf16 *base = qkv + (size_t)b * L * 3 * d + h * DH;
  const b3::Heads a{base, base + d, base + 2 * d, 3 * d, 3 * d,
                    out + (size_t)b * L * d + h * DH, d};
  b3::attend_range<DH>(a, q0, min(L, q0 + tq), lo, hi, rsqrtf((float)DH));
}

constexpr int LIN_THREADS = 256;
constexpr int LIN_CHUNK = 32;  // sequence rows per shared tile of k', v

template <int DH>
__global__ void __launch_bounds__(LIN_THREADS)
linear_heads_kernel(const bf16 *__restrict__ qkv, bf16 *__restrict__ out, int L, int d,
                    int local_heads) {
  constexpr int GROUPS = LIN_THREADS / DH;       // row groups per channel
  constexpr int PER = DH * DH / LIN_THREADS;     // ctx entries per thread
  __shared__ float red[GROUPS][DH];
  __shared__ float kmax[DH], ksum[DH];
  __shared__ float KF[LIN_CHUNK][DH + 1];
  __shared__ float VV[LIN_CHUNK][DH + 1];
  __shared__ float CT[DH][DH + 1];

  const int b = blockIdx.y, h = local_heads + blockIdx.x;
  const int t = threadIdx.x;
  const int stride = 3 * d;
  const bf16 *base = qkv + (size_t)b * L * stride;
  const int qc = h * DH, kc = d + h * DH, vc = 2 * d + h * DH;

  // k' = softmax over the sequence, per channel: max pass, then sum pass
  const int ch = t % DH, grp = t / DH;
  float mx = -INFINITY;
  for (int n = grp; n < L; n += GROUPS)
    mx = fmaxf(mx, __bfloat162float(base[(size_t)n * stride + kc + ch]));
  red[grp][ch] = mx;
  __syncthreads();
  if (t < DH) {
    float v = red[0][t];
    for (int g = 1; g < GROUPS; ++g) v = fmaxf(v, red[g][t]);
    kmax[t] = v;
  }
  __syncthreads();
  float sm = 0.f;
  for (int n = grp; n < L; n += GROUPS)
    sm += __expf(__bfloat162float(base[(size_t)n * stride + kc + ch]) - kmax[ch]);
  __syncthreads();
  red[grp][ch] = sm;
  __syncthreads();
  if (t < DH) {
    float v = 0.f;
    for (int g = 0; g < GROUPS; ++g) v += red[g][t];
    ksum[t] = 1.f / v;
  }

  // ctx[i][j] = sum_n k'[n][i] v[n][j]
  float ctx[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) ctx[p] = 0.f;
  for (int n0 = 0; n0 < L; n0 += LIN_CHUNK) {
    const int rows = min(LIN_CHUNK, L - n0);
    __syncthreads();
    for (int e = t; e < rows * DH; e += LIN_THREADS) {
      const int r = e / DH, c = e % DH;
      const bf16 *row = base + (size_t)(n0 + r) * stride;
      KF[r][c] = round_bf16(__expf(__bfloat162float(row[kc + c]) - kmax[c]) * ksum[c]);
      VV[r][c] = __bfloat162float(row[vc + c]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int id = t + p * LIN_THREADS, i = id / DH, j = id % DH;
      float a = ctx[p];
      for (int r = 0; r < rows; ++r) a = fmaf(KF[r][i], VV[r][j], a);
      ctx[p] = a;
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int id = t + p * LIN_THREADS;
    CT[id / DH][id % DH] = round_bf16(ctx[p]);
  }
  __syncthreads();

  // out[n][j] = sum_i q'[n][i] ctx[i][j]
  const float scale = rsqrtf((float)DH);
  for (int n = t; n < L; n += LIN_THREADS) {
    const bf16 *qp = base + (size_t)n * stride + qc;
    float q[DH];
#pragma unroll
    for (int c = 0; c < DH; c += 8) unpack8(*reinterpret_cast<const uint4 *>(qp + c), q + c);
    float qm = q[0];
#pragma unroll
    for (int c = 1; c < DH; ++c) qm = fmaxf(qm, q[c]);
    float qs = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      q[c] = __expf(q[c] - qm);
      qs += q[c];
    }
    const float qn = scale / qs;
#pragma unroll
    for (int c = 0; c < DH; ++c) q[c] = round_bf16(q[c] * qn);
    float o[DH];
#pragma unroll
    for (int j = 0; j < DH; ++j) o[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DH; ++i)
#pragma unroll
      for (int j = 0; j < DH; ++j) o[j] = fmaf(q[i], CT[i][j], o[j]);
    bf16 *op = out + ((size_t)b * L + n) * d + h * DH;
#pragma unroll
    for (int j = 0; j < DH; j += 8) *reinterpret_cast<uint4 *>(op + j) = pack8(o + j);
  }
}

template <int DH>
int launch(const bf16 *qkv, bf16 *out, int B, int L, int d, int heads, int local_heads,
           int window, cudaStream_t stream) {
  if (local_heads > 0) {
    // 128 query rows (512 threads) per block at Dh 32, 64 at Dh 64, so the
    // per-thread q and acc rows stay in registers
    const int cap = DH == 32 ? 128 : 64;
    const int tq = window < cap ? window : cap;  // window % tq == 0 (checked)
    dim3 grid((L + tq - 1) / tq, local_heads, B);
    local_heads_kernel<DH><<<grid, tq * b3::S, 0, stream>>>(qkv, out, L, d, window, tq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (heads > local_heads) {
    dim3 grid(heads - local_heads, B);
    linear_heads_kernel<DH><<<grid, LIN_THREADS, 0, stream>>>(qkv, out, L, d, local_heads);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, L, 3d) bf16 [q | k | v]; out: (B, L, d) bf16.  Head dim
// d / heads must be 32 or 64; window % 64 == 0 or window a multiple of 8
// below 64.
B3_EXPORT int b3_stage3_attention_core(const void *qkv, void *out, int B, int L, int d,
                                       int heads, int local_heads, int window,
                                       void *stream) {
  const bf16 *q = static_cast<const bf16 *>(qkv);
  bf16 *o = static_cast<bf16 *>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / heads) {
    case 32: return launch<32>(q, o, B, L, d, heads, local_heads, window, s);
    case 64: return launch<64>(q, o, B, L, d, heads, local_heads, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
