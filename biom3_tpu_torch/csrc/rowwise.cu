// Row-wise kernels of the Stage-3 stack and the BERT and ESM2 towers: the
// parts of the TPU kernels that are reductions and gathers with no matrix
// product.
//
// * bias_layernorm — x + per-row-group bias, then LayerNorm: the prologue
//   of biom3_tpu/ops/pallas/fused_layer_tpu.py:186 (fused_attn_half,
//   :117-119) and of each layer of stack_kernel_tpu.py:765
//   (fused_stack_logits, :541-547).  Writes xb (f32, it is the residual of
//   the attention half) and LN(xb) (bf16, the q/k/v GEMM's input).
// * layernorm — the FF half's pre-norm (fused_layer_tpu.py:269,
//   fused_ff_half :255) and BERT's post-norms (bert_stack_tpu.py:198,
//   :138-141 and :176-179), eps passed in.
// * embed_tokens — tok[ids] + pos_emb, the l == 0 embed of
//   stack_kernel_tpu.py:522-537 (a one-hot matmul there; a gather here).
// * gather_head — the l == depth-1 epilogue of stack_kernel_tpu.py:562-581:
//   gather the k decode positions, final LayerNorm (eps 1e-6), d x C head.
// * esm2_embed — the l == 0 embed of esm2_stack_tpu.py:294 (fused_esm2_cls,
//   :91-115): table[id] with fair-esm's token-dropout rescale, <mask> and
//   PAD rows zeroed.  The rescale needs the row's <mask> and PAD counts, so
//   every block first counts over its batch row (L ids, a few KB from L2)
//   and then writes its tile of sequence rows.
//
// What bounds them: device-memory bandwidth (a few bytes per FLOP).  One
// warp per row keeps every reduction in registers and shuffles; rows are
// read with 16-byte vectors.  Two-pass mean/variance, as the reference's
// f32 parity path computes it.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

__device__ __forceinline__ void load8(const void *p, size_t off, int is_f32, float *v) {
  if (is_f32) {
    const float4 *q = reinterpret_cast<const float4 *>(static_cast<const float *>(p) + off);
    float4 a = q[0], b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    unpack8(*reinterpret_cast<const uint4 *>(static_cast<const bf16 *>(p) + off), v);
  }
}

// Row statistics of (x [+ add]) over d columns, for one warp.
__device__ __forceinline__ void row_stats(const void *x, int x_f32, size_t xoff,
                                          const bf16 *add, int d, int lane, float eps,
                                          float &mean, float &rstd) {
  float v[8], a[8], s = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    load8(x, xoff + c, x_f32, v);
    if (add) unpack8(*reinterpret_cast<const uint4 *>(add + c), a);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += add ? v[e] + a[e] : v[e];
  }
  mean = warp_sum(s) / d;
  float q = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    load8(x, xoff + c, x_f32, v);
    if (add) unpack8(*reinterpret_cast<const uint4 *>(add + c), a);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = (add ? v[e] + a[e] : v[e]) - mean;
      q += t * t;
    }
  }
  rstd = rsqrtf(warp_sum(q) / d + eps);
}

__global__ void bias_layernorm_kernel(const bf16 *__restrict__ h, const bf16 *__restrict__ bias,
                                      const float *__restrict__ scale,
                                      const float *__restrict__ shift, float *__restrict__ xb,
                                      bf16 *__restrict__ xn, int rows, int rows_per_bias, int d,
                                      float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t off = (size_t)row * d;
  const bf16 *brow = bias + (size_t)(row / rows_per_bias) * d;
  float mean, rstd;
  row_stats(h, 0, off, brow, d, lane, eps, mean, rstd);
  float v[8], a[8], y[8];
  for (int c = lane * 8; c < d; c += 256) {
    unpack8(*reinterpret_cast<const uint4 *>(h + off + c), v);
    unpack8(*reinterpret_cast<const uint4 *>(brow + c), a);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] += a[e];
      y[e] = (v[e] - mean) * rstd * scale[c + e] + shift[c + e];
    }
    float4 *xp = reinterpret_cast<float4 *>(xb + off + c);
    xp[0] = make_float4(v[0], v[1], v[2], v[3]);
    xp[1] = make_float4(v[4], v[5], v[6], v[7]);
    *reinterpret_cast<uint4 *>(xn + off + c) = pack8(y);
  }
}

__global__ void layernorm_kernel(const void *__restrict__ x, int x_f32,
                                 const float *__restrict__ scale,
                                 const float *__restrict__ shift, bf16 *__restrict__ y,
                                 float *__restrict__ y32, int rows, int d, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t off = (size_t)row * d;
  float mean, rstd;
  row_stats(x, x_f32, off, nullptr, d, lane, eps, mean, rstd);
  float v[8];
  for (int c = lane * 8; c < d; c += 256) {
    load8(x, off + c, x_f32, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * rstd * scale[c + e] + shift[c + e];
    *reinterpret_cast<uint4 *>(y + off + c) = pack8(v);
    if (y32) {
      float4 *yp = reinterpret_cast<float4 *>(y32 + off + c);
      yp[0] = make_float4(v[0], v[1], v[2], v[3]);
      yp[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

__global__ void embed_tokens_kernel(const int *__restrict__ ids, const bf16 *__restrict__ tok,
                                    const bf16 *__restrict__ pos, bf16 *__restrict__ out,
                                    int rows, int L, int d) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16 *t = tok + (size_t)ids[row] * d;
  const bf16 *p = pos + (size_t)(row % L) * d;
  float a[8], b[8];
  for (int c = lane * 8; c < d; c += 256) {
    unpack8(*reinterpret_cast<const uint4 *>(t + c), a);
    unpack8(*reinterpret_cast<const uint4 *>(p + c), b);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] += b[e];
    *reinterpret_cast<uint4 *>(out + (size_t)row * d + c) = pack8(a);
  }
}

constexpr int HEAD_THREADS = 128;

__global__ void __launch_bounds__(HEAD_THREADS)
gather_head_kernel(const bf16 *__restrict__ h, const int *__restrict__ pos,
                   const float *__restrict__ scale, const float *__restrict__ shift,
                   const bf16 *__restrict__ hw, const float *__restrict__ hb,
                   float *__restrict__ out, int L, int k, int d, int C, float eps) {
  extern __shared__ float hn[];  // d floats
  __shared__ float red[HEAD_THREADS / 32];
  __shared__ float stat[2];
  const int r = blockIdx.x, b = r / k;  // r indexes (b, j) over B*k
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const bf16 *src = h + ((size_t)b * L + pos[r]) * d;

  float s = 0.f;
  for (int c = t; c < d; c += HEAD_THREADS) {
    hn[c] = __bfloat162float(src[c]);
    s += hn[c];
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (t == 0) {
    float a = 0.f;
    for (int w = 0; w < HEAD_THREADS / 32; ++w) a += red[w];
    stat[0] = a / d;
  }
  __syncthreads();
  const float mean = stat[0];
  float q = 0.f;
  for (int c = t; c < d; c += HEAD_THREADS) {
    const float x = hn[c] - mean;
    q += x * x;
  }
  q = warp_sum(q);
  __syncthreads();
  if (lane == 0) red[warp] = q;
  __syncthreads();
  if (t == 0) {
    float a = 0.f;
    for (int w = 0; w < HEAD_THREADS / 32; ++w) a += red[w];
    stat[1] = rsqrtf(a / d + eps);
  }
  __syncthreads();
  const float rstd = stat[1];
  for (int c = t; c < d; c += HEAD_THREADS)
    hn[c] = round_bf16((hn[c] - mean) * rstd * scale[c] + shift[c]);
  __syncthreads();
  for (int cls = warp; cls < C; cls += HEAD_THREADS / 32) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc = fmaf(hn[i], __bfloat162float(hw[(size_t)i * C + cls]), acc);
    acc = warp_sum(acc);
    if (lane == 0) out[(size_t)r * C + cls] = acc + hb[cls];
  }
}

constexpr int EMBED_ROWS = 32;  // sequence rows per esm2_embed block

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
esm2_embed_kernel(const int *__restrict__ ids, const bf16 *__restrict__ table,
                  bf16 *__restrict__ out, int L, int d, int pad_idx, int mask_idx,
                  int token_dropout) {
  __shared__ float counts[2];  // PAD, <mask> in this batch row
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int *row_ids = ids + (size_t)b * L;
  if (threadIdx.x < 2) counts[threadIdx.x] = 0.f;
  __syncthreads();
  float n_pad = 0.f, n_mask = 0.f;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int id = row_ids[j];
    n_pad += id == pad_idx;
    n_mask += id == mask_idx;
  }
  n_pad = warp_sum(n_pad);
  n_mask = warp_sum(n_mask);
  if (lane == 0) {
    atomicAdd(&counts[0], n_pad);
    atomicAdd(&counts[1], n_mask);
  }
  __syncthreads();
  // (1 - 0.15 * 0.8) / (1 - observed <mask> ratio), as the TPU kernel
  float scale = 1.f;
  if (token_dropout) scale = 0.88f / (1.f - counts[1] / fmaxf(1.f, (float)L - counts[0]));
  const int l_end = min(L, (blockIdx.x + 1) * EMBED_ROWS);
  for (int l = blockIdx.x * EMBED_ROWS + warp; l < l_end; l += ROWS_PER_BLOCK) {
    const int id = row_ids[l];
    const float s = (id == pad_idx || (token_dropout && id == mask_idx)) ? 0.f : scale;
    const bf16 *t = table + (size_t)id * d;
    bf16 *o = out + ((size_t)b * L + l) * d;
    float v[8];
    for (int c = lane * 8; c < d; c += 256) {
      unpack8(*reinterpret_cast<const uint4 *>(t + c), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= s;
      *reinterpret_cast<uint4 *>(o + c) = pack8(v);
    }
  }
}

inline dim3 row_grid(int rows) { return dim3((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK); }

}  // namespace

// All row kernels need d % 8 == 0 and contiguous, 16-byte aligned rows.
B3_EXPORT int b3_bias_layernorm(const void *h, const void *bias, const void *scale,
                                const void *shift, void *xb, void *xn, int rows,
                                int rows_per_bias, int d, float eps, void *stream) {
  bias_layernorm_kernel<<<row_grid(rows), ROWS_PER_BLOCK * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(h), static_cast<const bf16 *>(bias),
      static_cast<const float *>(scale), static_cast<const float *>(shift),
      static_cast<float *>(xb), static_cast<bf16 *>(xn), rows, rows_per_bias, d, eps);
  return static_cast<int>(cudaGetLastError());
}

B3_EXPORT int b3_layernorm(const void *x, int x_f32, const void *scale, const void *shift,
                           void *y, void *y32, int rows, int d, float eps, void *stream) {
  layernorm_kernel<<<row_grid(rows), ROWS_PER_BLOCK * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, x_f32, static_cast<const float *>(scale), static_cast<const float *>(shift),
      static_cast<bf16 *>(y), static_cast<float *>(y32), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

B3_EXPORT int b3_embed_tokens(const void *ids, const void *tok, const void *pos, void *out,
                              int rows, int L, int d, void *stream) {
  embed_tokens_kernel<<<row_grid(rows), ROWS_PER_BLOCK * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int *>(ids), static_cast<const bf16 *>(tok),
      static_cast<const bf16 *>(pos), static_cast<bf16 *>(out), rows, L, d);
  return static_cast<int>(cudaGetLastError());
}

B3_EXPORT int b3_gather_head(const void *h, const void *pos, const void *scale,
                             const void *shift, const void *hw, const void *hb, void *out,
                             int B, int L, int k, int d, int C, float eps, void *stream) {
  gather_head_kernel<<<B * k, HEAD_THREADS, d * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(h), static_cast<const int *>(pos),
      static_cast<const float *>(scale), static_cast<const float *>(shift),
      static_cast<const bf16 *>(hw), static_cast<const float *>(hb),
      static_cast<float *>(out), L, k, d, C, eps);
  return static_cast<int>(cudaGetLastError());
}

B3_EXPORT int b3_esm2_embed(const void *ids, const void *table, void *out, int B, int L, int d,
                            int pad_idx, int mask_idx, int token_dropout, void *stream) {
  dim3 grid((L + EMBED_ROWS - 1) / EMBED_ROWS, B);
  esm2_embed_kernel<<<grid, ROWS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int *>(ids), static_cast<const bf16 *>(table), static_cast<bf16 *>(out),
      L, d, pad_idx, mask_idx, token_dropout);
  return static_cast<int>(cudaGetLastError());
}
