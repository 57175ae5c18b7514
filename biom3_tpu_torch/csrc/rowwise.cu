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
//   :138-141 and :176-179), eps passed in.  One read of each row: up to
//   d = 1280 the row, γ and β stay in registers (layernorm_kernel), a
//   wider row is staged in shared memory (layernorm_wide_kernel).
// * embed_tokens — tok[ids] + pos_emb, the l == 0 embed of
//   stack_kernel_tpu.py:522-537 (a one-hot matmul there; a gather here).
// * gather_head — the l == depth-1 epilogue of stack_kernel_tpu.py:562-581:
//   gather the k decode positions, final LayerNorm (eps 1e-6), d x C head.
// * esm2_embed — the l == 0 embed of esm2_stack_tpu.py:294 (fused_esm2_cls,
//   :91-115): table[id] with fair-esm's token-dropout rescale, <mask> and
//   PAD rows zeroed.  The rescale needs the row's <mask> and PAD counts, so
//   every block first counts over its batch row (L ids, a few KB from L2)
//   and then writes its tile of sequence rows.
// * layernorm_bwd — _ln_bwd of the training kernels
//   (biom3_tpu/ops/pallas/layer_block_tpu.py:58-68, inside
//   layer_block_tpu.py:419 _bwd_call): recomputes x̂ and rstd from the
//   layer's f32 (or bf16) input, dx = rstd·(dŷγ − mean(dŷγ) − x̂·mean(dŷγ·x̂))
//   plus the residual's gradient, and dγ = Σ dŷ·x̂, dβ = Σ dŷ over the rows.
//   Each block sums its rows' dγ/dβ into one partial row; a second pass
//   (col_sum) adds the partial rows in a fixed order — the TPU adds them
//   into one f32 strip over its sequential grid, which blocks running in
//   parallel cannot do without atomics.
// * col_sum — f32 column sums of an (rows, n) matrix: the bias gradients
//   dbo, db1, db2 (layer_block_tpu.py:230,240,262) and the fixed-order
//   reduction of the split-K weight gradients (gemm_bf16.cu).  Pass 1 sums
//   a slab of rows per block (8 warps, 8 columns a lane); pass 2 sums the
//   slabs.
// * quant_rows — the dynamic per-token activation quant of the int8 serving
//   recipe (biom3_tpu/ops/pallas/quant.py:35-47, run inside
//   stack_kernel_tpu.py:765, bert_stack_tpu.py:198, esm2_stack_tpu.py:294
//   ahead of every int8 product): amax = max(max|x|, 1e-6) over the row in
//   f32, codes rint(x · (127 / amax)) clipped to ±127 (one reciprocal
//   multiplier, round half to even, as jnp.round), scale amax · (1/127).
//   Its codes and scales equal the plain version's bit for bit.
//
// What bounds them: device-memory bandwidth (a few bytes per FLOP).  One
// warp per row keeps every reduction in registers and shuffles; rows are
// read with 16-byte vectors.  Two-pass mean/variance, as the reference's
// f32 parity path computes it (layernorm: both passes over the row read once).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row
// A row held in registers: ROW_CHUNKS 16-byte chunks of 8 columns a lane,
// 256 columns a chunk, so d <= 1280 (ESM2-650M) — layernorm's one-read
// kernel and layernorm_bwd.
constexpr int ROW_CHUNKS = 5;

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

// layernorm: one read of x.  Rows of up to ROW_CHUNKS chunks a lane
// (d <= 1280) run on layernorm_kernel, wider ones on layernorm_wide_kernel.
// Both sum the mean, then the centred sum of squares, in row_stats' order
// (chunk by chunk, 8 columns in order, one warp_sum), so the output has the
// bits of a kernel that reads the row three times.
__device__ __forceinline__ void store8(bf16 *y, float *y32, size_t off, const float *v) {
  if (y) *reinterpret_cast<uint4 *>(y + off) = pack8(v);
  if (y32) {
    float4 *yp = reinterpret_cast<float4 *>(y32 + off);
    yp[0] = make_float4(v[0], v[1], v[2], v[3]);
    yp[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <bool F32>
struct Chunk;  // 8 columns of one row as loaded: f32, or bf16 still packed
template <>
struct Chunk<true> {
  float f[8];
  __device__ __forceinline__ void load(const void *x, size_t off) { load8(x, off, 1, f); }
  __device__ __forceinline__ void unpack(float *v) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = f[e];
  }
};
template <>
struct Chunk<false> {
  uint4 u;
  __device__ __forceinline__ void load(const void *x, size_t off) {
    u = *reinterpret_cast<const uint4 *>(static_cast<const bf16 *>(x) + off);
  }
  __device__ __forceinline__ void unpack(float *v) const { unpack8(u, v); }
};

// Each warp holds its row in registers, NC chunks a lane (columns lane·8 +
// 256·i, i < NC, those < d), and issues the next row's loads before it
// reduces the current one; the grid is sized from the SM count and each
// warp walks rows gridDim·8 apart.  γ and β arrive once a warp as float4
// loads and stay in registers across its rows.
template <int NC, bool F32>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
layernorm_kernel(const void *__restrict__ x, const float *__restrict__ scale,
                 const float *__restrict__ shift, bf16 *__restrict__ y,
                 float *__restrict__ y32, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31, stride = gridDim.x * ROWS_PER_BLOCK;
  int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  float g[NC][8], b[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < d) {
      load8(scale, c, 1, g[i]);
      load8(shift, c, 1, b[i]);
    }
  }
  Chunk<F32> raw[NC];
  auto load = [&](int r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) raw[i].load(x, (size_t)r * d + c);
    }
  };
  load(row);
  for (; row < rows; row += stride) {
    float v[NC][8];
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + i * 256 < d) raw[i].unpack(v[i]);
    if (row + stride < rows) load(row + stride);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + i * 256 < d)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[i][e];
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + i * 256 < d)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = v[i][e] - mean;
          q += t * t;
        }
    const float rstd = rsqrtf(warp_sum(q) / d + eps);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c >= d) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = (v[i][e] - mean) * rstd * g[i][e] + b[i][e];
      store8(y, y32, (size_t)row * d + c, v[i]);
    }
  }
}

// Rows wider than ROW_CHUNKS chunks a lane (ESM2-3B's 2560, a Stage-3 dim
// of 4096): each warp copies its row once into shared memory with
// cp.async, 16 bytes at a time, and each lane reads back only the columns
// it copied, so no barrier is needed.  row_stats and the normalise loop
// then read the row there; γ and β come as float4 loads for each chunk,
// from L1/L2 (every warp reads the same ones).  blockDim.x / 32 warps, each
// with d elements of the input's type in shared memory.
template <bool F32>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
layernorm_wide_kernel(const void *__restrict__ x, const float *__restrict__ scale,
                      const float *__restrict__ shift, bf16 *__restrict__ y,
                      float *__restrict__ y32, int rows, int d, float eps) {
  extern __shared__ __align__(16) unsigned char staged[];
  constexpr int ESZ = F32 ? 4 : 2;   // bytes an element: a chunk is 2 or 1 copies of 16
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned char *row_s = staged + (size_t)warp * d * ESZ;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(row_s));
  for (int row = blockIdx.x * warps + warp; row < rows; row += gridDim.x * warps) {
    const char *src = static_cast<const char *>(x) + (size_t)row * d * ESZ;
    for (int c = lane * 8; c < d; c += 256)
#pragma unroll
      for (int k = 0; k < ESZ / 2; ++k)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + c * ESZ + 16 * k),
                     "l"(src + c * ESZ + 16 * k));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    float mean, rstd, v[8], g[8], b[8];
    row_stats(row_s, F32, 0, nullptr, d, lane, eps, mean, rstd);
    for (int c = lane * 8; c < d; c += 256) {
      load8(row_s, c, F32, v);
      load8(scale, c, 1, g);
      load8(shift, c, 1, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * rstd * g[e] + b[e];
      store8(y, y32, (size_t)row * d + c, v);
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

__global__ void quant_rows_kernel(const void *__restrict__ x, int x_f32, int8_t *__restrict__ q,
                                  float *__restrict__ scale, int rows, int d) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t off = (size_t)row * d;
  float v[8], amax = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    load8(x, off + c, x_f32, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = fmaxf(warp_max(amax), 1e-6f);
  const float mul = 127.0f / amax;
  for (int c = lane * 8; c < d; c += 256) {
    load8(x, off + c, x_f32, v);
    __align__(8) int8_t o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = static_cast<int8_t>(fminf(fmaxf(rintf(v[e] * mul), -127.f), 127.f));
    *reinterpret_cast<uint2 *>(q + off + c) = *reinterpret_cast<const uint2 *>(o);
  }
  if (lane == 0) scale[row] = amax * (1.0f / 127.0f);
}

inline dim3 row_grid(int rows) { return dim3((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK); }

// d <= ROW_CHUNKS * 256 (checked by the wrapper).  A lane keeps x̂ and the
// dγ/dβ sums of its columns in registers; dŷ·γ is read again (from L1/L2) for the
// output, so the five chunks fit the registers without spilling.
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
layernorm_bwd_kernel(const void *__restrict__ x, int x_f32, const float *__restrict__ dy,
                     const float *__restrict__ gamma, const void *__restrict__ res, int res_f32,
                     void *__restrict__ dx, int dx_f32, bf16 *__restrict__ dx16,
                     float *__restrict__ partial, int rows, int d, float eps) {
  __shared__ float red[ROWS_PER_BLOCK][ROW_CHUNKS * 256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float dg[ROW_CHUNKS][8], db[ROW_CHUNKS][8];
#pragma unroll
  for (int k = 0; k < ROW_CHUNKS; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[k][e] = db[k][e] = 0.f;

  for (int row = blockIdx.x * ROWS_PER_BLOCK + warp; row < rows;
       row += gridDim.x * ROWS_PER_BLOCK) {
    const size_t off = (size_t)row * d;
    float xv[ROW_CHUNKS][8], s = 0.f;
#pragma unroll
    for (int k = 0; k < ROW_CHUNKS; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < d) {
        load8(x, off + c, x_f32, xv[k]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += xv[k][e];
      }
    }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < ROW_CHUNKS; ++k)
      if (lane * 8 + k * 256 < d)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[k][e] -= mean;
          q += xv[k][e] * xv[k][e];
        }
    const float rstd = rsqrtf(warp_sum(q) / d + eps);
    // x̂ in xv; the two row means of dŷ·γ and dŷ·γ·x̂
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < ROW_CHUNKS; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < d) {
        float gv[8], g[8];
        load8(dy, off + c, 1, gv);
        load8(gamma, c, 1, g);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[k][e] *= rstd;
          dg[k][e] += gv[e] * xv[k][e];
          db[k][e] += gv[e];
          s1 += gv[e] * g[e];
          s2 += gv[e] * g[e] * xv[k][e];
        }
      }
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
#pragma unroll
    for (int k = 0; k < ROW_CHUNKS; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < d) {
        float gv[8], g[8], r[8], o[8];
        load8(dy, off + c, 1, gv);
        load8(gamma, c, 1, g);
        if (res) load8(res, off + c, res_f32, r);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = rstd * (gv[e] * g[e] - s1 - xv[k][e] * s2);
          if (res) o[e] += r[e];
        }
        if (dx_f32) {
          float4 *p = reinterpret_cast<float4 *>(static_cast<float *>(dx) + off + c);
          p[0] = make_float4(o[0], o[1], o[2], o[3]);
          p[1] = make_float4(o[4], o[5], o[6], o[7]);
        } else {
          *reinterpret_cast<uint4 *>(static_cast<bf16 *>(dx) + off + c) = pack8(o);
        }
        if (dx16) *reinterpret_cast<uint4 *>(dx16 + off + c) = pack8(o);
      }
    }
  }
  // this block's dγ then dβ partial row: partial[blockIdx.x] = [dγ | dβ]
  float *prow = partial + (size_t)blockIdx.x * 2 * d;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = 0; k < ROW_CHUNKS; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < d)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp][c + e] = pass ? db[k][e] : dg[k][e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < ROWS_PER_BLOCK; ++w) a += red[w][c];
      prow[pass * d + c] = a;
    }
    __syncthreads();
  }
}

constexpr int CS_COLS = 256;  // columns per col_sum block (8 per lane)

// Rows [y·rows_per_part, (y+1)·rows_per_part) of x (rows, n) summed into
// out[y] (one row of n floats); grid (ceil(n / 256), parts).
template <bool F32>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
col_sum_kernel(const void *__restrict__ x, int rows, long long n, int rows_per_part,
               float *__restrict__ out) {
  __shared__ float red[ROWS_PER_BLOCK][CS_COLS + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * CS_COLS + lane * 8;
  const int r0 = blockIdx.y * rows_per_part, r1 = min(rows, r0 + rows_per_part);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < n)
    for (int r = r0 + warp; r < r1; r += ROWS_PER_BLOCK) {
      float v[8];
      load8(x, (size_t)r * n + c, F32, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += v[e];
    }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[warp][lane * 8 + e] = acc[e];
  __syncthreads();
  const long long col = (long long)blockIdx.x * CS_COLS + threadIdx.x;
  if (col < n) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < ROWS_PER_BLOCK; ++w) a += red[w][threadIdx.x];
    out[(size_t)blockIdx.y * n + col] = a;
  }
}

// x (rows, n) → out (n,): with parts > 1, pass 1 sums ceil(rows / parts)
// rows per partial row of `partial` (parts, n) and pass 2 sums those.
template <bool F32>
void col_sum(const void *x, int rows, long long n, float *out, float *partial, int parts,
             cudaStream_t stream) {
  const unsigned gx = (unsigned)((n + CS_COLS - 1) / CS_COLS);
  if (parts <= 1) {
    col_sum_kernel<F32><<<dim3(gx, 1), ROWS_PER_BLOCK * 32, 0, stream>>>(x, rows, n, rows, out);
    return;
  }
  const int per = (rows + parts - 1) / parts;
  col_sum_kernel<F32><<<dim3(gx, parts), ROWS_PER_BLOCK * 32, 0, stream>>>(x, rows, n, per,
                                                                           partial);
  col_sum_kernel<true><<<dim3(gx, 1), ROWS_PER_BLOCK * 32, 0, stream>>>(partial, parts, n, parts,
                                                                        out);
}

template <int NC>
int launch_layernorm(const void *x, int x_f32, const float *scale, const float *shift, bf16 *y,
                     float *y32, int rows, int d, float eps, cudaStream_t stream) {
  const auto kernel = x_f32 ? layernorm_kernel<NC, true> : layernorm_kernel<NC, false>;
  static int sms = 0, per_sm[2] = {0, 0};   // blocks an SM holds, by x_f32
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (!per_sm[x_f32])
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[x_f32], kernel, ROWS_PER_BLOCK * 32, 0);
  const int blocks =
      std::min((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, sms * per_sm[x_f32]);
  kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, stream>>>(x, scale, shift, y, y32, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// The wide rows' blocks hold up to 48 KB of staged rows (as many warps as
// fit, at most ROWS_PER_BLOCK), so an SM takes several; a row over 48 KB
// gets a block of one warp and the opt-in shared memory.
int launch_layernorm_wide(const void *x, int x_f32, const float *scale, const float *shift,
                          bf16 *y, float *y32, int rows, int d, float eps, cudaStream_t stream) {
  const auto kernel = x_f32 ? layernorm_wide_kernel<true> : layernorm_wide_kernel<false>;
  static int sms = 0, smem_optin = 0;
  static bool opted[2] = {false, false};
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const size_t row_bytes = (size_t)d * (x_f32 ? 4 : 2);
  if (row_bytes > (size_t)smem_optin) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(ROWS_PER_BLOCK, (48 << 10) / row_bytes)));
  const int smem = static_cast<int>(warps * row_bytes);
  if (smem > (48 << 10) && !opted[x_f32]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
    opted[x_f32] = true;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  const int blocks = std::min((rows + warps - 1) / warps, sms * std::max(per_sm, 1));
  kernel<<<blocks, warps * 32, smem, stream>>>(x, scale, shift, y, y32, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

void b3_col_sum_f32(const float *x, int rows, long long n, float *out, float *partial, int parts,
                    cudaStream_t stream) {
  col_sum<true>(x, rows, n, out, partial, parts, stream);
}

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

// x (rows, d) f32 (x_f32) or bf16, scale/shift (d,) f32, all 16-byte
// aligned; y (rows, d) bf16 and/or y32 f32 (either may be null); d % 8 ==
// 0.  d <= 256 · ROW_CHUNKS runs on layernorm_kernel<ceil(d / 256)>, a
// wider row on layernorm_wide_kernel, which needs it to fit one block's
// shared memory (sm_90: 227 KB).
B3_EXPORT int b3_layernorm(const void *x, int x_f32, const void *scale, const void *shift,
                           void *y, void *y32, int rows, int d, float eps, void *stream) {
  const float *g = static_cast<const float *>(scale), *b = static_cast<const float *>(shift);
  bf16 *yb = static_cast<bf16 *>(y);
  float *yf = static_cast<float *>(y32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 255) / 256) {
    case 1: return launch_layernorm<1>(x, x_f32, g, b, yb, yf, rows, d, eps, s);
    case 2: return launch_layernorm<2>(x, x_f32, g, b, yb, yf, rows, d, eps, s);
    case 3: return launch_layernorm<3>(x, x_f32, g, b, yb, yf, rows, d, eps, s);
    case 4: return launch_layernorm<4>(x, x_f32, g, b, yb, yf, rows, d, eps, s);
    case 5: return launch_layernorm<5>(x, x_f32, g, b, yb, yf, rows, d, eps, s);
    default: return launch_layernorm_wide(x, x_f32, g, b, yb, yf, rows, d, eps, s);
  }
}

// x (rows, d) f32 or bf16 → q (rows, d) int8, scale (rows,) f32; d % 8 == 0.
B3_EXPORT int b3_quant_rows(const void *x, int x_f32, void *q, void *scale, int rows, int d,
                            void *stream) {
  quant_rows_kernel<<<row_grid(rows), ROWS_PER_BLOCK * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, x_f32, static_cast<int8_t *>(q), static_cast<float *>(scale), rows, d);
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

// x (rows, n) f32 or bf16 → out (n,) f32; n % 8 == 0; partial (parts, n)
// f32 scratch when parts > 1.
B3_EXPORT int b3_col_sum(const void *x, int x_f32, int rows, int n, void *out, void *partial,
                         int parts, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    col_sum<true>(x, rows, n, static_cast<float *>(out), static_cast<float *>(partial), parts, s);
  else
    col_sum<false>(x, rows, n, static_cast<float *>(out), static_cast<float *>(partial), parts, s);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, d) f32 or bf16, dy (rows, d) f32, gamma (d,) f32, res (rows, d)
// f32 or bf16 or null → dx (rows, d) f32 or bf16, optionally a bf16 copy
// dx16 of it, and dgb (2d,) = [dγ | dβ]; partial (blocks, 2d) f32 scratch;
// d % 8 == 0 and d <= 1280.
B3_EXPORT int b3_layernorm_bwd(const void *x, int x_f32, const void *dy, const void *gamma,
                               const void *res, int res_f32, void *dx, int dx_f32, void *dx16,
                               void *dgb, void *partial, int rows, int d, int blocks, float eps,
                               void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  layernorm_bwd_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, s>>>(
      x, x_f32, static_cast<const float *>(dy), static_cast<const float *>(gamma), res, res_f32,
      dx, dx_f32, static_cast<bf16 *>(dx16), static_cast<float *>(partial), rows, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  col_sum<true>(partial, blocks, 2LL * d, static_cast<float *>(dgb), nullptr, 1, s);
  return static_cast<int>(cudaGetLastError());
}
