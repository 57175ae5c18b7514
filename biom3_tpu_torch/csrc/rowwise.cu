// Row-wise kernels of the Stage-3 stack and the BERT and ESM2 towers: the
// parts of the TPU kernels that are reductions and gathers with no matrix
// product.
//
// * bias_layernorm — x + per-row-group bias, then LayerNorm: the prologue
//   of biom3_tpu/ops/pallas/fused_layer_tpu.py:186 (fused_attn_half,
//   :117-119) and of each layer of stack_kernel_tpu.py:765
//   (fused_stack_logits, :541-547).  Writes xb (f32, it is the residual of
//   the attention half) and LN(xb) (bf16, the q/k/v GEMM's input).  It is
//   layernorm's kernels with the bias row added to each chunk as it is
//   loaded: one read of h, the bits of the two-pass reference order.
// * layernorm — the FF half's pre-norm (fused_layer_tpu.py:269,
//   fused_ff_half :255) and BERT's post-norms (bert_stack_tpu.py:198,
//   :138-141 and :176-179), eps passed in.  One read of each row: up to
//   d = 1280 the row, γ and β stay in registers (layernorm_kernel), a
//   wider row is staged in shared memory (layernorm_wide_kernel), and one
//   past a block's shared memory is read three times from global memory.
// * embed_tokens — tok[ids] + pos_emb, the l == 0 embed of
//   stack_kernel_tpu.py:522-537 (a one-hot matmul there; a gather here).
// (gather_head, the stack's last epilogue, is in gather_head.cu: its head
// product runs on the tensor cores.)
// * esm2_embed — the l == 0 embed of esm2_stack_tpu.py:294 (fused_esm2_cls,
//   :91-115): table[id] with fair-esm's token-dropout rescale, <mask> and
//   PAD rows zeroed.  The rescale needs the row's <mask> and PAD counts, so
//   every block first counts over its batch row (L ids, a few KB from L2)
//   and then writes its tile of sequence rows.
// * layernorm_bwd — _ln_bwd of the training kernels
//   (biom3_tpu/ops/pallas/layer_block_tpu.py:58-68, inside
//   layer_block_tpu.py:419 _bwd_call and esm2_block_tpu.py:411): recomputes
//   x̂ and rstd from the layer's f32 (or bf16) input, dx = rstd·(dŷγ −
//   mean(dŷγ) − x̂·mean(dŷγ·x̂)) plus the residual's gradient, and dγ = Σ
//   dŷ·x̂, dβ = Σ dŷ over the rows.  Bound: bytes (x, dy, the residual and
//   γ read once, dx and its copy written once).  One launch: up to d = 1280
//   a warp stages its next row by cp.async while a lane holds x̂ and dy of
//   its columns of this one in registers (layernorm_bwd_kernel<ceil(d /
//   256)>), a wider row is staged in shared memory and worked on there
//   (layernorm_bwd_wide_kernel); the grid fills the SMs (occupancy),
//   each block sums its rows' dγ/dβ into one partial row, and the last
//   blocks to finish add the partial rows over column tiles in row order
//   (lnb_tail) — the TPU adds them into one f32 strip over its sequential
//   grid, which blocks running in parallel cannot do without atomics.
// * col_sum — f32 column sums of an (rows, n) matrix: the bias gradients
//   dbo, db1, db2 (layer_block_tpu.py:230,240,262; esm2_block_tpu.py:187,
//   352) and the fixed-order reduction of the split-K weight gradients
//   (gemm_bf16.cu).  Bound: bytes (the matrix read once).  One launch: a
//   grid of 64-column tiles × row slabs sized to fill the SMs, 8 rows'
//   16-byte loads in flight a thread; the last block of a tile (an integer
//   ticket) adds its slab sums in slab order.  Deterministic: fixed orders,
//   no float atomics.  The tickets are one set per device, so calls on one
//   device run one at a time (the port launches on one stream).
// * quant_rows — the dynamic per-token activation quant of the int8 serving
//   recipe (biom3_tpu/ops/pallas/quant.py:35-47, run inside
//   stack_kernel_tpu.py:765, bert_stack_tpu.py:198, esm2_stack_tpu.py:294
//   ahead of every int8 product): amax = max(max|x|, 1e-6) over the row in
//   f32, codes rint(x · (127 / amax)) clipped to ±127 (one reciprocal
//   multiplier, round half to even, as jnp.round), scale amax · (1/127).
//   Its codes and scales equal the plain version's bit for bit.  Bound:
//   bytes (the row read once, codes and scale written once).  One read:
//   the row stays in registers as loaded, over one warp up to 2048 columns
//   (a Stage-3 FF row in f32) and over 2, 4 or 8 warps of a block past
//   that (ESM2's 5120), the amax combined in shared memory; the grid fills
//   the SMs and walks rows with the next rows' loads in flight; codes go
//   out in 16-byte stores where d % 16 == 0.
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
// 256 columns a chunk, so d <= 1280 (ESM2-650M) — the register routes of
// layernorm and layernorm_bwd.
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

// layernorm and bias_layernorm: one read of x.  Rows of up to ROW_CHUNKS
// chunks a lane (d <= 1280) run on layernorm_rows (layernorm_kernel,
// bias_layernorm_kernel), wider ones on layernorm_wide_rows
// (layernorm_wide_kernel, bias_layernorm_wide_kernel).  Both sum the mean, then the centred sum of
// squares, in row_stats' order (chunk by chunk, 8 columns in order, one
// warp_sum), so the output has the bits of a kernel that reads the row
// three times.  With BIAS (bias_layernorm) x is h in bf16: each chunk adds
// its batch row's bias chunk as it is loaded, the sum goes out as xb (f32)
// and is normalised into y (bf16).
struct RowBias {
  const bf16 *bias;   // (rows / per, d)
  float *xb;          // (rows, d)
  int per;            // rows that share a bias row
};

__device__ __forceinline__ void store8_f32(float *p, const float *v) {
  float4 *q = reinterpret_cast<float4 *>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16 *y, float *y32, size_t off, const float *v) {
  if (y) *reinterpret_cast<uint4 *>(y + off) = pack8(v);
  if (y32) store8_f32(y32 + off, v);
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
// 256·i, i < NC, those < d), and issues the next row's loads (with BIAS its
// bias row's too) before it reduces the current one; the grid is sized from
// the SM count and each warp walks rows gridDim·8 apart.  γ and β arrive
// once a warp as float4 loads and stay in registers across its rows.
template <int NC, bool F32, bool BIAS>
__device__ __forceinline__ void layernorm_rows(const void *__restrict__ x,
                                               const float *__restrict__ scale,
                                               const float *__restrict__ shift,
                                               bf16 *__restrict__ y, float *__restrict__ y32,
                                               int rows, int d, float eps, const RowBias &rb) {
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
  Chunk<false> braw[NC];   // BIAS: the row's bias chunks
  auto load = [&](int r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) {
        raw[i].load(x, (size_t)r * d + c);
        if constexpr (BIAS) braw[i].load(rb.bias, (size_t)(r / rb.per) * d + c);
      }
    }
  };
  load(row);
  for (; row < rows; row += stride) {
    float v[NC][8];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c >= d) continue;
      raw[i].unpack(v[i]);
      if constexpr (BIAS) {
        float a[8];
        braw[i].unpack(a);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] += a[e];
        store8_f32(rb.xb + (size_t)row * d + c, v[i]);
      }
    }
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
// of 4096): with STAGED each warp copies its row once into shared memory
// with cp.async, 16 bytes at a time, and each lane reads back only the
// columns it copied, so no barrier is needed.  row_stats and the normalise
// loop then read the row there; γ and β (and with BIAS the bias row) come
// as 16-byte loads for each chunk, from L1/L2 (every warp reads the same
// ones).  blockDim.x / 32 warps, each with d elements of the input's type
// in shared memory.  A row past one block's shared memory runs without
// STAGED and reads x three times from global memory, in the same order.
template <bool F32, bool BIAS, bool STAGED>
__device__ __forceinline__ void layernorm_wide_rows(const void *__restrict__ x,
                                                    const float *__restrict__ scale,
                                                    const float *__restrict__ shift,
                                                    bf16 *__restrict__ y, float *__restrict__ y32,
                                                    int rows, int d, float eps, const RowBias &rb) {
  extern __shared__ __align__(16) unsigned char staged[];
  constexpr int ESZ = F32 ? 4 : 2;   // bytes an element: a chunk is 2 or 1 copies of 16
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned char *row_s = staged + (size_t)warp * d * ESZ;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(row_s));
  for (int row = blockIdx.x * warps + warp; row < rows; row += gridDim.x * warps) {
    const void *src = x;   // the row: x from column off, or its staged copy from 0
    size_t off = (size_t)row * d;
    if constexpr (STAGED) {
      const char *xr = static_cast<const char *>(x) + off * ESZ;
      for (int c = lane * 8; c < d; c += 256)
#pragma unroll
        for (int k = 0; k < ESZ / 2; ++k)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + c * ESZ + 16 * k),
                       "l"(xr + c * ESZ + 16 * k));
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      src = row_s;
      off = 0;
    }
    float mean, rstd, v[8], g[8], b[8];
    const bf16 *brow = BIAS ? rb.bias + (size_t)(row / rb.per) * d : nullptr;
    row_stats(src, F32, off, brow, d, lane, eps, mean, rstd);
    for (int c = lane * 8; c < d; c += 256) {
      load8(src, off + c, F32, v);
      if constexpr (BIAS) {
        unpack8(*reinterpret_cast<const uint4 *>(brow + c), g);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += g[e];
        store8_f32(rb.xb + (size_t)row * d + c, v);
      }
      load8(scale, c, 1, g);
      load8(shift, c, 1, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * rstd * g[e] + b[e];
      store8(y, y32, (size_t)row * d + c, v);
    }
  }
}

// The kernels: layernorm's (rb unused) and bias_layernorm's, one signature.
#define B3_LN_PARAMS                                                                      \
  const void *__restrict__ x, const float *__restrict__ scale,                            \
      const float *__restrict__ shift, bf16 *__restrict__ y, float *__restrict__ y32, int rows, \
      int d, float eps, RowBias rb
#define B3_LN_ARGS x, scale, shift, y, y32, rows, d, eps, rb

template <int NC, bool F32>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32) layernorm_kernel(B3_LN_PARAMS) {
  layernorm_rows<NC, F32, false>(B3_LN_ARGS);
}

template <int NC>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32) bias_layernorm_kernel(B3_LN_PARAMS) {
  layernorm_rows<NC, false, true>(B3_LN_ARGS);
}

template <bool F32, bool STAGED>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32) layernorm_wide_kernel(B3_LN_PARAMS) {
  layernorm_wide_rows<F32, false, STAGED>(B3_LN_ARGS);
}

template <bool STAGED>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32) bias_layernorm_wide_kernel(B3_LN_PARAMS) {
  layernorm_wide_rows<false, true, STAGED>(B3_LN_ARGS);
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

// quant_rows: one read of each row.  A row is split over `wpr` warps of
// the block (1, 2, 4 or 8: the fewest that hold it at NC chunks a lane or
// less, NC <= QR_CHUNKS), and each lane keeps its chunks as loaded
// (Chunk<F32>): warp `piece` of a row holds chunks piece, piece + wpr, ...
// (columns lane·8 + 256·chunk).  The grid is sized from the SM count (up to
// QR_WAVES waves); each block walks groups of 8 / wpr rows gridDim apart
// and issues its next rows' loads (into a second set of chunks, bf16 still
// packed) before it reduces the current ones.  Rows of at most 2 chunks'
// registers (512 bf16, 256 f32) run 8 blocks an SM.  amax: a warp max,
// then with wpr > 1 the row's warps' maxima through shared memory.  Codes
// go out 8 a lane; with st16 (d % 16 == 0) each even lane takes its odd
// neighbour's 8 by shuffle and stores 16 bytes.
constexpr int QR_CHUNKS = 8;   // 2048 columns a warp: a Stage-3 FF row in f32
// Blocks of quant_rows: up to this many waves of resident blocks.  With
// one, the rows a warp walks differ by one, and on the card the last
// round's idle warps showed at Stage-3 B=32's and ESM2 B=16's narrow rows
// (bf16, 512 and 1280 columns).
constexpr int QR_WAVES = 8;

// 8 codes rint(v · mul) clipped to ±127, packed little-endian.
__device__ __forceinline__ uint2 codes8(const float *v, float mul) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = static_cast<int>(fminf(fmaxf(rintf(v[e] * mul), -127.f), 127.f));
    w[e / 4] |= (static_cast<uint32_t>(c) & 0xffu) << (8 * (e % 4));
  }
  return make_uint2(w[0], w[1]);
}

template <int NC, bool F32>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32, (F32 ? 2 : 1) * NC <= 2 ? 8 : 1)
quant_rows_kernel(const void *__restrict__ x, int8_t *__restrict__ q, float *__restrict__ scale,
                  int rows, int d, int wpr, int st16) {
  __shared__ float part[ROWS_PER_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = ROWS_PER_BLOCK / wpr, slot = warp / wpr, piece = warp % wpr;
  const int step = gridDim.x * group;
  Chunk<F32> raw[NC], next[NC];   // this row and the next, as loaded
  auto col = [&](int i) { return lane * 8 + (piece + i * wpr) * 256; };
  auto load = [&](Chunk<F32>(&dst)[NC], int r) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (col(i) < d) dst[i].load(x, (size_t)r * d + col(i));
  };
  if (blockIdx.x * group + slot < rows) load(raw, blockIdx.x * group + slot);
  for (int base = blockIdx.x * group; base < rows; base += step) {   // uniform in the block
    const int row = base + slot;
    const bool live = row < rows;
    if (row + step < rows) load(next, row + step);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (!live || col(i) >= d) continue;
      float v[8];
      raw[i].unpack(v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
    if (wpr > 1) {
      if (lane == 0) part[warp] = amax;
      __syncthreads();
      for (int k = 0; k < wpr; ++k) amax = fmaxf(amax, part[slot * wpr + k]);
      __syncthreads();   // part is written again next round
    }
    amax = fmaxf(amax, 1e-6f);
    const float mul = 127.0f / amax;
    if (!live) continue;
    int8_t *qrow = q + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float v[8];
      raw[i].unpack(v);   // a lane past d holds stale values: its codes are not stored
      const uint2 mine = codes8(v, mul);
      if (st16) {   // d % 16 == 0: the lanes of a chunk that hold columns come in pairs
        const uint32_t nx = __shfl_down_sync(0xffffffffu, mine.x, 1);
        const uint32_t ny = __shfl_down_sync(0xffffffffu, mine.y, 1);
        if (!(lane & 1) && col(i) < d)
          *reinterpret_cast<uint4 *>(qrow + col(i)) = make_uint4(mine.x, mine.y, nx, ny);
      } else if (col(i) < d) {
        *reinterpret_cast<uint2 *>(qrow + col(i)) = mine;
      }
    }
    if (piece == 0 && lane == 0) scale[row] = amax * (1.0f / 127.0f);
#pragma unroll
    for (int i = 0; i < NC; ++i) raw[i] = next[i];
  }
}

inline dim3 row_grid(int rows) { return dim3((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK); }

// --------------------------------------------------------------------------
// col_sum and layernorm_bwd: column reductions in a fixed order
// --------------------------------------------------------------------------

constexpr int RED_THREADS = 256;   // threads of a col_sum or layernorm_bwd block

__device__ __forceinline__ void cp_async16(const void *smem, const void *gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 8 f32 columns another block wrote in this launch: read from L2 (.cg), past
// this SM's L1.
__device__ __forceinline__ void load8_l2(const float *p, float *v) {
  const float4 a = __ldcg(reinterpret_cast<const float4 *>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4 *>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned *p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A block's column sums over the W = 8·LPR columns [c0, c0 + W) of rows
// [r0, r1) of x (rows, n): thread (g, l) = (tid / LPR, tid % LPR) adds rows
// r0 + g, r0 + g + G, ... (G = 256 / LPR) in order into its 8 columns,
// with U rows' 16-byte loads in flight (8 of them); then each column's G partial sums
// are added in g order (in K = 256 / W runs of G / K, then the K runs in
// order).  Thread t < W returns the sum of column c0 + t.  `red` is shared
// memory of col_red_floats<LPR>() floats; every thread of the block calls.
// With LPR = 32 (G = 8, K = 1) the order is the one col_sum had when it
// summed the split-K slabs of gemm_dw, whose bits it keeps.
template <int LPR>
__host__ __device__ constexpr int col_red_floats() {
  return (RED_THREADS / LPR) * LPR * 8 + (LPR * 8 < RED_THREADS ? RED_THREADS : 0);
}

template <bool F32, int LPR, bool L2_ONLY>
__device__ float block_col_sum(const void *__restrict__ x, int r0, int r1, long long n,
                               long long c0, float *red) {
  constexpr int G = RED_THREADS / LPR, W = LPR * 8, K = RED_THREADS / W, U = F32 ? 4 : 8;
  const int g = threadIdx.x / LPR, l = threadIdx.x % LPR;
  const long long c = c0 + l * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < n)
    for (int r = r0 + g; r < r1; r += G * U) {
      Chunk<F32> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * G < r1) {
          const size_t off = (size_t)(r + u * G) * n + c;
          if constexpr (L2_ONLY) load8_l2(static_cast<const float *>(x) + off, raw[u].f);
          else raw[u].load(x, off);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * G < r1) {
          float v[8];
          raw[u].unpack(v);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += v[e];
        }
    }
  __syncthreads();   // red may still be read by a previous call
#pragma unroll
  for (int e = 0; e < 8; ++e) red[g * W + l * 8 + e] = acc[e];
  __syncthreads();
  const int col = threadIdx.x % W, k = threadIdx.x / W;
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < G / K; ++i) a += red[(k * (G / K) + i) * W + col];
  if constexpr (K == 1) {
    return a;
  } else {
    float *runs = red + G * W;
    runs[k * W + col] = a;
    __syncthreads();
    a = 0.f;
    if (threadIdx.x < W)
#pragma unroll
      for (int i = 0; i < K; ++i) a += runs[i * W + col];
    return a;
  }
}

constexpr int CS_LPR = 8;                   // col_sum: 64-column tiles, 32 rows at once
constexpr int CS_TILE = CS_LPR * 8;
constexpr int CS_MAX_TILES = 4096;          // tiles that may have more than one slab
__device__ unsigned int cs_tickets[CS_MAX_TILES];   // one a tile; each resets itself

// Grid (tiles, slabs): block (t, s) sums rows [s·per, (s+1)·per) over tile
// t's columns.  With one slab it writes out; else it writes its slab sum,
// and the last block of the tile to finish (an integer ticket after a
// fence) adds the tile's slab sums in slab order and resets the ticket.
template <bool F32, int LPR>
__global__ void __launch_bounds__(RED_THREADS)
col_sum_kernel(const void *__restrict__ x, int rows, long long n, int per, int slabs,
               float *__restrict__ out, float *__restrict__ slab_sums) {
  __shared__ float red[col_red_floats<LPR>()];
  __shared__ bool last;
  constexpr int W = LPR * 8;
  const long long c0 = (long long)blockIdx.x * W, col = c0 + threadIdx.x;
  const int r0 = blockIdx.y * per, r1 = min(rows, r0 + per);
  float s = block_col_sum<F32, LPR, false>(x, r0, r1, n, c0, red);
  const bool owner = threadIdx.x < W && col < n;
  if (slabs == 1) {
    if (owner) out[col] = s;
    return;
  }
  if (owner) slab_sums[(size_t)blockIdx.y * n + col] = s;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&cs_tickets[blockIdx.x], 1u) == (unsigned)slabs - 1;
    if (last) cs_tickets[blockIdx.x] = 0;   // every slab of the tile has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  s = block_col_sum<true, LPR, true>(slab_sums, 0, slabs, n, c0, red);
  if (owner) out[col] = s;
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// layernorm_bwd's dγ/dβ tail.  Each block has written its partial row
// [dγ | dβ] (2d floats) to partial[blockIdx.x].  The last T blocks to take
// a ticket wait until all P = gridDim.x have (the blocks still running
// need no slot: at least P − T ≥ T − 1 blocks have left), then tail block j
// sums 64-column tiles j, j + T, ... over the P partial rows with
// block_col_sum: row order within a thread, then the fixed merge — the
// bits do not depend on which block finished when.  The last tail block
// out resets both tickets.  A wait over ~10 s traps: a fault fails the
// launch instead of hanging the card.
__device__ unsigned int lnb_arrived, lnb_left;

__device__ void lnb_tail(const float *partial, long long n2, float *dgb, int T, float *red) {
  __shared__ int slot;
  const int P = gridDim.x;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    slot = (int)atomicAdd(&lnb_arrived, 1u) - (P - T);
    if (slot >= 0) {
      unsigned long long t0, t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
      while (ld_acquire(&lnb_arrived) < (unsigned)P) {
        __nanosleep(32);
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        if (t - t0 > 10000000000ull) __trap();
      }
    }
  }
  __syncthreads();
  if (slot < 0) return;
  __threadfence();
  for (long long c0 = (long long)slot * CS_TILE; c0 < n2; c0 += (long long)T * CS_TILE) {
    const float s = block_col_sum<true, CS_LPR, true>(partial, 0, P, n2, c0, red);
    if (threadIdx.x < CS_TILE && c0 + threadIdx.x < n2) dgb[c0 + threadIdx.x] = s;
  }
  if (threadIdx.x == 0 && atomicAdd(&lnb_left, 1u) == (unsigned)T - 1) {
    lnb_arrived = 0;
    lnb_left = 0;
  }
}

// Stores one chunk of dx (f32 or bf16) and its optional bf16 copy.
__device__ __forceinline__ void store_dx(void *dx, int dx_f32, bf16 *dx16, size_t off,
                                         const float *o) {
  if (dx_f32) {
    float4 *p = reinterpret_cast<float4 *>(static_cast<float *>(dx) + off);
    p[0] = make_float4(o[0], o[1], o[2], o[3]);
    p[1] = make_float4(o[4], o[5], o[6], o[7]);
  } else {
    *reinterpret_cast<uint4 *>(static_cast<bf16 *>(dx) + off) = pack8(o);
  }
  if (dx16) *reinterpret_cast<uint4 *>(dx16 + off) = pack8(o);
}

// Copies a lane's chunks (columns lane·8 + 256·i < d) of one row, esz
// bytes an element, into a shared row laid out as the global one.
__device__ __forceinline__ void stage_row(unsigned char *dst, const void *src, size_t row, int d,
                                          int esz, int lane) {
  const char *s = static_cast<const char *>(src) + row * d * esz;
  for (int c = lane * 8; c < d; c += 256)
    for (int k = 0; k < esz / 2; ++k) cp_async16(dst + c * esz + 16 * k, s + c * esz + 16 * k);
}

// Register route, d <= 256·NC: a warp per row, 8 rows at once, rows
// gridDim·8 apart.  A lane loads its NC chunks of x and dy together and
// keeps x̂, dy and its columns' dγ/dβ sums in registers; γ sits in shared
// memory, read once a block; the residual's chunks go to the warp's shared
// slot by cp.async at the row's start and are read back for the output.
// x, dy, the residual and γ are each read once.  At the end the 8 warps'
// sums are added in warp order into the block's partial row, and lnb_tail
// adds the partial rows.  Shared memory: γ (NC·256 floats), then one region
// that holds the warps' residual rows in the row loop, their sums after it
// and block_col_sum's scratch in the tail (at most 45 KB).
template <int NC>
constexpr size_t lnb_smem() {
  return (NC * 256 + std::max(ROWS_PER_BLOCK * NC * 256, col_red_floats<CS_LPR>())) *
         sizeof(float);
}

template <int NC, bool XF32>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32, NC <= 2 ? 2 : 1)
layernorm_bwd_kernel(const void *__restrict__ x, const float *__restrict__ dy,
                     const float *__restrict__ gamma, const void *__restrict__ res, int res_f32,
                     void *__restrict__ dx, int dx_f32, bf16 *__restrict__ dx16,
                     float *__restrict__ dgb, float *__restrict__ partial, int rows, int d,
                     float eps, int tail) {
  extern __shared__ __align__(16) float lnb_smem_f[];
  float *gs = lnb_smem_f, *region = lnb_smem_f + NC * 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *slot = region + warp * NC * 256;   // this warp's residual row, then its sums
  const int res_esz = res_f32 ? 4 : 2;
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4)
    *reinterpret_cast<float4 *>(gs + c) = *reinterpret_cast<const float4 *>(gamma + c);
  __syncthreads();
  float dg[NC][8], db[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[i][e] = db[i][e] = 0.f;

  for (int row = blockIdx.x * ROWS_PER_BLOCK + warp; row < rows;
       row += gridDim.x * ROWS_PER_BLOCK) {
    const size_t off = (size_t)row * d;
    if (res) stage_row(reinterpret_cast<unsigned char *>(slot), res, row, d, res_esz, lane);
    Chunk<XF32> raw[NC];
    float gv[NC][8], xv[NC][8];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) {
        raw[i].load(x, off + c);
        load8(dy, off + c, 1, gv[i]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + i * 256 < d) {
        raw[i].unpack(xv[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += xv[i][e];
      }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + i * 256 < d)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[i][e] -= mean;
          q += xv[i][e] * xv[i][e];
        }
    const float rstd = rsqrtf(warp_sum(q) / d + eps);
    // x̂ in xv; the row means of dŷ·γ and dŷ·γ·x̂
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) {
        float g[8];
        load8(gs, c, 1, g);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[i][e] *= rstd;
          dg[i][e] += gv[i][e] * xv[i][e];
          db[i][e] += gv[i][e];
          const float t = gv[i][e] * g[e];
          s1 += t;
          s2 += t * xv[i][e];
        }
      }
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
    if (res) cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) {
        float g[8], r[8], o[8];
        load8(gs, c, 1, g);
        if (res) load8(slot, c, res_f32, r);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = rstd * (gv[i][e] * g[e] - s1 - xv[i][e] * s2);
          if (res) o[e] += r[e];
        }
        store_dx(dx, dx_f32, dx16, off + c, o);
      }
    }
  }
  // the block's partial row [dγ | dβ]: the 8 warps' sums in warp order
  float *prow = partial + (size_t)blockIdx.x * 2 * d;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) store8(nullptr, slot, c, pass ? db[i] : dg[i]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < ROWS_PER_BLOCK; ++w) a += region[w * NC * 256 + c];
      prow[pass * d + c] = a;
    }
    __syncthreads();
  }
  lnb_tail(partial, 2LL * d, dgb, tail, region);
}

// Shared-memory route (every d > 256·ROW_CHUNKS): blocks of 8 warps take
// `round_rows` rows a round (as many as WIDE_STAGE_BYTES of staging hold,
// at least one).  Warp w < round_rows copies one row's x, dy and residual
// into its shared slot (cp.async), takes the row statistics and the two
// row means there and writes dx (γ from L1/L2).  Then, after a barrier,
// thread t adds the round's rows in warp order into its columns t·4 +
// 1024·k of the block's dγ/dβ sums — in registers up to d = 4096, else in
// the block's partial row, which it alone reads and writes (in L2) — and
// lnb_tail adds the partial rows.
template <bool XF32>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
layernorm_bwd_wide_kernel(const void *__restrict__ x, const float *__restrict__ dy,
                          const float *__restrict__ gamma, const void *__restrict__ res,
                          int res_f32, void *__restrict__ dx, int dx_f32, bf16 *__restrict__ dx16,
                          float *__restrict__ dgb, float *__restrict__ partial, int rows, int d,
                          float eps, int tail, int round_rows) {
  extern __shared__ __align__(16) unsigned char lnbw_smem[];
  __shared__ float stats[ROWS_PER_BLOCK][2];   // mean, rstd of each warp's row
  constexpr int XSZ = XF32 ? 4 : 2, GROUPS = 4, STEP = ROWS_PER_BLOCK * 32 * 4;
  const int warps = round_rows, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int res_esz = res ? (res_f32 ? 4 : 2) : 0;
  const size_t row_bytes = (size_t)d * (XSZ + 4 + res_esz);
  auto xs = [&](int w) { return lnbw_smem + w * row_bytes; };
  auto dys = [&](int w) { return reinterpret_cast<float *>(xs(w) + d * XSZ); };
  float *prow = partial + (size_t)blockIdx.x * 2 * d;
  const bool in_regs = d <= GROUPS * STEP;
  float4 a[GROUPS], b[GROUPS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) a[j] = b[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!in_regs)
    for (int c = threadIdx.x * 4; c < d; c += STEP) {
      *reinterpret_cast<float4 *>(prow + c) = a[0];
      *reinterpret_cast<float4 *>(prow + d + c) = a[0];
    }
  for (int base = blockIdx.x * warps; base < rows; base += gridDim.x * warps) {
    const int row = base + warp;
    if (warp < warps && row < rows) {
      const size_t off = (size_t)row * d;
      unsigned char *xr = xs(warp), *rr = xr + d * (XSZ + 4);
      float *dr = dys(warp);
      stage_row(xr, x, row, d, XSZ, lane);
      stage_row(reinterpret_cast<unsigned char *>(dr), dy, row, d, 4, lane);
      if (res) stage_row(rr, res, row, d, res_esz, lane);
      cp_async_wait_all();
      float sx = 0.f, q = 0.f, s1 = 0.f, s2 = 0.f, v[8], gv[8], g[8], r[8], o[8];
#pragma unroll 4
      for (int c = lane * 8; c < d; c += 256) {
        load8(xr, c, XF32, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) sx += v[e];
      }
      const float mean = warp_sum(sx) / d;
#pragma unroll 4
      for (int c = lane * 8; c < d; c += 256) {
        load8(xr, c, XF32, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (v[e] - mean) * (v[e] - mean);
      }
      const float rstd = rsqrtf(warp_sum(q) / d + eps);
#pragma unroll 4
      for (int c = lane * 8; c < d; c += 256) {
        load8(xr, c, XF32, v);
        load8(dr, c, 1, gv);
        load8(gamma, c, 1, g);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = gv[e] * g[e];
          s1 += t;
          s2 += t * ((v[e] - mean) * rstd);
        }
      }
      s1 = warp_sum(s1) / d;
      s2 = warp_sum(s2) / d;
#pragma unroll 2
      for (int c = lane * 8; c < d; c += 256) {
        load8(xr, c, XF32, v);
        load8(dr, c, 1, gv);
        load8(gamma, c, 1, g);
        if (res) load8(rr, c, res_f32, r);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = rstd * (gv[e] * g[e] - s1 - ((v[e] - mean) * rstd) * s2);
          if (res) o[e] += r[e];
        }
        store_dx(dx, dx_f32, dx16, off + c, o);
      }
      if (lane == 0) {
        stats[warp][0] = mean;
        stats[warp][1] = rstd;
      }
    }
    __syncthreads();
    const int live = min(warps, rows - base);
    for (int c0 = threadIdx.x * 4; c0 < d; c0 += GROUPS * STEP) {
      if (!in_regs)
#pragma unroll
        for (int j = 0; j < GROUPS; ++j)
          if (c0 + j * STEP < d) {
            a[j] = *reinterpret_cast<const float4 *>(prow + c0 + j * STEP);
            b[j] = *reinterpret_cast<const float4 *>(prow + d + c0 + j * STEP);
          }
      for (int w = 0; w < live; ++w) {
        const float mean = stats[w][0], rstd = stats[w][1];
#pragma unroll
        for (int j = 0; j < GROUPS; ++j) {
          const int c = c0 + j * STEP;
          if (c >= d) continue;
          float xv[4];
          if constexpr (XF32) {
            const float4 t = *reinterpret_cast<const float4 *>(xs(w) + c * 4);
            xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
          } else {
            const uint2 t = *reinterpret_cast<const uint2 *>(xs(w) + c * 2);
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&t.x));
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&t.y));
            xv[0] = lo.x; xv[1] = lo.y; xv[2] = hi.x; xv[3] = hi.y;
          }
          const float4 gy = *reinterpret_cast<const float4 *>(dys(w) + c);
          a[j].x += gy.x * ((xv[0] - mean) * rstd);
          a[j].y += gy.y * ((xv[1] - mean) * rstd);
          a[j].z += gy.z * ((xv[2] - mean) * rstd);
          a[j].w += gy.w * ((xv[3] - mean) * rstd);
          b[j].x += gy.x;
          b[j].y += gy.y;
          b[j].z += gy.z;
          b[j].w += gy.w;
        }
      }
      if (!in_regs)
#pragma unroll
        for (int j = 0; j < GROUPS; ++j)
          if (c0 + j * STEP < d) {
            *reinterpret_cast<float4 *>(prow + c0 + j * STEP) = a[j];
            *reinterpret_cast<float4 *>(prow + d + c0 + j * STEP) = b[j];
          }
    }
    __syncthreads();
  }
  if (in_regs)
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const int c = threadIdx.x * 4 + j * STEP;
      if (c < d) {
        *reinterpret_cast<float4 *>(prow + c) = a[j];
        *reinterpret_cast<float4 *>(prow + d + c) = b[j];
      }
    }
  lnb_tail(partial, 2LL * d, dgb, tail, reinterpret_cast<float *>(lnbw_smem));
}

// The shared-memory route's rows a round and dynamic shared memory (the
// staged rows, at least block_col_sum's scratch for the tail).
constexpr size_t WIDE_STAGE_BYTES = 160 << 10;

struct WidePlan {
  int round_rows;
  size_t smem;
};

WidePlan lnb_wide_plan(int d, int x_f32, int res_bytes) {
  const size_t row_bytes = (size_t)d * ((x_f32 ? 8 : 6) + res_bytes);
  const int n = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(ROWS_PER_BLOCK, WIDE_STAGE_BYTES / row_bytes)));
  return {n, std::max<size_t>(n * row_bytes, col_red_floats<CS_LPR>() * sizeof(float))};
}

// Blocks of the register route: all an SM holds (occupancy), at most one
// per 16 rows (two a warp).
template <int NC>
int lnb_grid(int rows, int x_f32) {
  static int per_sm[2] = {0, 0};
  if (!per_sm[x_f32])
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[x_f32], x_f32 ? layernorm_bwd_kernel<NC, true> : layernorm_bwd_kernel<NC, false>,
        ROWS_PER_BLOCK * 32, lnb_smem<NC>());
  return std::max(1, std::min(sm_count() * std::max(per_sm[x_f32], 1),
                              (rows + 2 * ROWS_PER_BLOCK - 1) / (2 * ROWS_PER_BLOCK)));
}

// The shared-memory route's kernel for x's type, opted in to the dynamic
// shared memory `plan` needs past 47 KB (the most asked so far); null if it
// does not fit beside the kernel's static shared memory (under 1 KB).
using LnbWideKernel = void (*)(const void *, const float *, const float *, const void *, int,
                               void *, int, bf16 *, float *, float *, int, int, float, int,
                               int);

LnbWideKernel lnb_wide_kernel(const WidePlan &plan, int x_f32) {
  const LnbWideKernel kernel =
      x_f32 ? layernorm_bwd_wide_kernel<true> : layernorm_bwd_wide_kernel<false>;
  static size_t opted[2] = {0, 0};
  if (plan.smem <= (47 << 10) || plan.smem <= opted[x_f32]) return kernel;
  static int smem_optin = 0;
  if (!smem_optin) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  if (plan.smem + attr.sharedSizeBytes > (size_t)smem_optin) return nullptr;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(plan.smem));
  opted[x_f32] = plan.smem;
  return kernel;
}

// The shared-memory route's blocks the same way; 0 if a row does not fit.
int lnb_wide_grid(int rows, int d, int x_f32, int res_bytes) {
  const WidePlan plan = lnb_wide_plan(d, x_f32, res_bytes);
  const LnbWideKernel kernel = lnb_wide_kernel(plan, x_f32);
  if (!kernel) return 0;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ROWS_PER_BLOCK * 32,
                                                plan.smem);
  return std::max(1, std::min(sm_count() * std::max(per_sm, 1),
                              (rows + 2 * plan.round_rows - 1) / (2 * plan.round_rows)));
}

// The tail's blocks: one per 64-column tile of [dγ | dβ], at most (P + 1) / 2.
inline int lnb_tail_blocks(int blocks, int d) {
  return std::max(1, std::min((2 * d + CS_TILE - 1) / CS_TILE, (blocks + 1) / 2));
}

template <int NC>
int launch_layernorm_bwd(const void *x, int x_f32, const float *dy, const float *gamma,
                         const void *res, int res_f32, void *dx, int dx_f32, bf16 *dx16,
                         float *dgb, float *partial, int rows, int d, int blocks, float eps,
                         cudaStream_t s) {
  const auto kernel = x_f32 ? layernorm_bwd_kernel<NC, true> : layernorm_bwd_kernel<NC, false>;
  kernel<<<blocks, ROWS_PER_BLOCK * 32, lnb_smem<NC>(), s>>>(
      x, dy, gamma, res, res_f32, dx, dx_f32, dx16, dgb, partial, rows, d, eps,
      lnb_tail_blocks(blocks, d));
  return static_cast<int>(cudaGetLastError());
}

int launch_layernorm_bwd_wide(const void *x, int x_f32, const float *dy, const float *gamma,
                              const void *res, int res_f32, void *dx, int dx_f32, bf16 *dx16,
                              float *dgb, float *partial, int rows, int d, int blocks, float eps,
                              cudaStream_t s) {
  const WidePlan plan = lnb_wide_plan(d, x_f32, res ? (res_f32 ? 4 : 2) : 0);
  const LnbWideKernel kernel = lnb_wide_kernel(plan, x_f32);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, ROWS_PER_BLOCK * 32, plan.smem, s>>>(x, dy, gamma, res, res_f32, dx, dx_f32,
                                                        dx16, dgb, partial, rows, d, eps,
                                                        lnb_tail_blocks(blocks, d),
                                                        plan.round_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool BIAS>
int launch_layernorm(const void *x, int x_f32, const float *scale, const float *shift, bf16 *y,
                     float *y32, int rows, int d, float eps, RowBias rb, cudaStream_t stream) {
  const auto kernel = BIAS ? bias_layernorm_kernel<NC>   // bias_layernorm's h is bf16
                          : x_f32 ? layernorm_kernel<NC, true> : layernorm_kernel<NC, false>;
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
  kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, stream>>>(x, scale, shift, y, y32, rows, d, eps, rb);
  return static_cast<int>(cudaGetLastError());
}

// quant_rows_kernel<NC>: QR_WAVES times the blocks that fit on the SMs at
// once (one wave where a warp holds a whole wide row and two blocks fill
// an SM: there the walk with the next row in flight gains more than the
// later waves), or one a group of 8 / wpr rows if that is fewer.
template <int NC>
int launch_quant(const void *x, int x_f32, void *q, void *scale, int rows, int d, int wpr,
                 void *stream) {
  const auto kernel = x_f32 ? quant_rows_kernel<NC, true> : quant_rows_kernel<NC, false>;
  static int per_sm[2] = {0, 0};   // blocks an SM holds, by x_f32
  if (!per_sm[x_f32])
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[x_f32], kernel, ROWS_PER_BLOCK * 32, 0);
  const int group = ROWS_PER_BLOCK / wpr;
  const int waves = wpr == 1 && per_sm[x_f32] <= 2 ? 1 : QR_WAVES;
  const int blocks =
      std::min((rows + group - 1) / group, sm_count() * std::max(per_sm[x_f32], 1) * waves);
  kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int8_t *>(q), static_cast<float *>(scale), rows, d, wpr, d % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

// The wide rows' blocks hold up to 48 KB of staged rows (as many warps as
// fit, at most ROWS_PER_BLOCK), so an SM takes several; a row over 48 KB
// gets a block of one warp and the opt-in shared memory, and a row past
// that a block of ROWS_PER_BLOCK warps that reads it from global memory.
template <bool BIAS>
int launch_layernorm_wide(const void *x, int x_f32, const float *scale, const float *shift,
                          bf16 *y, float *y32, int rows, int d, float eps, RowBias rb,
                          cudaStream_t stream) {
  static int sms = 0, smem_optin = 0;
  static bool opted[2] = {false, false};
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const size_t row_bytes = (size_t)d * (x_f32 ? 4 : 2);
  const bool staged = row_bytes <= (size_t)smem_optin;
  const auto kernel = BIAS    ? (staged ? bias_layernorm_wide_kernel<true>
                                        : bias_layernorm_wide_kernel<false>)
                      : x_f32 ? (staged ? layernorm_wide_kernel<true, true>
                                        : layernorm_wide_kernel<true, false>)
                              : (staged ? layernorm_wide_kernel<false, true>
                                        : layernorm_wide_kernel<false, false>);
  const int warps = !staged ? ROWS_PER_BLOCK : static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(ROWS_PER_BLOCK, (48 << 10) / row_bytes)));
  const int smem = staged ? static_cast<int>(warps * row_bytes) : 0;
  if (smem > (48 << 10) && !opted[x_f32]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
    opted[x_f32] = true;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  const int blocks = std::min((rows + warps - 1) / warps, sms * std::max(per_sm, 1));
  kernel<<<blocks, warps * 32, smem, stream>>>(x, scale, shift, y, y32, rows, d, eps, rb);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// gemm_dw's split-K slabs, x (rows, n) f32 → out (n,): one slab, 8 rows
// at once in 256-column tiles — the order that keeps gemm_dw's bits.
void b3_col_sum_f32(const float *x, int rows, long long n, float *out, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((n + 255) / 256);
  col_sum_kernel<true, 32><<<dim3(tiles, 1), RED_THREADS, 0, stream>>>(x, rows, n, rows, 1, out,
                                                                     nullptr);
}

// All row kernels need d % 8 == 0 and contiguous, 16-byte aligned rows.
// h (rows, d) bf16 + bias (rows / rows_per_bias, d) bf16 → xb (rows, d)
// f32 and LayerNorm(xb) → xn (rows, d) bf16; scale/shift (d,) f32, 16-byte
// aligned.  layernorm's routes: d <= 256 · ROW_CHUNKS in registers, a wider
// row (in bf16) staged in shared memory, one past it read from global memory.
B3_EXPORT int b3_bias_layernorm(const void *h, const void *bias, const void *scale,
                                const void *shift, void *xb, void *xn, int rows,
                                int rows_per_bias, int d, float eps, void *stream) {
  const float *g = static_cast<const float *>(scale), *b = static_cast<const float *>(shift);
  bf16 *y = static_cast<bf16 *>(xn);
  const RowBias rb{static_cast<const bf16 *>(bias), static_cast<float *>(xb), rows_per_bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 || rows_per_bias < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((d + 255) / 256) {
    case 1: return launch_layernorm<1, true>(h, 0, g, b, y, nullptr, rows, d, eps, rb, s);
    case 2: return launch_layernorm<2, true>(h, 0, g, b, y, nullptr, rows, d, eps, rb, s);
    case 3: return launch_layernorm<3, true>(h, 0, g, b, y, nullptr, rows, d, eps, rb, s);
    case 4: return launch_layernorm<4, true>(h, 0, g, b, y, nullptr, rows, d, eps, rb, s);
    case 5: return launch_layernorm<5, true>(h, 0, g, b, y, nullptr, rows, d, eps, rb, s);
    default: return launch_layernorm_wide<true>(h, 0, g, b, y, nullptr, rows, d, eps, rb, s);
  }
}

// x (rows, d) f32 (x_f32) or bf16, scale/shift (d,) f32, all 16-byte
// aligned; y (rows, d) bf16 and/or y32 f32 (either may be null); d % 8 ==
// 0.  d <= 256 · ROW_CHUNKS runs on layernorm_kernel<ceil(d / 256)>, a
// wider row on layernorm_wide_kernel, staged in shared memory where it
// fits one block's (sm_90: 227 KB), else read from global memory.
B3_EXPORT int b3_layernorm(const void *x, int x_f32, const void *scale, const void *shift,
                           void *y, void *y32, int rows, int d, float eps, void *stream) {
  const float *g = static_cast<const float *>(scale), *b = static_cast<const float *>(shift);
  bf16 *yb = static_cast<bf16 *>(y);
  float *yf = static_cast<float *>(y32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowBias none{nullptr, nullptr, 1};
  switch ((d + 255) / 256) {
    case 1: return launch_layernorm<1, false>(x, x_f32, g, b, yb, yf, rows, d, eps, none, s);
    case 2: return launch_layernorm<2, false>(x, x_f32, g, b, yb, yf, rows, d, eps, none, s);
    case 3: return launch_layernorm<3, false>(x, x_f32, g, b, yb, yf, rows, d, eps, none, s);
    case 4: return launch_layernorm<4, false>(x, x_f32, g, b, yb, yf, rows, d, eps, none, s);
    case 5: return launch_layernorm<5, false>(x, x_f32, g, b, yb, yf, rows, d, eps, none, s);
    default: return launch_layernorm_wide<false>(x, x_f32, g, b, yb, yf, rows, d, eps, none, s);
  }
}

// x (rows, d) f32 or bf16 → q (rows, d) int8, scale (rows,) f32; d % 8 == 0,
// d <= 8 warps x QR_CHUNKS x 256 = 16384 (the kernel holds the row).
B3_EXPORT int b3_quant_rows(const void *x, int x_f32, void *q, void *scale, int rows, int d,
                            void *stream) {
  const int chunks = (d + 255) / 256;
  int wpr = 1;
  while (wpr < ROWS_PER_BLOCK && (chunks + wpr - 1) / wpr > QR_CHUNKS) wpr *= 2;
  const int nc = (chunks + wpr - 1) / wpr;
  if (d % 8 || rows < 1 || nc > QR_CHUNKS) return static_cast<int>(cudaErrorInvalidValue);
  switch (nc) {
    case 1: return launch_quant<1>(x, x_f32, q, scale, rows, d, wpr, stream);
    case 2: return launch_quant<2>(x, x_f32, q, scale, rows, d, wpr, stream);
    case 3: return launch_quant<3>(x, x_f32, q, scale, rows, d, wpr, stream);
    case 4: return launch_quant<4>(x, x_f32, q, scale, rows, d, wpr, stream);
    case 5: return launch_quant<5>(x, x_f32, q, scale, rows, d, wpr, stream);
    case 6: return launch_quant<6>(x, x_f32, q, scale, rows, d, wpr, stream);
    case 7: return launch_quant<7>(x, x_f32, q, scale, rows, d, wpr, stream);
    default: return launch_quant<8>(x, x_f32, q, scale, rows, d, wpr, stream);
  }
}

B3_EXPORT int b3_embed_tokens(const void *ids, const void *tok, const void *pos, void *out,
                              int rows, int L, int d, void *stream) {
  embed_tokens_kernel<<<row_grid(rows), ROWS_PER_BLOCK * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int *>(ids), static_cast<const bf16 *>(tok),
      static_cast<const bf16 *>(pos), static_cast<bf16 *>(out), rows, L, d);
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

// Blocks of col_sum an SM holds times the SMs: the wrapper's rule
// (ops/kernels.col_sum_plan) splits the rows into as many slabs as fill
// them in one wave.
B3_EXPORT int b3_col_sum_capacity(int x_f32) {
  static int per_sm[2] = {0, 0};
  if (!per_sm[x_f32])
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[x_f32], x_f32 ? col_sum_kernel<true, CS_LPR> : col_sum_kernel<false, CS_LPR>,
        RED_THREADS, 0);
  return sm_count() * std::max(per_sm[x_f32], 1);
}

// x (rows, n) f32 or bf16 → out (n,) f32; n % 8 == 0; grid (ceil(n / 64),
// slabs), slab s summing rows [s·per, (s+1)·per); slab_sums (slabs, n) f32
// scratch when slabs > 1 (at most CS_MAX_TILES tiles then).
B3_EXPORT int b3_col_sum(const void *x, int x_f32, int rows, int n, void *out, void *slab_sums,
                         int slabs, int per, void *stream) {
  const unsigned tiles = static_cast<unsigned>((n + CS_TILE - 1) / CS_TILE);
  if (slabs < 1 || per < 1 || (slabs > 1 && tiles > CS_MAX_TILES))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = x_f32 ? col_sum_kernel<true, CS_LPR> : col_sum_kernel<false, CS_LPR>;
  kernel<<<dim3(tiles, slabs), RED_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, rows, n, per, slabs, static_cast<float *>(out), static_cast<float *>(slab_sums));
  return static_cast<int>(cudaGetLastError());
}

// layernorm_bwd's blocks for (rows, d), x's type, the residual's bytes an
// element (0: none) and the route (the partial rows the wrapper
// allocates); 0 if the route does not take the row.
B3_EXPORT int b3_layernorm_bwd_grid(int rows, int d, int x_f32, int res_bytes, int wide) {
  if (res_bytes != 0 && res_bytes != 2 && res_bytes != 4) return 0;
  if (wide) return lnb_wide_grid(rows, d, x_f32, res_bytes);
  switch ((d + 255) / 256) {
    case 1: return lnb_grid<1>(rows, x_f32);
    case 2: return lnb_grid<2>(rows, x_f32);
    case 3: return lnb_grid<3>(rows, x_f32);
    case 4: return lnb_grid<4>(rows, x_f32);
    case 5: return lnb_grid<5>(rows, x_f32);
    default: return 0;
  }
}

// x (rows, d) f32 or bf16, dy (rows, d) f32, gamma (d,) f32, res (rows, d)
// f32 or bf16 or null → dx (rows, d) f32 or bf16, optionally a bf16 copy
// dx16 of it, and dgb (2d,) = [dγ | dβ]; partial (blocks, 2d) f32 scratch,
// blocks from b3_layernorm_bwd_grid; d % 8 == 0.  `wide`: the
// shared-memory route (layernorm_bwd_wide_kernel), else the register route
// (layernorm_bwd_kernel<ceil(d / 256)>, d <= 256 · ROW_CHUNKS).
B3_EXPORT int b3_layernorm_bwd(const void *x, int x_f32, const void *dy, const void *gamma,
                               const void *res, int res_f32, void *dx, int dx_f32, void *dx16,
                               void *dgb, void *partial, int rows, int d, int blocks, int wide,
                               float eps, void *stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float *g = static_cast<const float *>(gamma), *dyf = static_cast<const float *>(dy);
  bf16 *d16 = static_cast<bf16 *>(dx16);
  float *out = static_cast<float *>(dgb), *part = static_cast<float *>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B3_LNB_ARGS x, x_f32, dyf, g, res, res_f32, dx, dx_f32, d16, out, part, rows, d, blocks, eps, s
  if (wide) return launch_layernorm_bwd_wide(B3_LNB_ARGS);
  switch ((d + 255) / 256) {
    case 1: return launch_layernorm_bwd<1>(B3_LNB_ARGS);
    case 2: return launch_layernorm_bwd<2>(B3_LNB_ARGS);
    case 3: return launch_layernorm_bwd<3>(B3_LNB_ARGS);
    case 4: return launch_layernorm_bwd<4>(B3_LNB_ARGS);
    case 5: return launch_layernorm_bwd<5>(B3_LNB_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef B3_LNB_ARGS
}
