// stage3_attention_core: the attention of one ProteoScribe layer, from the
// fused q/k/v projection (B, L, 3d) to the head outputs (B, L, d), local
// heads first (biom3_tpu/models/proteoscribe.py:115-117,184).
//
// Replaces the attention core of the TPU kernels
// biom3_tpu/ops/pallas/fused_layer_tpu.py:186 (fused_attn_half, :135-161)
// and stack_kernel_tpu.py:60/312 (_attn_core_t, _attn_global_t inside
// fused_stack_logits).
//
// Band-local heads, on the tensor cores (stage3_local_wgmma_kernel): a
// query of window w sees the keys of windows w-1..w+1 that exist under one
// joint f32 softmax, which equals the -1e9-masked form of
// biom3_tpu/ops/local_attention.py:26-31,78-80.  local_attn.cu's band sweep
// fed as dense_attn.cu is fed:
// * q, k and v are read in place from qkv through one 4-D TMA map (Dh, L,
//   3H, B) with qkv's strides: head h of q is slice h, of k H + h, of v
//   2H + h.  Boxes are (64, 64, 1, 1): rows past L and, for head dim 32,
//   columns 32..63 arrive as zeros;
// * one block per (128 queries, local head, batch row): two consumer
//   warpgroups of 64 queries and a producer warp.  The Q tile arrives once;
//   K and V tiles of 64 keys from the union of the block's rows' bands
//   stream through a 3-stage ring;
// * forward_sweep under WindowBand (attn_hopper.cuh): a key outside its
//   row's band scores −inf, so a warpgroup over two windows (W < 64) or a
//   tile across the band's edge stays exact;
// * the epilogue writes O / l as bf16 at column h·Dh of the output.
// Rounding: p̃ = exp(s − m_running) is rounded to bf16 for P·V and the f32
// sum divided by the f32 l; the plain version rounds the normalised p.
// Both round a weight once, so they differ at that one rounding.
//
// Linear heads, on CUDA cores with the sequence split across blocks:
// k' = softmax(k over the sequence) in f32, rounded to bf16; ctx = k'ᵀv
// summed in f32, rounded to bf16; q' = softmax(q over Dh)·Dh^-0.5 rounded
// to bf16; out = q'·ctx in f32 (stack_kernel_tpu.py:312-329).  Three steps
// depend on one another, so three launches with the band heads' one:
// 1. stage3_linear_stats_kernel, grid (ceil(L / srows), pairs): each block
//    takes srows sequence rows (64, 128 or 256) of one (batch row, linear
//    head) pair and writes each channel's max and Σexp(k − max) over them;
// 2. stage3_linear_ctx_kernel, grid (chunks, pairs): each block combines
//    the statistics in row order, forms k' of its chunk's rows and sums its
//    part of k'ᵀv in registers (4x4 entries a thread); the last block of a
//    pair to finish (an integer ticket after a fence, reset by that block)
//    adds the parts in chunk order and writes ctx.  No float atomics: the
//    same bits every call;
// 3. the output rows run as extra blocks of the band heads' grid: the
//    block of (128 rows, linear head, batch row) forms q' of its rows in
//    shared memory and multiplies by ctx (2 rows x 8 columns a thread).
// Both splits come from ops/kernels.py::stage3_linear_plan.
//
// What bounds it on an H100: the bytes.  The band heads read their q, k, v
// once a block, 12·W·Dh FLOP a query row on the tensor cores; the linear
// heads are 4·L·Dh² FLOP a head against 8·L·Dh bytes.  The whole function
// reads qkv once and writes the output once; k is read twice, the second
// time mostly from L2.
#include "attn_hopper.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------- band heads

constexpr int NWG = 2;                        // consumer warpgroups
constexpr int BQ = 64 * NWG;                  // queries (or linear rows) a block
constexpr int STAGES = 3;
constexpr int THREADS = NWG * 128 + 32;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // K, V
constexpr int SMEM = NWG * TILE_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;

// ---------------------------------------------------------------- linear heads

constexpr int LIN_THREADS = 256;
constexpr int LIN_TILE = 64;                  // sequence rows per shared tile of k', v
constexpr int MAX_PAIRS = 8192;               // pairs that may have more than one chunk
__device__ unsigned int s3_tickets[MAX_PAIRS];   // one a pair; each resets itself

__device__ __forceinline__ uint4 ld16(const bf16 *p) { return *reinterpret_cast<const uint4 *>(p); }

// The workspace (f32), sized the same way by ops/kernels.py::
// stage3_attention_core: per pair, room for the statistics of each 64
// rows [ceil(L / 64)][2][DH] (max, Σexp; srows-row chunks use the first
// ceil(L / srows)), ctx [DH][DH] (bf16-rounded values), and with chunks > 1
// the chunks' parts of ctx [chunks][DH][DH].
struct LinWs {
  float *stats, *ctx, *part;
  __host__ __device__ LinWs(float *ws, int pairs, int L, int dh)
      : stats(ws), ctx(ws + (size_t)pairs * ((L + LIN_TILE - 1) / LIN_TILE) * 2 * dh),
        part(ctx + (size_t)pairs * dh * dh) {}
};

// Block (c, p): sequence rows [c·srows, min(L, (c+1)·srows)) of pair p =
// b·ng + j (head local + j).  Thread (g, v) walks rows g, g + G, ... of the
// chunk, 8 channels v·8.. from one 16-byte load a row, U rows' loads in
// flight, with a running max and Σexp(k − max) per channel; then the G
// groups merge in a fixed order: by shuffles within a warp, then the
// warps in order.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS)
stage3_linear_stats_kernel(const bf16 *__restrict__ qkv, float *__restrict__ ws, int L, int d,
                           int local, int ng, int srows) {
  constexpr int VPR = DH / 8, G = LIN_THREADS / VPR, U = 4, WARPS = LIN_THREADS / 32;
  __shared__ float red_m[WARPS][DH], red_s[WARPS][DH];
  const int c = blockIdx.x, p = blockIdx.y, b = p / ng, h = local + p % ng;
  const int t = threadIdx.x, v = t % VPR, g = t / VPR;
  const int r1 = min(L, (c + 1) * srows);
  const bf16 *kp = qkv + (size_t)b * L * 3 * d + d + h * DH + v * 8;
  float m[8], s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m[e] = -INFINITY, s[e] = 0.f;
  for (int n0 = c * srows + g; n0 < r1; n0 += U * G) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (n0 + u * G < r1) raw[u] = ld16(kp + (size_t)(n0 + u * G) * 3 * d);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (n0 + u * G >= r1) break;
      float x[8];
      unpack8(raw[u], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (x[e] > m[e]) {
          s[e] = s[e] * __expf(m[e] - x[e]) + 1.f;   // 0 · exp(−inf) on the first row
          m[e] = x[e];
        } else {
          s[e] += __expf(x[e] - m[e]);
        }
      }
    }
  }
#pragma unroll
  for (int off = VPR; off < 32; off <<= 1)   // the warp's groups of the same channels
#pragma unroll
    for (int e = 0; e < 8; ++e)
      merge_stats(m[e], s[e], __shfl_xor_sync(0xffffffffu, m[e], off),
                  __shfl_xor_sync(0xffffffffu, s[e], off));
  if (t % 32 < VPR)
#pragma unroll
    for (int e = 0; e < 8; ++e) red_m[t / 32][v * 8 + e] = m[e], red_s[t / 32][v * 8 + e] = s[e];
  __syncthreads();
  if (t < DH) {
    float mx = red_m[0][t], sum = red_s[0][t];
    for (int i = 1; i < WARPS; ++i) merge_stats(mx, sum, red_m[i][t], red_s[i][t]);
    float *st = LinWs(ws, gridDim.y, L, DH).stats + ((size_t)p * gridDim.x + c) * 2 * DH;
    st[t] = mx;
    st[DH + t] = sum;
  }
}

// Block (c, p) as above.  Threads (rg, e): e = (ti, tj) owns ctx entries
// [4ti, 4ti + 4) x [4tj, 4tj + 4); row group rg of RG takes the tile's
// rows rg, rg + RG, ...; the RG groups' sums merge in rg order.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS)
stage3_linear_ctx_kernel(const bf16 *__restrict__ qkv, float *__restrict__ ws, int L, int d,
                         int local, int ng, int per, int chunks, int srows) {
  const int schunks = (L + srows - 1) / srows;   // the statistics' chunks
  constexpr int VPR = DH / 8, PAD = DH + 4, VPT = LIN_TILE * VPR / LIN_THREADS;
  constexpr int OWNERS = DH * DH / 16, RG = LIN_THREADS / OWNERS;
  constexpr int TILE_FLOATS = 2 * LIN_TILE * PAD, RED_FLOATS = RG * DH * DH;
  __shared__ __align__(16) float buf[TILE_FLOATS > RED_FLOATS ? TILE_FLOATS : RED_FLOATS];
  __shared__ float kmax[DH], kinv[DH];
  __shared__ bool last;
  float(*KF)[PAD] = reinterpret_cast<float(*)[PAD]>(buf);
  float(*VV)[PAD] = reinterpret_cast<float(*)[PAD]>(buf + LIN_TILE * PAD);

  const int c = blockIdx.x, p = blockIdx.y, b = p / ng, h = local + p % ng;
  const int t = threadIdx.x;
  const LinWs w(ws, gridDim.y, L, DH);
  const int r0 = c * per, r1 = min(L, r0 + per);
  const bf16 *base = qkv + (size_t)b * L * 3 * d + h * DH;

  if (t < DH) {   // the whole sequence's statistics, chunk by chunk in order
    const float *st = w.stats + (size_t)p * schunks * 2 * DH;
    float mx = -INFINITY, sum = 0.f;
    for (int i = 0; i < schunks; ++i) mx = fmaxf(mx, st[i * 2 * DH + t]);
    for (int i = 0; i < schunks; ++i)
      sum += st[i * 2 * DH + DH + t] * __expf(st[i * 2 * DH + t] - mx);
    kmax[t] = mx;
    kinv[t] = 1.f / sum;
  }
  const int rg = t / OWNERS, e = t % OWNERS;
  const int i0 = (e / (DH / 4)) * 4, j0 = (e % (DH / 4)) * 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;

  uint4 kr[VPT], vr[VPT];   // the next tile's k and v, in flight during this tile's products
  auto fetch = [&](int n0) {
    const int rows = min(LIN_TILE, r1 - n0);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int q = t + i * LIN_THREADS, r = q / VPR;
      if (r < rows) {
        const bf16 *row = base + (size_t)(n0 + r) * 3 * d + (q % VPR) * 8;
        kr[i] = ld16(row + d);
        vr[i] = ld16(row + 2 * d);
      }
    }
  };
  fetch(r0);
  for (int n0 = r0; n0 < r1; n0 += LIN_TILE) {
    const int rows = min(LIN_TILE, r1 - n0);
    __syncthreads();   // kmax/kinv written; the previous tile consumed
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int q = t + i * LIN_THREADS, r = q / VPR, col = (q % VPR) * 8;
      if (r >= rows) continue;
      float kx[8], vx[8];
      unpack8(kr[i], kx);
      unpack8(vr[i], vx);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        kx[e] = round_bf16(__expf(kx[e] - kmax[col + e]) * kinv[col + e]);
      float4 *kd = reinterpret_cast<float4 *>(&KF[r][col]);
      float4 *vd = reinterpret_cast<float4 *>(&VV[r][col]);
      kd[0] = make_float4(kx[0], kx[1], kx[2], kx[3]);
      kd[1] = make_float4(kx[4], kx[5], kx[6], kx[7]);
      vd[0] = make_float4(vx[0], vx[1], vx[2], vx[3]);
      vd[1] = make_float4(vx[4], vx[5], vx[6], vx[7]);
    }
    __syncthreads();
    if (n0 + LIN_TILE < r1) fetch(n0 + LIN_TILE);
    for (int r = rg; r < rows; r += RG) {
      const float4 ka = *reinterpret_cast<const float4 *>(&KF[r][i0]);
      const float4 va = *reinterpret_cast<const float4 *>(&VV[r][j0]);
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w}, vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(kv[a], vv[bb], acc[a][bb]);
    }
  }
  __syncthreads();
  if constexpr (RG > 1) {   // merge the row groups in order through shared memory
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4 *>(&buf[(rg * DH + i0 + a) * DH + j0]) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    __syncthreads();
    if (rg == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          float sum = acc[a][bb];
          for (int k = 1; k < RG; ++k) sum += buf[(k * DH + i0 + a) * DH + j0 + bb];
          acc[a][bb] = sum;
        }
  }
  float *ctx = w.ctx + (size_t)p * DH * DH;
  if (chunks == 1) {
    if (rg == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4 *>(&ctx[(i0 + a) * DH + j0]) =
            make_float4(round_bf16(acc[a][0]), round_bf16(acc[a][1]), round_bf16(acc[a][2]),
                        round_bf16(acc[a][3]));
    return;
  }
  float *part = w.part + (size_t)p * chunks * DH * DH;
  if (rg == 0)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4 *>(&part[((size_t)c * DH + i0 + a) * DH + j0]) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  __threadfence();
  __syncthreads();
  if (t == 0) {
    last = atomicAdd(&s3_tickets[p], 1u) == (unsigned)chunks - 1;
    if (last) s3_tickets[p] = 0;   // every chunk of the pair has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int q = t; q < DH * DH; q += LIN_THREADS) {
    float sum = 0.f;
    for (int i = 0; i < chunks; ++i) sum += __ldcg(&part[(size_t)i * DH * DH + q]);
    ctx[q] = round_bf16(sum);
  }
}

// The output rows [r0, r1) of linear head h of batch row b, BQ at a time,
// by a block of the band heads' grid (every thread of the block calls it).
// Two threads a row form q' = softmax(q)·Dh^-0.5, rounded to bf16, into
// shared memory transposed (QT[i][row]), the next tile's q loads already
// in flight; then thread (tr, tc) sums rows 2·tr, 2·tr + 1 (and, at Dh 64,
// those 64 rows on) times ctx's columns [8tc, 8tc + 8) over i in order,
// and stores each row's 8 as 16 bytes.
template <int DH>
__device__ __forceinline__ void linear_rows(uint8_t *smem, const bf16 *__restrict__ qkv,
                                            const float *__restrict__ ctx,
                                            bf16 *__restrict__ out, int b, int h, int r0, int r1,
                                            int L, int d) {
  constexpr int HALF = DH / 2, TC = DH / 8, TR = 256 / TC, RP = (BQ / 2) / TR;
  float *CT = reinterpret_cast<float *>(smem);   // [DH][DH]
  float *QT = CT + DH * DH;                      // [DH][BQ]
  const int t = threadIdx.x;
  for (int q = t; q < DH * DH / 4; q += THREADS)
    reinterpret_cast<float4 *>(CT)[q] = __ldcg(reinterpret_cast<const float4 *>(ctx) + q);
  const int r = t / 2, c0 = (t % 2) * HALF;      // the q' half-row of thread t < 2·BQ
  const int tc = t % TC, tr = t / TC;            // the output entries of thread t < 256
  uint4 raw[HALF / 8];
  auto fetch = [&](int q0) {
    if (t < 2 * BQ && q0 + r < L) {
      const bf16 *src = qkv + ((size_t)b * L + q0 + r) * 3 * d + h * DH + c0;
#pragma unroll
      for (int c = 0; c < HALF; c += 8) raw[c / 8] = ld16(src + c);
    }
  };
  fetch(r0);
  for (int q0 = r0; q0 < r1; q0 += BQ) {
    if (t < 2 * BQ) {
      float x[HALF];
#pragma unroll
      for (int c = 0; c < HALF; c += 8) {
        if (q0 + r < L) {
          unpack8(raw[c / 8], x + c);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[c + e] = 0.f;
        }
      }
      float mx = x[0];
#pragma unroll
      for (int c = 1; c < HALF; ++c) mx = fmaxf(mx, x[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        x[c] = __expf(x[c] - mx);
        sum += x[c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float qn = rsqrtf((float)DH) / sum;
#pragma unroll
      for (int c = 0; c < HALF; ++c) QT[(c0 + c) * BQ + r] = round_bf16(x[c] * qn);
    }
    __syncthreads();   // QT (and, the first time, CT) written
    if (q0 + BQ < r1) fetch(q0 + BQ);
    if (t < 256) {
      float acc[RP][2][8];
#pragma unroll
      for (int k = 0; k < RP; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[k][0][e] = acc[k][1][e] = 0.f;
#pragma unroll 4
      for (int i = 0; i < DH; ++i) {
        const float4 ca = *reinterpret_cast<const float4 *>(&CT[i * DH + 8 * tc]);
        const float4 cb = *reinterpret_cast<const float4 *>(&CT[i * DH + 8 * tc + 4]);
        const float cv[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int k = 0; k < RP; ++k) {
          const float2 qv = *reinterpret_cast<const float2 *>(&QT[i * BQ + 2 * (tr + k * TR)]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[k][0][e] = fmaf(qv.x, cv[e], acc[k][0][e]);
            acc[k][1][e] = fmaf(qv.y, cv[e], acc[k][1][e]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RP; ++k)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int row = q0 + 2 * (tr + k * TR) + r2;
          if (row < L)
            *reinterpret_cast<uint4 *>(out + ((size_t)b * L + row) * d + h * DH + 8 * tc) =
                pack8(acc[k][r2]);
        }
    }
    __syncthreads();   // QT read before the next tile writes it
  }
}

// Grid (ceil(L / BQ) · local + ceil(L / lrows) · (H − local), B): in each
// batch row first the band heads' blocks, 128 queries of one local head
// each; then the linear heads' output rows, lrows rows (a multiple of BQ)
// of one linear head a block (linear_rows).  Block x stands for block x +
// first of that grid: first = ceil(L / BQ) · local runs the linear heads'
// blocks alone.
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
stage3_local_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          const bf16 *__restrict__ qkv, const float *__restrict__ ctx,
                          bf16 *__restrict__ out, int H, int L, int d, int local, int window,
                          int lrows, int first, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int qtiles = (L + BQ - 1) / BQ, b = blockIdx.y, bx = blockIdx.x + first;
  if (bx >= qtiles * local) {
    const int j = bx - qtiles * local, ltiles = (L + lrows - 1) / lrows;
    const int ng = H - local, head = local + j / ltiles, r0 = (j % ltiles) * lrows;
    linear_rows<DH>(smem, qkv, ctx + ((size_t)b * ng + head - local) * DH * DH, out, b, head, r0,
                    min(L, r0 + lrows), L, d);
    return;
  }
  const int q0 = (bx % qtiles) * BQ, head = bx / qtiles;
  uint8_t *sq = smem, *ring = smem + NWG * TILE_BYTES;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * STAGE_BYTES);
  uint64_t *empty = full + STAGES, *qbar = empty + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the union of the block's valid rows' bands, clipped to [0, L)
  const int k_lo = max(0, (q0 / window - 1) * window);
  const int k_hi = min(L, ((min(q0 + BQ, L) - 1) / window + 2) * window);
  const int tiles = (k_hi - k_lo + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrive per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, NWG * TILE_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
        hopper::tma_load_4d(sq + w * TILE_BYTES, &map_qkv, qbar, 0, q0 + w * TILE, head, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        uint8_t *st = ring + s * STAGE_BYTES;
        hopper::tma_load_4d(st, &map_qkv, &full[s], 0, k_lo + t * TILE, H + head, b);
        hopper::tma_load_4d(st + TILE_BYTES, &map_qkv, &full[s], 0, k_lo + t * TILE,
                            2 * H + head, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const WindowBand band(q0 + wg * TILE, window, L, warp, lane);
  float o[32], l[2];
  mbar_wait(qbar, 0);
  forward_sweep<STAGES, true>(sq + wg * TILE_BYTES, ring, STAGE_BYTES, full, empty, k_lo, tiles,
                              band, nullptr, L, scale, lane, o, l);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + wg * TILE + acc_row(hh, warp, lane);
    if (row >= L) continue;
    const float inv = 1.f / l[hh];
    bf16 *dst = out + ((size_t)b * L + row) * d + head * DH;
#pragma unroll
    for (int q = 0; q < DH / 8; ++q)
      *reinterpret_cast<__nv_bfloat162 *>(dst + acc_col(q, 0, lane)) =
          __floats2bfloat162_rn(o[4 * q + 2 * hh] * inv, o[4 * q + 2 * hh + 1] * inv);
  }
}

template <int DH>
int launch(const bf16 *qkv, bf16 *out, float *ws, int B, int L, int d, int heads, int local,
           int window, int chunks, int per, int srows, int lrows, bool band,
           cudaStream_t stream) {
  const int ng = heads - local;
  if (!band && ng == 0) return static_cast<int>(cudaSuccess);
  if (ng > 0) {
    const int pairs = B * ng;
    if (chunks < 1 || per < 1 || (chunks - 1) * per >= L || (long long)chunks * per < L ||
        (chunks > 1 && pairs > MAX_PAIRS) || srows < LIN_TILE || srows % LIN_TILE ||
        lrows < BQ || lrows % BQ)
      return static_cast<int>(cudaErrorInvalidValue);
    stage3_linear_stats_kernel<DH><<<dim3((L + srows - 1) / srows, pairs), LIN_THREADS, 0,
                                     stream>>>(qkv, ws, L, d, local, ng, srows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stage3_linear_ctx_kernel<DH><<<dim3(chunks, pairs), LIN_THREADS, 0, stream>>>(
        qkv, ws, L, d, local, ng, per, chunks, srows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // (Dh, L, 3H, B) with qkv's strides, (64, TILE, 1, 1) boxes
  const uint64_t dims[4] = {(uint64_t)DH, (uint64_t)L, (uint64_t)3 * heads, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)d * 6, (uint64_t)DH * 2, (uint64_t)L * d * 6};
  const uint32_t box[4] = {64, TILE, 1, 1};
  CUtensorMap map;
  int err = hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, 4, dims, strides,
                                 box);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(stage3_local_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err) return err;
    sized = true;
  }
  const float *ctx = ng > 0 ? LinWs(ws, B * ng, L, DH).ctx : nullptr;
  const int band_blocks = (L + BQ - 1) / BQ * local;
  const dim3 grid((band ? band_blocks : 0) + (ng > 0 ? (L + lrows - 1) / lrows * ng : 0), B);
  stage3_local_wgmma_kernel<DH><<<grid, THREADS, SMEM, stream>>>(
      map, qkv, ctx, out, heads, L, d, local, window, lrows, band ? 0 : band_blocks,
      1.f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static int dispatch(const void *qkv, void *out, void *ws, int B, int L, int d, int heads,
                    int local_heads, int window, int chunks, int per, int srows, int lrows,
                    bool band, void *stream) {
  const bf16 *q = static_cast<const bf16 *>(qkv);
  bf16 *o = static_cast<bf16 *>(out);
  float *w = static_cast<float *>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads < 1 || local_heads < 0 || local_heads > heads || d % heads ||
      (local_heads > 0 && (window < 1 || L % window)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d / heads) {
    case 32:
      return launch<32>(q, o, w, B, L, d, heads, local_heads, window, chunks, per, srows, lrows,
                        band, s);
    case 64:
      return launch<64>(q, o, w, B, L, d, heads, local_heads, window, chunks, per, srows, lrows,
                        band, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// qkv: (B, L, 3d) bf16 [q | k | v]; out: (B, L, d) bf16; both 16-byte
// aligned.  Head dim d / heads 32 or 64; L % window == 0 when local > 0.
// With linear heads: ws f32 scratch of the wrapper's size (LinWs), ctx
// summed over `chunks` chunks of `per` rows (the last may be shorter, none
// empty), the statistics over chunks of `srows` rows (a multiple of 64),
// the output rows `lrows` (a multiple of 128) a block.  Launches: 1 with
// local == heads, else 3.
B3_EXPORT int b3_stage3_attention_core(const void *qkv, void *out, void *ws, int B, int L, int d,
                                       int heads, int local_heads, int window, int chunks,
                                       int per, int srows, int lrows, void *stream) {
  return dispatch(qkv, out, ws, B, L, d, heads, local_heads, window, chunks, per, srows, lrows,
                  true, stream);
}

// The linear heads alone (heads local_heads..heads-1), as above: the band
// heads' columns of out are left as they are (stage3_attn_i8.cu writes
// them).  Launches: 0 with local_heads == heads, else 3.
B3_EXPORT int b3_stage3_attention_linear(const void *qkv, void *out, void *ws, int B, int L,
                                         int d, int heads, int local_heads, int window,
                                         int chunks, int per, int srows, int lrows,
                                         void *stream) {
  return dispatch(qkv, out, ws, B, L, d, heads, local_heads, window, chunks, per, srows, lrows,
                  false, stream);
}
