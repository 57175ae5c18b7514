// The linear heads of one ProteoScribe layer's attention, on CUDA cores with
// the sequence split across blocks, shared by stage3_attention_core
// (stage3_attn.cu) and stage3_attention_core_i8 (stage3_attn_i8.cu), whose
// band kernels run the output rows as extra blocks of their grids.
//
// k' = softmax(k over the sequence) in f32, rounded to bf16; ctx = k'ᵀv
// summed in f32, rounded to bf16; q' = softmax(q over Dh)·Dh^-0.5 rounded
// to bf16; out = q'·ctx in f32 (stack_kernel_tpu.py:312-329).  Three steps
// depend on one another, so three launches:
// 1. stage3_linear_stats_kernel, grid (ceil(L / srows), pairs): each block
//    takes srows sequence rows (64, 128 or 256) of one (batch row, linear
//    head) pair and writes each channel's max and Σexp(k − max) over them;
// 2. stage3_linear_ctx_kernel, grid (chunks, pairs): each block combines
//    the statistics in row order, forms k' of its chunk's rows and sums its
//    part of k'ᵀv in registers (4x4 entries a thread); the last block of a
//    pair to finish (an integer ticket after a fence, reset by that block)
//    adds the parts in chunk order and writes ctx.  No float atomics: the
//    same bits every call;
// 3. linear_rows, in blocks of the caller's band kernel: the block of
//    (lrows rows, linear head, batch row) forms q' of 128 rows at a time in
//    shared memory and multiplies by ctx (2 rows x 8 columns a thread).
// The splits come from ops/kernels.py::stage3_linear_plan.  Each source that
// includes this header gets its own copy of the kernels and the tickets.
#pragma once

#include "common.cuh"

namespace {

constexpr int LIN_THREADS = 256;
constexpr int LIN_BQ = 128;                   // output rows a tile of linear_rows
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

// The output rows [r0, r1) of linear head h of batch row b, LIN_BQ at a time,
// by a block of the band heads' grid (every thread of the block calls it).
// Two threads a row form q' = softmax(q)·Dh^-0.5, rounded to bf16, into
// shared memory transposed (QT[i][row]), the next tile's q loads already
// in flight; then thread (tr, tc) sums rows 2·tr, 2·tr + 1 (and, at Dh 64,
// those 64 rows on) times ctx's columns [8tc, 8tc + 8) over i in order,
// and stores each row's 8 as 16 bytes.
template <int DH, int NT>
__device__ __forceinline__ void linear_rows(uint8_t *smem, const bf16 *__restrict__ qkv,
                                            const float *__restrict__ ctx,
                                            bf16 *__restrict__ out, int b, int h, int r0, int r1,
                                            int L, int d) {
  constexpr int HALF = DH / 2, TC = DH / 8, TR = 256 / TC, RP = (LIN_BQ / 2) / TR;
  float *CT = reinterpret_cast<float *>(smem);   // [DH][DH]
  float *QT = CT + DH * DH;                      // [DH][LIN_BQ]
  const int t = threadIdx.x;
  for (int q = t; q < DH * DH / 4; q += NT)
    reinterpret_cast<float4 *>(CT)[q] = __ldcg(reinterpret_cast<const float4 *>(ctx) + q);
  const int r = t / 2, c0 = (t % 2) * HALF;      // the q' half-row of thread t < 2·LIN_BQ
  const int tc = t % TC, tr = t / TC;            // the output entries of thread t < 256
  uint4 raw[HALF / 8];
  auto fetch = [&](int q0) {
    if (t < 2 * LIN_BQ && q0 + r < L) {
      const bf16 *src = qkv + ((size_t)b * L + q0 + r) * 3 * d + h * DH + c0;
#pragma unroll
      for (int c = 0; c < HALF; c += 8) raw[c / 8] = ld16(src + c);
    }
  };
  fetch(r0);
  for (int q0 = r0; q0 < r1; q0 += LIN_BQ) {
    if (t < 2 * LIN_BQ) {
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
      for (int c = 0; c < HALF; ++c) QT[(c0 + c) * LIN_BQ + r] = round_bf16(x[c] * qn);
    }
    __syncthreads();   // QT (and, the first time, CT) written
    if (q0 + LIN_BQ < r1) fetch(q0 + LIN_BQ);
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
          const float2 qv = *reinterpret_cast<const float2 *>(&QT[i * LIN_BQ + 2 * (tr + k * TR)]);
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

// Launches 1 and 2 for the linear heads local..heads-1 (none if local ==
// heads), after checking the splits the caller's launch 3 uses too.
template <int DH>
int launch_linear_ctx(const bf16 *qkv, float *ws, int B, int L, int d, int heads, int local,
                      int chunks, int per, int srows, int lrows, cudaStream_t stream) {
  const int ng = heads - local, pairs = B * ng;
  if (ng == 0) return static_cast<int>(cudaSuccess);
  if (chunks < 1 || per < 1 || (chunks - 1) * per >= L || (long long)chunks * per < L ||
      (chunks > 1 && pairs > MAX_PAIRS) || srows < LIN_TILE || srows % LIN_TILE ||
      lrows < LIN_BQ || lrows % LIN_BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  stage3_linear_stats_kernel<DH><<<dim3((L + srows - 1) / srows, pairs), LIN_THREADS, 0,
                                   stream>>>(qkv, ws, L, d, local, ng, srows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stage3_linear_ctx_kernel<DH><<<dim3(chunks, pairs), LIN_THREADS, 0, stream>>>(
      qkv, ws, L, d, local, ng, per, chunks, srows);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory linear_rows<DH, ...> takes: ctx and a tile of q'ᵀ in f32.
constexpr int linear_rows_smem(int dh) { return (dh * dh + dh * LIN_BQ) * 4; }

}  // namespace
