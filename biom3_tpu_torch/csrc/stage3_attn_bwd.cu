// stage3_attention_bwd: the gradient of stage3_attention_core (stage3_attn.cu)
// with respect to its fused [q | k | v] input: (qkv, dattn) → dqkv, all
// (B, L, ·) bf16, local heads first.  Every softmax is recomputed from qkv.
//
// Replaces the attention backward of the TPU kernels
// biom3_tpu/ops/pallas/layer_block_tpu.py:419 (_bwd_call, :268-354) and
// attn_block_tpu.py:379 (_bwd_call, :214-310).  The TPU keeps dq/dk/dv in
// f32 and rounds them to bf16 just before the projection products
// (layer_block_tpu.py:357-358); here they leave the kernel as bf16, the
// same rounding point.
//
// * Band-local heads.  A query of window w sees the keys of windows
//   w-1..w+1 under one joint f32 softmax (keys out of range are skipped,
//   which equals the -1e9 mask).  With p = softmax(s), s = q·kᵀ·Dh^-0.5:
//     dV += pᵀ·dA (p rounded to bf16), dP = dA·Vᵀ,
//     dS = bf16(p∘(dP − Σ_j dP∘p)·Dh^-0.5), dQ = dS·K, dK += dSᵀ·Q.
//   A key window receives dK/dV from three query windows; the TPU adds them
//   into one f32 strip in its sequential window loop.  Blocks run in
//   parallel here, so the work is split the FlashAttention-2 way and
//   nothing is shared between blocks: pass 1 is query-owned (one block per
//   query tile) — an online pass gives each row's max, sum and
//   D = Σ_j dP∘p, a second pass over the band gives dQ — and saves
//   (logsumexp, D) per row; pass 2 is key-owned (one block per key tile)
//   and loops over the query rows of its three windows, recomputing p and
//   dS from the saved statistics, so each dK/dV row is summed by one
//   thread group in a fixed order.  No atomics: deterministic.  Four
//   threads share a row (each every fourth key or query) and merge by
//   shuffles, as the forward does.
// * Linear heads.  q' = softmax(q over Dh)·Dh^-0.5, k' = softmax(k over L),
//   ctx = k'ᵀv; the backward needs ctx and dctx = q'ᵀ·dA (Dh x Dh), and
//   the k' softmax backward needs Σ_n dk'∘k' over the whole sequence.
//   The forward runs one block per (row, head) — 16 blocks at B=2, and it
//   spills.  Here L is split into chunks of rows, one block per (chunk,
//   head, row), in three passes with the cross-chunk sums in between:
//   (1) k's column max/sum and the dctx partial; (2) k' and its softmax,
//   the ctx partial, dv = dctx·k' rows, and the Σ dk'∘k' partial; (3) dq
//   through ctx and the q' softmax backward, and dk.  Each block adds the
//   (few) chunk partials it needs itself, in chunk order.  The bf16
//   rounding points of the TPU kernel are kept: q', k', ctx, dctx, dS and
//   bf16(p) are rounded where it rounds them.
//
// What bounds it on an H100: at Stage-3 shapes the band-local part does
// 10·Dh FLOP per (query, key) pair over 3W keys on CUDA cores and reads
// its K/V (Q/dA) band from shared memory tiles, so it is bound by the
// CUDA-core FLOP rate; the linear heads are O(L·Dh²) and small.  The
// forward's band runs on tensor-core tiles (stage3_attn.cu); the
// backward's are later work.
#include "attn_common.cuh"

namespace {

constexpr int S = b3::S;   // threads per row
constexpr int TQ = 64;     // rows per block of the band-local passes (cap)
constexpr int TS = 64;     // streamed rows per shared-memory tile

template <int DH>
__device__ __forceinline__ void load_row(const bf16 *p, float *v) {
#pragma unroll
  for (int c = 0; c < DH; c += 8) unpack8(*reinterpret_cast<const uint4 *>(p + c), v + c);
}

template <int DH>
__device__ __forceinline__ float dot_smem(const float *a, const bf16 *row) {
  float s = 0.f, v[8];
#pragma unroll
  for (int c = 0; c < DH; c += 8) {
    unpack8(*reinterpret_cast<const uint4 *>(row + c), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(a[c + e], v[e], s);
  }
  return s;
}

// Sum a per-thread vector over the S threads of a row; thread `sub` then
// writes channels [sub·DH/S, (sub+1)·DH/S) of it as bf16 to dst.
template <int DH>
__device__ __forceinline__ void merge_store(float *acc, int sub, bf16 *dst) {
#pragma unroll
  for (int off = 1; off < S; off <<= 1)
#pragma unroll
    for (int c = 0; c < DH; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  constexpr int PER = DH / S;
  float o[PER];
#pragma unroll
  for (int c = 0; c < DH; ++c)
    if (c / PER == sub) o[c % PER] = acc[c];  // static indexing: acc stays in registers
#pragma unroll
  for (int c = 0; c < PER; c += 8)
    *reinterpret_cast<uint4 *>(dst + sub * PER + c) = pack8(o + c);
}

// Pass 1 (query-owned): rows [q0, q0 + tq) of local head h, batch row b.
// stats[(b·nl + h)·L + i] = (logsumexp, D) of row i.
template <int DH>
__global__ void __launch_bounds__(TQ * S)
local_dq_kernel(const bf16 *__restrict__ qkv, const bf16 *__restrict__ dattn,
                bf16 *__restrict__ dqkv, float2 *__restrict__ stats, int L, int d, int window,
                int tq, int nl, float scale) {
  __shared__ __align__(16) bf16 Ks[TS][DH + 8];
  __shared__ __align__(16) bf16 Vs[TS][DH + 8];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * tq;
  const int w = q0 / window;
  const int lo = max(0, (w - 1) * window), hi = min(L, (w + 2) * window);
  const int t = threadIdx.x, sub = t % S, qi = q0 + t / S;  // tq | window | L: all rows live
  const size_t rs = 3 * (size_t)d;
  const bf16 *base = qkv + (size_t)b * L * rs;
  const bf16 *kb = base + d + h * DH, *vb = base + 2 * d + h * DH;

  float q[DH], da[DH];
  load_row<DH>(base + qi * rs + h * DH, q);
  load_row<DH>(dattn + ((size_t)b * L + qi) * d + h * DH, da);

  auto stage = [&](int k0, int n) {
    __syncthreads();
    for (int v = t; v < n * (DH / 8); v += blockDim.x) {
      const int r = v / (DH / 8), c = (v % (DH / 8)) * 8;
      *reinterpret_cast<uint4 *>(&Ks[r][c]) =
          *reinterpret_cast<const uint4 *>(kb + (size_t)(k0 + r) * rs + c);
      *reinterpret_cast<uint4 *>(&Vs[r][c]) =
          *reinterpret_cast<const uint4 *>(vb + (size_t)(k0 + r) * rs + c);
    }
    __syncthreads();
  };

  // online max m, sum l and dn = Σ_j exp(s_j − m)·dP_j
  float m = -INFINITY, l = 0.f, dn = 0.f;
  for (int k0 = lo; k0 < hi; k0 += TS) {
    const int n = min(TS, hi - k0);
    stage(k0, n);
    for (int j = sub; j < n; j += S) {
      const float s = dot_smem<DH>(q, Ks[j]) * scale;
      const float dp = dot_smem<DH>(da, Vs[j]);
      if (s > m) {
        const float corr = __expf(m - s);  // 0 on the first key
        l *= corr;
        dn *= corr;
        m = s;
      }
      const float p = __expf(s - m);
      l += p;
      dn = fmaf(p, dp, dn);
    }
  }
#pragma unroll
  for (int off = 1; off < S; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo_ = __shfl_xor_sync(0xffffffffu, l, off);
    const float dno = __shfl_xor_sync(0xffffffffu, dn, off);
    const float mn = fmaxf(m, mo);
    const float wa = (m == -INFINITY) ? 0.f : __expf(m - mn);
    const float wb = (mo == -INFINITY) ? 0.f : __expf(mo - mn);
    l = l * wa + lo_ * wb;
    dn = dn * wa + dno * wb;
    m = mn;
  }
  const float D = dn / l, lse = m + __logf(l);

  float dq[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) dq[c] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += TS) {
    const int n = min(TS, hi - k0);
    stage(k0, n);
    for (int j = sub; j < n; j += S) {
      const float p = __expf(dot_smem<DH>(q, Ks[j]) * scale - lse);
      const float ds = round_bf16(p * (dot_smem<DH>(da, Vs[j]) - D) * scale);
      float kv[8];
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        unpack8(*reinterpret_cast<const uint4 *>(&Ks[j][c]), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) dq[c + e] = fmaf(ds, kv[e], dq[c + e]);
      }
    }
  }
  merge_store<DH>(dq, sub, dqkv + ((size_t)b * L + qi) * rs + h * DH);
  if (sub == 0) stats[((size_t)b * nl + h) * L + qi] = make_float2(lse, D);
}

// Pass 2 (key-owned): key rows [k0, k0 + tk) of local head h, batch row b;
// loops over the query rows of windows w-1..w+1.
template <int DH>
__global__ void __launch_bounds__(TQ * S)
local_dkv_kernel(const bf16 *__restrict__ qkv, const bf16 *__restrict__ dattn,
                 const float2 *__restrict__ stats, bf16 *__restrict__ dqkv, int L, int d,
                 int window, int tk, int nl, float scale) {
  __shared__ __align__(16) bf16 Qs[TS][DH + 8];
  __shared__ __align__(16) bf16 As[TS][DH + 8];
  __shared__ float2 St[TS];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * tk;
  const int w = k0 / window;
  const int lo = max(0, (w - 1) * window), hi = min(L, (w + 2) * window);
  const int t = threadIdx.x, sub = t % S, kj = k0 + t / S;
  const size_t rs = 3 * (size_t)d;
  const bf16 *base = qkv + (size_t)b * L * rs;
  const bf16 *qb = base + h * DH, *ab = dattn + (size_t)b * L * d + h * DH;
  const float2 *sb = stats + ((size_t)b * nl + h) * L;

  float k[DH], v[DH], dk[DH], dv[DH];
  load_row<DH>(base + kj * rs + d + h * DH, k);
  load_row<DH>(base + kj * rs + 2 * d + h * DH, v);
#pragma unroll
  for (int c = 0; c < DH; ++c) dk[c] = dv[c] = 0.f;

  for (int i0 = lo; i0 < hi; i0 += TS) {
    const int n = min(TS, hi - i0);
    __syncthreads();
    for (int e = t; e < n * (DH / 8); e += blockDim.x) {
      const int r = e / (DH / 8), c = (e % (DH / 8)) * 8;
      *reinterpret_cast<uint4 *>(&Qs[r][c]) =
          *reinterpret_cast<const uint4 *>(qb + (size_t)(i0 + r) * rs + c);
      *reinterpret_cast<uint4 *>(&As[r][c]) =
          *reinterpret_cast<const uint4 *>(ab + (size_t)(i0 + r) * d + c);
    }
    for (int r = t; r < n; r += blockDim.x) St[r] = sb[i0 + r];
    __syncthreads();
    for (int i = sub; i < n; i += S) {
      const float p = __expf(dot_smem<DH>(k, Qs[i]) * scale - St[i].x);
      const float ds = round_bf16(p * (dot_smem<DH>(v, As[i]) - St[i].y) * scale);
      const float pb = round_bf16(p);
      float x[8];
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        unpack8(*reinterpret_cast<const uint4 *>(&Qs[i][c]), x);
#pragma unroll
        for (int e = 0; e < 8; ++e) dk[c + e] = fmaf(ds, x[e], dk[c + e]);
        unpack8(*reinterpret_cast<const uint4 *>(&As[i][c]), x);
#pragma unroll
        for (int e = 0; e < 8; ++e) dv[c + e] = fmaf(pb, x[e], dv[c + e]);
      }
    }
  }
  bf16 *out = dqkv + ((size_t)b * L + kj) * rs + h * DH;
  merge_store<DH>(dk, sub, out + d);
  merge_store<DH>(dv, sub, out + 2 * d);
}

// ---- linear heads ---------------------------------------------------------

constexpr int LIN_THREADS = 256;

// Rows per shared sub-tile, and threads per row where a row's softmax over
// Dh is reduced by shuffles: 32 x 8 at Dh 32, 16 x 16 at Dh 64 (the Dh 64
// sub-tiles are halved to keep pass 3 under 48 KB of shared memory).
template <int DH>
struct Tile {
  static constexpr int SUB = DH == 64 ? 16 : 32;
  static constexpr int TPR = LIN_THREADS / SUB;
  static constexpr int NI = DH / TPR;  // features per thread of a row
};

struct Lin {
  const bf16 *qkv, *dattn;
  bf16 *dqkv;
  float *kst;    // (B, ng, C, 2, DH): k column max, Σ exp(k − max) per chunk
  float *dctx;   // (B, ng, C, DH, DH) partials of q'ᵀ·dA
  float *ctx;    // (B, ng, C, DH, DH) partials of k'ᵀ·v
  float *g;      // (B, ng, C, DH) partials of Σ_n dk'∘softmax(k)
  int L, d, nl, chunk, C;
  float scale;
};

// Global column max and 1/sum of k over L from the chunk partials.
template <int DH>
__device__ void k_stats(const Lin &a, const float *kst, float *kM, float *kI) {
  const int t = threadIdx.x;
  if (t < DH) {
    float M = -INFINITY;
    for (int c = 0; c < a.C; ++c) M = fmaxf(M, kst[(c * 2) * DH + t]);
    float s = 0.f;
    for (int c = 0; c < a.C; ++c) s += kst[(c * 2 + 1) * DH + t] * __expf(kst[(c * 2) * DH + t] - M);
    kM[t] = M;
    kI[t] = 1.f / s;
  }
}

// dst[i][j] = bf16(Σ_c part[c][i][j]) (row stride DH + 1)
template <int DH>
__device__ void sum_parts(const float *part, int C, float *dst) {
  for (int e = threadIdx.x; e < DH * DH; e += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += part[(size_t)c * DH * DH + e];
    dst[(e / DH) * (DH + 1) + e % DH] = round_bf16(s);
  }
}

// Max and sum over the TPR threads of a row (consecutive lanes).
template <int TPR>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: per (chunk, head, row): k column statistics and the dctx partial.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS) lin_bwd1(Lin a) {
  constexpr int GROUPS = LIN_THREADS / DH, PER = DH * DH / LIN_THREADS;
  using T = Tile<DH>;
  __shared__ float red[GROUPS][DH];
  __shared__ float cm[DH];
  __shared__ float QF[T::SUB][DH + 1], DA[T::SUB][DH + 1];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, h = a.nl + hh;
  const int ng = gridDim.y, t = threadIdx.x;
  const int n0 = c * a.chunk, n1 = min(a.L, n0 + a.chunk);
  const size_t rs = 3 * (size_t)a.d;
  const bf16 *base = a.qkv + (size_t)b * a.L * rs;
  const size_t part = ((size_t)b * ng + hh) * a.C + c;

  // k column max and Σ exp(k − max) over the chunk
  const int ch = t % DH, grp = t / DH;
  const bf16 *kc = base + a.d + h * DH + ch;
  float mx = -INFINITY;
  for (int n = n0 + grp; n < n1; n += GROUPS) mx = fmaxf(mx, __bfloat162float(kc[n * rs]));
  red[grp][ch] = mx;
  __syncthreads();
  if (t < DH) {
    float v = red[0][t];
    for (int g = 1; g < GROUPS; ++g) v = fmaxf(v, red[g][t]);
    cm[t] = v;
  }
  __syncthreads();
  float sm = 0.f;
  for (int n = n0 + grp; n < n1; n += GROUPS) sm += __expf(__bfloat162float(kc[n * rs]) - cm[ch]);
  __syncthreads();
  red[grp][ch] = sm;
  __syncthreads();
  if (t < DH) {
    float v = 0.f;
    for (int g = 0; g < GROUPS; ++g) v += red[g][t];
    a.kst[(part * 2) * DH + t] = cm[t];
    a.kst[(part * 2 + 1) * DH + t] = v;
  }

  // dctx[i][j] partial = Σ_n q'[n][i]·dA[n][j]
  float acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) acc[p] = 0.f;
  const int r = t / T::TPR, lane = t % T::TPR;
  for (int s0 = n0; s0 < n1; s0 += T::SUB) {
    const int rows = min(T::SUB, n1 - s0);
    const int rr = min(r, rows - 1);  // idle rows recompute the last: shuffles stay uniform
    const bf16 *qp = base + (size_t)(s0 + rr) * rs + h * DH;
    const bf16 *dp = a.dattn + ((size_t)b * a.L + s0 + rr) * a.d + h * DH;
    __syncthreads();
    float qm = -INFINITY;
#pragma unroll
    for (int u = 0; u < T::NI; ++u) qm = fmaxf(qm, __bfloat162float(qp[lane + u * T::TPR]));
    qm = row_max<T::TPR>(qm);
    float qs = 0.f;
#pragma unroll
    for (int u = 0; u < T::NI; ++u) qs += __expf(__bfloat162float(qp[lane + u * T::TPR]) - qm);
    qs = row_sum<T::TPR>(qs);
    if (r < rows)
#pragma unroll
      for (int u = 0; u < T::NI; ++u) {
        const int i = lane + u * T::TPR;
        QF[r][i] = round_bf16(__expf(__bfloat162float(qp[i]) - qm) / qs * a.scale);
        DA[r][i] = __bfloat162float(dp[i]);
      }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int id = t + p * LIN_THREADS, i = id / DH, j = id % DH;
      float s = acc[p];
      for (int x = 0; x < rows; ++x) s = fmaf(QF[x][i], DA[x][j], s);
      acc[p] = s;
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) a.dctx[part * DH * DH + t + p * LIN_THREADS] = acc[p];
}

// Pass 2: k', the ctx partial, dv rows and the Σ dk'∘softmax(k) partial.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS) lin_bwd2(Lin a) {
  constexpr int PER = DH * DH / LIN_THREADS, GROUPS = LIN_THREADS / DH;
  using T = Tile<DH>;
  __shared__ float kM[DH], kI[DH];
  __shared__ float DC[DH][DH + 1];
  __shared__ float KF[T::SUB][DH + 1], VV[T::SUB][DH + 1], SK[T::SUB][DH + 1];
  __shared__ float red[GROUPS][DH];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, h = a.nl + hh;
  const int ng = gridDim.y, t = threadIdx.x;
  const int n0 = c * a.chunk, n1 = min(a.L, n0 + a.chunk);
  const size_t rs = 3 * (size_t)a.d;
  const bf16 *base = a.qkv + (size_t)b * a.L * rs;
  const size_t head = (size_t)b * ng + hh, part = head * a.C + c;

  k_stats<DH>(a, a.kst + head * a.C * 2 * DH, kM, kI);
  sum_parts<DH>(a.dctx + head * a.C * DH * DH, a.C, &DC[0][0]);

  float acc[PER], gacc = 0.f;
#pragma unroll
  for (int p = 0; p < PER; ++p) acc[p] = 0.f;
  for (int s0 = n0; s0 < n1; s0 += T::SUB) {
    const int rows = min(T::SUB, n1 - s0);
    __syncthreads();
    for (int e = t; e < rows * DH; e += LIN_THREADS) {
      const int r = e / DH, i = e % DH;
      const bf16 *row = base + (size_t)(s0 + r) * rs;
      const float sk = __expf(__bfloat162float(row[a.d + h * DH + i]) - kM[i]) * kI[i];
      SK[r][i] = sk;
      KF[r][i] = round_bf16(sk);
      VV[r][i] = __bfloat162float(row[2 * a.d + h * DH + i]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int id = t + p * LIN_THREADS, i = id / DH, j = id % DH;
      float s = acc[p];
      for (int x = 0; x < rows; ++x) s = fmaf(KF[x][i], VV[x][j], s);
      acc[p] = s;
    }
    // dv[n][j] = Σ_i dctx[i][j]·k'[n][i];  dk'[n][i] = Σ_j dctx[i][j]·v[n][j]
    for (int e = t; e < rows * DH; e += LIN_THREADS) {
      const int r = e / DH, x = e % DH;
      float dv = 0.f, dkf = 0.f;
#pragma unroll 8
      for (int y = 0; y < DH; ++y) {
        dv = fmaf(DC[y][x], KF[r][y], dv);
        dkf = fmaf(DC[x][y], VV[r][y], dkf);
      }
      a.dqkv[((size_t)b * a.L + s0 + r) * rs + 2 * a.d + h * DH + x] = __float2bfloat16(dv);
      gacc = fmaf(dkf, SK[r][x], gacc);  // x = t % DH for every e of this thread
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) a.ctx[part * DH * DH + t + p * LIN_THREADS] = acc[p];
  __syncthreads();
  red[t / DH][t % DH] = gacc;
  __syncthreads();
  if (t < DH) {
    float s = 0.f;
    for (int g = 0; g < GROUPS; ++g) s += red[g][t];
    a.g[part * DH + t] = s;
  }
}

// Pass 3: dq through ctx and the q' softmax backward; dk through the k'
// softmax backward.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS) lin_bwd3(Lin a) {
  using T = Tile<DH>;
  __shared__ float kM[DH], kI[DH], G[DH];
  __shared__ float CT[DH][DH + 1], DC[DH][DH + 1];
  __shared__ float QQ[T::SUB][DH + 1], DA[T::SUB][DH + 1], VV[T::SUB][DH + 1];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, h = a.nl + hh;
  const int ng = gridDim.y, t = threadIdx.x;
  const int n0 = c * a.chunk, n1 = min(a.L, n0 + a.chunk);
  const size_t rs = 3 * (size_t)a.d;
  const bf16 *base = a.qkv + (size_t)b * a.L * rs;
  const size_t head = (size_t)b * ng + hh;

  k_stats<DH>(a, a.kst + head * a.C * 2 * DH, kM, kI);
  sum_parts<DH>(a.ctx + head * a.C * DH * DH, a.C, &CT[0][0]);
  sum_parts<DH>(a.dctx + head * a.C * DH * DH, a.C, &DC[0][0]);
  if (t < DH) {
    float s = 0.f;
    for (int cc = 0; cc < a.C; ++cc) s += a.g[(head * a.C + cc) * DH + t];
    G[t] = s;
  }
  const int r = t / T::TPR, lane = t % T::TPR;
  for (int s0 = n0; s0 < n1; s0 += T::SUB) {
    const int rows = min(T::SUB, n1 - s0);
    __syncthreads();
    for (int e = t; e < rows * DH; e += LIN_THREADS) {
      const int x = e / DH, i = e % DH;
      const bf16 *row = base + (size_t)(s0 + x) * rs + h * DH;
      QQ[x][i] = __bfloat162float(row[i]);
      VV[x][i] = __bfloat162float(row[2 * a.d + i]);
      DA[x][i] = __bfloat162float(a.dattn[((size_t)b * a.L + s0 + x) * a.d + h * DH + i]);
    }
    __syncthreads();
    // dq, TPR threads per row: smq = softmax(q over Dh), dsq = (ctx·dAᵀ)·scale,
    // dq = smq∘(dsq − Σ dsq∘smq); idle rows recompute the last one
    const int rr = min(r, rows - 1);
    float qm = -INFINITY;
#pragma unroll
    for (int u = 0; u < T::NI; ++u) qm = fmaxf(qm, QQ[rr][lane + u * T::TPR]);
    qm = row_max<T::TPR>(qm);
    float qs = 0.f;
#pragma unroll
    for (int u = 0; u < T::NI; ++u) qs += __expf(QQ[rr][lane + u * T::TPR] - qm);
    qs = row_sum<T::TPR>(qs);
    float sq[T::NI], dsq[T::NI], dot = 0.f;
#pragma unroll
    for (int u = 0; u < T::NI; ++u) {
      const int i = lane + u * T::TPR;
      float s = 0.f;
      for (int j = 0; j < DH; ++j) s = fmaf(CT[i][j], DA[rr][j], s);
      sq[u] = __expf(QQ[rr][i] - qm) / qs;
      dsq[u] = s * a.scale;
      dot = fmaf(dsq[u], sq[u], dot);
    }
    dot = row_sum<T::TPR>(dot);
    if (r < rows) {
      bf16 *dq = a.dqkv + ((size_t)b * a.L + s0 + r) * rs + h * DH;
#pragma unroll
      for (int u = 0; u < T::NI; ++u)
        dq[lane + u * T::TPR] = __float2bfloat16(sq[u] * (dsq[u] - dot));
    }
    // dk[n][i] = softmax(k)[n][i]·(dk'[n][i] − G[i])
    for (int e = t; e < rows * DH; e += LIN_THREADS) {
      const int x = e / DH, i = e % DH;
      const bf16 *row = base + (size_t)(s0 + x) * rs;
      float dkf = 0.f;
#pragma unroll 8
      for (int j = 0; j < DH; ++j) dkf = fmaf(DC[i][j], VV[x][j], dkf);
      const float sk = __expf(__bfloat162float(row[a.d + h * DH + i]) - kM[i]) * kI[i];
      a.dqkv[((size_t)b * a.L + s0 + x) * rs + a.d + h * DH + i] =
          __float2bfloat16(sk * (dkf - G[i]));
    }
  }
}

template <int DH>
int launch(const bf16 *qkv, const bf16 *dattn, bf16 *dqkv, float2 *stats, Lin lin, int B,
           int L, int d, int heads, int nl, int window, cudaStream_t stream) {
  const float scale = rsqrtf((float)DH);
  if (nl > 0) {
    const int tq = window < TQ ? window : TQ;  // window % tq == 0 (checked)
    dim3 grid(L / tq, nl, B);
    local_dq_kernel<DH><<<grid, tq * S, 0, stream>>>(qkv, dattn, dqkv, stats, L, d, window, tq,
                                                     nl, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    local_dkv_kernel<DH><<<grid, tq * S, 0, stream>>>(qkv, dattn, stats, dqkv, L, d, window, tq,
                                                      nl, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (heads > nl) {
    lin.scale = scale;
    dim3 grid(lin.C, heads - nl, B);
    lin_bwd1<DH><<<grid, LIN_THREADS, 0, stream>>>(lin);
    lin_bwd2<DH><<<grid, LIN_THREADS, 0, stream>>>(lin);
    lin_bwd3<DH><<<grid, LIN_THREADS, 0, stream>>>(lin);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B, L, 3d) bf16, dattn (B, L, d) bf16 → dqkv (B, L, 3d) bf16.  Head
// dim d / heads must be 32 or 64; with local heads L % window == 0 and
// window % 64 == 0 or window a multiple of 8 below 64.  Scratch (f32):
// stats (B, local_heads, L, 2); for the linear heads, with C = ceil(L /
// chunk): kst (B, g, C, 2, Dh), dctx and ctx (B, g, C, Dh, Dh), gp (B, g,
// C, Dh), g = heads − local_heads.
B3_EXPORT int b3_stage3_attention_bwd(const void *qkv, const void *dattn, void *dqkv,
                                      void *stats, void *kst, void *dctx, void *ctx, void *gp,
                                      int B, int L, int d, int heads, int local_heads,
                                      int window, int chunk, void *stream) {
  const bf16 *q = static_cast<const bf16 *>(qkv);
  const bf16 *da = static_cast<const bf16 *>(dattn);
  bf16 *dq = static_cast<bf16 *>(dqkv);
  float2 *st = static_cast<float2 *>(stats);
  const Lin lin{q, da, dq, static_cast<float *>(kst), static_cast<float *>(dctx),
                static_cast<float *>(ctx), static_cast<float *>(gp), L, d, local_heads, chunk,
                (L + chunk - 1) / chunk, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / heads) {
    case 32: return launch<32>(q, da, dq, st, lin, B, L, d, heads, local_heads, window, s);
    case 64: return launch<64>(q, da, dq, st, lin, B, L, d, heads, local_heads, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
