// local_window_attention: standalone 3-window band attention on (B, H, L, D)
// q, k, v — each window of W queries attends to the keys of windows w-1, w,
// w+1 under one softmax, out-of-range windows masked (lucidrains local
// attention, non-causal, look_backward = look_forward = 1).
//
// Replaces biom3_tpu/ops/pallas/local_attention_tpu.py:73
// (local_window_attention_pallas → pallas_call :101), the kernel behind
// ProteoScribe(attn_impl="pallas"); here it backs attn_impl="kernel".  A
// masked window's keys score -1e9 there and weigh exp(-1e9 - m) = 0, so the
// band is clipped to the windows that exist here.
//
// bf16: local_attn_wgmma, on the tensor cores (attn_hopper.cuh).  One
// block per (128 queries, batch·head): two consumer warpgroups of 64
// queries and a producer warp.  The Q tile arrives once by TMA; K and V
// tiles of 64 keys from the union of the block's rows' bands,
// [max(0, (w_first−1)·W), min(L, (w_last+2)·W)), stream through a 3-stage
// ring (6 tiles at W = 128, 4 at the edge windows); tiles outside the band
// are never loaded.  forward_sweep runs with the WindowBand policy: a key
// outside a row's own band scores −inf, so a warpgroup whose rows lie in
// two windows (W < 64) or a tile straddling the band's edge (W = 96) stays
// exact, and a tile outside every row of a warpgroup is skipped.  Head dim
// 32 runs on zero-filled 64-wide boxes, as flash_attention.
//
// Rounding: the online softmax of forward_sweep (one sweep of the band):
// p̃ = exp(s − m_running) rounded to bf16 for P·V, o rescaled as m rises,
// the f32 sum divided by the f32 l.  The TPU kernel rounds e = exp(s − m)
// against the final row max (local_attention_tpu.py:34-68); both round an
// unnormalised weight once to bf16 and divide by an unrounded f32
// denominator, so they differ at the level of that one rounding.
//
// f32: local_attn_f32, on CUDA cores, the TPU kernel's f32 parity route
// (Precision.HIGHEST, :98-100) at its rounding points: q scaled by D^-0.5
// in f32 before the dot; e = exp(s − m) against the final row max; the f32
// sum divided by the f32 denominator.  One block per (query tile of one
// window, batch·head), S = 4 threads per query row, each walking every
// S-th key of the band with q in registers; the band streams through
// shared memory in f32 tiles of TK rows, twice: pass 1 finds each row's
// max, pass 2 forms e, the denominator and the AV sums, which merge across
// the S threads by shuffles.
//
// What bounds it on an H100: 4·D FLOP per (query, band key) pair, 12·W·D
// a query row, against its q, k, v and output rows, 8·D bytes in bf16:
// 1.5·W FLOP a byte, 192 at W = 128, under the card's ~295, so the bound
// is HBM traffic.  What the wgmma kernel waits on is the softmax between
// its two products, as in flash_attention.
#include "attn_hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16: wgmma

using namespace attn;

constexpr int NWG = 2;                        // consumer warpgroups
constexpr int BQ = 64 * NWG;                  // queries a block
constexpr int STAGES = 3;
constexpr int THREADS = NWG * 128 + 32;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // K, V
constexpr int SMEM = NWG * TILE_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
local_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, bf16 *__restrict__ out,
                        int L, int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t *sq = smem, *ring = smem + NWG * TILE_BYTES;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * STAGE_BYTES);
  uint64_t *empty = full + STAGES, *qbar = empty + STAGES;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
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
        tma_load_3d(sq + w * TILE_BYTES, &map_q, qbar, 0, q0 + w * TILE, bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        uint8_t *st = ring + s * STAGE_BYTES;
        tma_load_3d(st, &map_k, &full[s], 0, k_lo + t * TILE, bh);
        tma_load_3d(st + TILE_BYTES, &map_v, &full[s], 0, k_lo + t * TILE, bh);
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
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * TILE + acc_row(h, warp, lane);
    if (row >= L) continue;
    const float inv = 1.f / l[h];
    bf16 *dst = out + ((size_t)bh * L + row) * DH;
#pragma unroll
    for (int q = 0; q < DH / 8; ++q)
      *reinterpret_cast<__nv_bfloat162 *>(dst + acc_col(q, 0, lane)) =
          __floats2bfloat162_rn(o[4 * q + 2 * h] * inv, o[4 * q + 2 * h + 1] * inv);
  }
}

template <int DH>
int launch_wgmma(const bf16 *q, const bf16 *k, const bf16 *v, bf16 *out, int BH, int L,
                 int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = encode_heads(&mq, q, DH, L, BH);
  if (!err) err = encode_heads(&mk, k, DH, L, BH);
  if (!err) err = encode_heads(&mv, v, DH, L, BH);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(local_attn_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err) return err;
    sized = true;
  }
  dim3 grid((L + BQ - 1) / BQ, BH);
  local_attn_wgmma_kernel<DH><<<grid, THREADS, SMEM, stream>>>(mq, mk, mv, out, L, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- f32: CUDA cores

constexpr int S = 4;    // threads per query row
constexpr int TK = 64;  // key rows per shared-memory tile

template <int D>
__global__ void __launch_bounds__(D == 32 ? 512 : 256)
local_attn_f32_kernel(const float *__restrict__ q, const float *__restrict__ k,
                      const float *__restrict__ v, float *__restrict__ out, int L, int window,
                      int tq, float scale) {
  __shared__ float Ks[TK][D + 4];
  __shared__ float Vs[TK][D + 4];
  const size_t head = (size_t)blockIdx.y * L * D;
  const int q0 = blockIdx.x * tq, w = q0 / window;
  const int lo = max(0, (w - 1) * window), hi = min(L, (w + 2) * window);
  const int t = threadIdx.x, sub = t % S;
  const size_t qrow = head + (size_t)(q0 + t / S) * D;  // tq divides L: every row exists

  float qv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qv[c] = q[qrow + c] * scale;

  auto load_tile = [&](const float *src, float (*dst)[D + 4], int k0, int n) {
    for (int e = t; e < n * D; e += blockDim.x)
      dst[e / D][e % D] = src[head + (size_t)(k0 + e / D) * D + e % D];
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

  // pass 2: e = exp(s - m), its f32 sum, and Σ e·v
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
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(e, Vs[j][c], acc[c]);
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
    if (c / PER == sub) out[qrow + c] = acc[c] / den;
}

template <int D>
int launch_f32(const float *q, const float *k, const float *v, float *out, int BH, int L,
               int window, int tq, float scale, cudaStream_t stream) {
  dim3 grid(L / tq, BH);
  local_attn_f32_kernel<D><<<grid, tq * S, 0, stream>>>(q, k, v, out, L, window, tq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void *q, const void *k, const void *v, void *out, int BH, int L, int window,
           int tq, float scale, int is_f32, cudaStream_t stream) {
  if (is_f32)
    return launch_f32<D>(static_cast<const float *>(q), static_cast<const float *>(k),
                         static_cast<const float *>(v), static_cast<float *>(out), BH, L, window,
                         tq, scale, stream);
  return launch_wgmma<D>(static_cast<const bf16 *>(q), static_cast<const bf16 *>(k),
                         static_cast<const bf16 *>(v), static_cast<bf16 *>(out), BH, L, window,
                         scale, stream);
}

}  // namespace

// q, k, v, out: (B·H, L, D) contiguous, 16-byte aligned, f32 (is_f32) or
// bf16; D 32 or 64; L % window == 0; scale = D^-0.5.  f32 only: window %
// tq == 0, tq ≤ 128 (the query rows of a block; checked by the wrapper).
B3_EXPORT int b3_local_window_attention(const void *q, const void *k, const void *v, void *out,
                                        int BH, int L, int D, int window, int tq, float scale,
                                        int is_f32, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, out, BH, L, window, tq, scale, is_f32, s);
    case 64: return launch<64>(q, k, v, out, BH, L, window, tq, scale, is_f32, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
