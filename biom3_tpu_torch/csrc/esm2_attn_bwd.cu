// esm2_attention_bwd: the gradient of esm2_attention (esm2_attn.cu) with
// respect to its fused [q | k | v] input: (qkv, dattn, PAD mask, rotary
// tables) → dqkv, all (B, L, ·) bf16, dq and dk in pre-rotation
// coordinates.  Every softmax is recomputed from qkv.
//
// Replaces the per-head backward of the TPU kernel
// biom3_tpu/ops/pallas/esm2_block_tpu.py:411 (_attn_bwd_call,
// _attn_bwd_kernel :193-261), at its rounding points: rotated q and k in
// bf16 (rope8, as the forward), s = q·kᵀ·Dh^-0.5 with −1e9 added on PAD
// keys (:218), f32 softmax, dV = bf16(p)ᵀ·dA, dP = dA·Vᵀ, D = Σ dP∘p from
// the f32 p, dS = bf16(p∘(dP − D)·Dh^-0.5), dQ = dS·K, dK = dSᵀ·Q in f32,
// then the adjoint of the rotation, dz = dy·cos + rotate_halfᵀ(bf16(dy·
// sin)) (unrot, :202-208), rounded to bf16 (the TPU's bf16 dqkv staging).
//
// The TPU holds each head's whole (L, L) f32 score matrix in VMEM and sums
// dK/dV of all queries in one pass.  Here the work is split the
// FlashAttention-2 way, deterministic, with nothing shared between blocks
// and no atomics, on the tensor cores (attn_hopper.cuh):
// * a staging launch (esm2_rope.cuh, shared with the forward) writes
//   rotated q and k (rope8's rounding), v and dA into a bf16 scratch (4, B,
//   H, L, Dh), one head's rows contiguous, so every operand is a plain TMA
//   tile of a 3-D map (the TMA cannot rotate; head dim 32 then runs as
//   zero-filled 64-wide tiles like every other);
// * pass 1, query-owned (one block per 128 queries of a head, 64 a
//   warpgroup; Q and dA resident, K and V tiles streamed twice):
//   sweep 1 computes S = Q·Kᵀ and dP = dA·Vᵀ (both operands in shared
//   memory) and keeps online m, l and D̃ = Σ p̃∘dP in f32, D̃ rescaled with
//   l; (m, 1/l, D) are saved per row (m and 1/l rather than a logsumexp:
//   an all-PAD row has m = −1e9·log2 e, where m + log l rounds back to m).
//   Sweep 2 recomputes S and dP, forms dS in registers and runs dQ += dS·K
//   with dS as the register A operand and K read MN-major;
// * pass 2, key-owned (one block per 128 keys; K and V resident, Q, dA and
//   the row statistics streamed): Sᵀ = K·Qᵀ and dPᵀ = V·dAᵀ, Pᵀ from the
//   saved statistics, dV += bf16(Pᵀ)·dA and dK += dSᵀ·Q, summed over the
//   query tiles in a fixed order.
// The adjoint rotation runs in the epilogues from the accumulator
// registers: a lane's column c and its partner c ± Dh/2 sit in the same
// lane, Dh/16 register groups apart.
//
// PAD keys: pass 1 walks key tiles up to one past its batch row's last
// non-PAD key, and pass 2 writes zeros for a key block past it — exact,
// since p of a −1e9 key is 0 in f32 when a real key exists.  Keys >= L
// score −inf (excluded); query columns >= L get p = 0.  An all-PAD batch
// row attends uniformly (every score rounds to −1e9), so its gradient
// reaches every key and query as on the TPU; PAD query rows are computed,
// as on the TPU.
//
// What bounds it on an H100: this design runs 18·Dh FLOP of tensor-core
// work per (query, live key) pair (sweep 1 two products, sweep 2 three,
// pass 2 four), 1.8x the 10·Dh the function needs, which is the bound
// counted for it; both are operations bound.  The softmax arithmetic
// between the products, which a warpgroup does not overlap with its own
// products, is what the tensor cores wait on.
#include "attn_hopper.cuh"
#include "esm2_rope.cuh"

namespace {

using namespace attn;

constexpr int NWG = 2;                        // consumer warpgroups
constexpr int BR = 64 * NWG;                  // rows a block owns
constexpr int STAGES = 3;
constexpr int THREADS = NWG * 128 + 32;
constexpr int RESIDENT = 2 * NWG * TILE_BYTES;   // two operands of the block's rows
constexpr int P1_STAGE = 2 * TILE_BYTES;         // K, V
constexpr int STATS_BYTES = TILE * 16;           // (m, 1/l, D, 0) of 64 rows
constexpr int P2_STAGE = 2 * TILE_BYTES + 1024;  // Q, dA, stats (tiles stay 1024-aligned)
constexpr int P1_SMEM = RESIDENT + STAGES * P1_STAGE + (2 * STAGES + 1) * 8 + 1024;
constexpr int P2_SMEM = RESIDENT + STAGES * P2_STAGE + (2 * STAGES + 1) * 8 + 1024;

struct Args {
  const int *pad;
  const bf16 *cos, *sin;
  bf16 *dqkv;
  float4 *stats;  // (B·H, L): (m, 1/l, D, 0) per query row, m in log2 units
  int B, L, E, H;
  float scale;
};

// qkv (B, L, 3E), dattn (B, L, E) → ops (4, B, H, L, DH): rotated q,
// rotated k, v, dA.
template <int DH>
__global__ void __launch_bounds__(256)
esm2_bwd_stage_kernel(const bf16 *__restrict__ qkv, const bf16 *__restrict__ dattn,
                      const bf16 *__restrict__ cos, const bf16 *__restrict__ sin,
                      bf16 *__restrict__ ops, int B, int L, int E, int H) {
  stage_operands<DH>(qkv, dattn, cos, sin, ops, 4, B, L, E, H);
}

// Half h (one row) of a dQ or dK accumulator at its row's tables cs, sn:
// dz = dy·cos + rotate_halfᵀ(bf16(dy·sin)), bf16 to dst (the head's
// columns).  rotate_halfᵀ(w) = [w2, −w1]: column c < Dh/2 takes +w[c +
// Dh/2], the rest −w[c − Dh/2].
template <int DH>
__device__ __forceinline__ void unrotate_store(const float (&d)[32], int h, int lane,
                                               const bf16 *cs, const bf16 *sn, bf16 *dst) {
  constexpr int HALF = DH / 16;  // 8-column groups in half a head
#pragma unroll
  for (int q = 0; q < DH / 8; ++q) {
    const int pq = q < HALF ? q + HALF : q - HALF;
    const float sign = q < HALF ? 1.f : -1.f;
    const int c = acc_col(q, 0, lane), pc = acc_col(pq, 0, lane);
    const float2 co = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(cs + c));
    const float2 sp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(sn + pc));
    const float v0 = fmaf(d[4 * q + 2 * h], co.x, sign * round_bf16(d[4 * pq + 2 * h] * sp.x));
    const float v1 =
        fmaf(d[4 * q + 2 * h + 1], co.y, sign * round_bf16(d[4 * pq + 2 * h + 1] * sp.y));
    *reinterpret_cast<__nv_bfloat162 *>(dst + c) = __floats2bfloat162_rn(v0, v1);
  }
}

// Pass 1 (query-owned): queries [q0, q0 + BR) of head blockIdx.y, batch
// row blockIdx.z.  Two blocks an SM (96 registers, ~100 bytes of spills a
// thread) measured 4 % faster than one at 128 registers (PERF.md).
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
esm2_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_ops, Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = aligned_smem(smem_raw);
  uint8_t *sq = smem, *sda = smem + NWG * TILE_BYTES, *ring = smem + RESIDENT;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * P1_STAGE);
  uint64_t *empty = full + STAGES, *once = empty + STAGES;
  const int b = blockIdx.z, head = blockIdx.y, L = a.L, E = a.E;
  const int bh = b * a.H + head, BH = a.B * a.H, q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int *key_pad = a.pad + (size_t)b * L;
  init_ring<STAGES, NWG>(full, empty, once);
  const int live = block_live_keys(key_pad, L);  // synchronises the block
  const int tiles = (live + TILE - 1) / TILE;

  if (warp == NWG * 4) {  // producer: Q and dA once, then the keys twice
    if (lane == 0) {
      mbar_arrive_expect_tx(once, RESIDENT);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        tma_load_3d(sq + w * TILE_BYTES, &map_ops, once, 0, q0 + w * TILE, OP_Q * BH + bh);
        tma_load_3d(sda + w * TILE_BYTES, &map_ops, once, 0, q0 + w * TILE, OP_DA * BH + bh);
      }
      for (int it = 0; it < 2 * tiles; ++it) {
        const int s = it % STAGES, k0 = (it < tiles ? it : it - tiles) * TILE;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], P1_STAGE);
        uint8_t *st = ring + s * P1_STAGE;
        tma_load_3d(st, &map_ops, &full[s], 0, k0, OP_K * BH + bh);
        tma_load_3d(st + TILE_BYTES, &map_ops, &full[s], 0, k0, OP_V * BH + bh);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const uint8_t *qt = sq + wg * TILE_BYTES, *dat = sda + wg * TILE_BYTES;
  float s[32], dp[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float corr[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(once, 0);

  // sweep 1: online max m, sum l and dn = Σ_j p̃_j·dP_j (log2 units)
  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, k0 = t * TILE;
    const uint64_t pad = pad_mask(key_pad, k0, L, lane);
    mbar_wait(&full[st], (t / STAGES) & 1);
    const uint8_t *kt = ring + st * P1_STAGE, *vt = kt + TILE_BYTES;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt(s, qt, kt);
    product_nt(dp, dat, vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (lane == 0) mbar_arrive(&empty[st]);
    mask_scores<false>(s, pad, k0, L, a.scale, lane);
    online_step(s, m, corr);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sp = 0.f, sd = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sp += s[4 * q + 2 * h + e];
          sd = fmaf(s[4 * q + 2 * h + e], dp[4 * q + 2 * h + e], sd);
        }
      l[h] = l[h] * corr[h] + sp;
      dn[h] = dn[h] * corr[h] + sd;
    }
  }
  float inv_l[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    inv_l[h] = 1.f / quad_sum(l[h]);
    D[h] = quad_sum(dn[h]) * inv_l[h];
    const int row = q0 + wg * TILE + acc_row(h, warp, lane);
    if (lane % 4 == 0 && row < L)
      a.stats[(size_t)bh * L + row] = make_float4(m[h], inv_l[h], D[h], 0.f);
  }

  // sweep 2: dQ (rotated coordinates) += dS·K
  float dq[32];
  uint32_t frag[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int it = tiles + t, st = it % STAGES, k0 = t * TILE;
    const uint64_t pad = pad_mask(key_pad, k0, L, lane);
    mbar_wait(&full[st], (it / STAGES) & 1);
    const uint8_t *kt = ring + st * P1_STAGE, *vt = kt + TILE_BYTES;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt(s, qt, kt);
    product_nt(dp, dat, vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mask_scores<false>(s, pad, k0, L, a.scale, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      s[i] = exp2f(s[i] - m[h]) * inv_l[h] * (dp[i] - D[h]) * a.scale;
    }
    to_frags(s, frag);  // dS rounded to bf16
    fence_regs(frag);
    fence_regs(dq);
    wgmma_fence();
    product_pv(dq, frag, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * TILE + acc_row(h, warp, lane);
    if (row < L)
      unrotate_store<DH>(dq, h, lane, a.cos + (size_t)row * DH, a.sin + (size_t)row * DH,
                         a.dqkv + ((size_t)b * L + row) * 3 * E + head * DH);
  }
}

// Pass 2 (key-owned): keys [k0, k0 + BR) of head blockIdx.y, batch row
// blockIdx.z, over every query row.  Four accumulators (dK, dV, Sᵀ, dPᵀ)
// hold it to one block an SM.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
esm2_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_ops,
                          const __grid_constant__ CUtensorMap map_stats, Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = aligned_smem(smem_raw);
  uint8_t *sk = smem, *sv = smem + NWG * TILE_BYTES, *ring = smem + RESIDENT;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * P2_STAGE);
  uint64_t *empty = full + STAGES, *once = empty + STAGES;
  const int b = blockIdx.z, head = blockIdx.y, L = a.L, E = a.E;
  const int bh = b * a.H + head, BH = a.B * a.H, k0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int *key_pad = a.pad + (size_t)b * L;
  bf16 *out = a.dqkv + (size_t)b * L * 3 * E + head * DH;
  init_ring<STAGES, NWG>(full, empty, once);
  const int live = block_live_keys(key_pad, L);  // synchronises the block
  if (k0 >= live) {  // every key of the block is past the last live key: p = 0
    const int rows = min(BR, L - k0), vecs = DH / 8;
    for (int v = threadIdx.x; v < rows * 2 * vecs; v += blockDim.x) {
      const int r = v / (2 * vecs), part = v / vecs % 2, c = v % vecs * 8;
      *reinterpret_cast<uint4 *>(out + (size_t)(k0 + r) * 3 * E + (1 + part) * E + c) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int qtiles = (L + TILE - 1) / TILE;

  if (warp == NWG * 4) {  // producer: K and V once, then the query tiles
    if (lane == 0) {
      mbar_arrive_expect_tx(once, RESIDENT);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        tma_load_3d(sk + w * TILE_BYTES, &map_ops, once, 0, k0 + w * TILE, OP_K * BH + bh);
        tma_load_3d(sv + w * TILE_BYTES, &map_ops, once, 0, k0 + w * TILE, OP_V * BH + bh);
      }
      for (int t = 0; t < qtiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES + STATS_BYTES);
        uint8_t *st = ring + s * P2_STAGE;
        tma_load_3d(st, &map_ops, &full[s], 0, t * TILE, OP_Q * BH + bh);
        tma_load_3d(st + TILE_BYTES, &map_ops, &full[s], 0, t * TILE, OP_DA * BH + bh);
        tma_load_3d(st + 2 * TILE_BYTES, &map_stats, &full[s], 0, t * TILE, bh);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const uint8_t *kt = sk + wg * TILE_BYTES, *vt = sv + wg * TILE_BYTES;
  float kbias[2];  // −1e9 on a PAD key row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wg * TILE + acc_row(h, warp, lane);
    kbias[h] = row < L && key_pad[row] ? MASKED : 0.f;
  }
  float s[32], dp[32], dk[32], dv[32];
  uint32_t fp[4][4], fd[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dk[i] = dv[i] = 0.f;
  mbar_wait(once, 0);
  for (int t = 0; t < qtiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(&full[st], (t / STAGES) & 1);
    const uint8_t *qt = ring + st * P2_STAGE, *dat = qt + TILE_BYTES;
    const float4 *stats = reinterpret_cast<const float4 *>(qt + 2 * TILE_BYTES);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt(s, kt, qt);    // Sᵀ: keys x queries
    product_nt(dp, vt, dat);  // dPᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = acc_col(q, e, lane);
        const float4 rs = stats[i];  // query i's (m, 1/l, D)
        const bool in = t * TILE + i < L;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * q + 2 * h + e;
          const float x = __fmul_rn(s[r], a.scale) + kbias[h];  // as mask_scores
          const float p = in ? exp2f(__fmul_rn(x, LOG2E) - rs.x) * rs.y : 0.f;
          s[r] = p;
          dp[r] = p * (dp[r] - rs.z) * a.scale;
        }
      }
    to_frags(s, fp);   // bf16(Pᵀ)
    to_frags(dp, fd);  // dSᵀ
    fence_regs(fp);
    fence_regs(fd);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    product_pv(dv, fp, dat);
    product_pv(dk, fd, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    if (lane == 0) mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wg * TILE + acc_row(h, warp, lane);
    if (row >= L) continue;
    bf16 *dst = out + (size_t)row * 3 * E;
    unrotate_store<DH>(dk, h, lane, a.cos + (size_t)row * DH, a.sin + (size_t)row * DH, dst + E);
#pragma unroll
    for (int q = 0; q < DH / 8; ++q)
      *reinterpret_cast<__nv_bfloat162 *>(dst + 2 * E + acc_col(q, 0, lane)) =
          __floats2bfloat162_rn(dv[4 * q + 2 * h], dv[4 * q + 2 * h + 1]);
  }
}

template <int DH>
int launch(const bf16 *qkv, const bf16 *dattn, bf16 *ops, Args a, cudaStream_t stream) {
  const int BH = a.B * a.H;
  esm2_bwd_stage_kernel<DH><<<stage_grid(a.B, a.L, a.E, 4), 256, 0, stream>>>(
      qkv, dattn, a.cos, a.sin, ops, a.B, a.L, a.E, a.H);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  CUtensorMap mo, ms;
  err = encode_heads(&mo, ops, DH, a.L, 4 * BH);
  if (err) return err;
  const uint64_t dims[3] = {4, (uint64_t)a.L, (uint64_t)BH};
  const uint64_t strides[2] = {16, (uint64_t)a.L * 16};
  const uint32_t box[3] = {4, TILE, 1};
  err = hopper::encode_tiled(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.stats, 3, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(esm2_bwd_dq_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, P1_SMEM);
    if (!err)
      err = cudaFuncSetAttribute(esm2_bwd_dkv_wgmma_kernel<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, P2_SMEM);
    if (err) return err;
    sized = true;
  }
  a.scale = 1.f / sqrtf((float)DH);
  dim3 grid((a.L + BR - 1) / BR, a.H, a.B);
  esm2_bwd_dq_wgmma_kernel<DH><<<grid, THREADS, P1_SMEM, stream>>>(mo, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  esm2_bwd_dkv_wgmma_kernel<DH><<<grid, THREADS, P2_SMEM, stream>>>(mo, ms, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B, L, 3E) bf16 [q | k | v]; dattn (B, L, E) bf16; pad (B, L) int32,
// nonzero = PAD; cos, sin (L, E / heads) bf16 → dqkv (B, L, 3E) bf16;
// scratch: stats (B, heads, L, 4) f32 and ops (4, B, heads, L, E / heads)
// bf16; every pointer 16-byte aligned; E / heads in {32, 64}.
B3_EXPORT int b3_esm2_attention_bwd(const void *qkv, const void *dattn, const void *pad,
                                    const void *cos, const void *sin, void *dqkv, void *stats,
                                    void *ops, int B, int L, int E, int heads, void *stream) {
  const Args a{static_cast<const int *>(pad), static_cast<const bf16 *>(cos),
               static_cast<const bf16 *>(sin), static_cast<bf16 *>(dqkv),
               static_cast<float4 *>(stats), B, L, E, heads, 0.f};
  const bf16 *q = static_cast<const bf16 *>(qkv), *d = static_cast<const bf16 *>(dattn);
  bf16 *o = static_cast<bf16 *>(ops);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E / heads) {
    case 32: return launch<32>(q, d, o, a, st);
    case 64: return launch<64>(q, d, o, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
