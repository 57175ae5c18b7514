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
// * Band-local heads, on the tensor cores (attn_hopper.cuh).  A query of
//   window w sees the keys of windows w-1..w+1 that exist under one joint
//   f32 softmax (the -1e9 mask of the reference weighs 0).  With p =
//   softmax(s), s = q·kᵀ·Dh^-0.5, at the plain version's rounding points:
//     dV += bf16(p)ᵀ·dA, dP = dA·Vᵀ, D = Σ_j dP∘p,
//     dS = bf16(p∘(dP − D)·Dh^-0.5), dQ = dS·K, dK += dSᵀ·Q.
//   The TPU adds a key window's dK/dV from its three query windows into one
//   f32 strip in its sequential window loop; blocks run in parallel here,
//   so the work is split the FlashAttention-2 way, as esm2_attn_bwd.cu
//   splits it, with nothing shared between blocks and no atomics: the same
//   bits every call.  q, k, v and dA are read in place through 4-D TMA maps
//   (Dh, L, 3H, B) on qkv and (Dh, L, H, B) on dattn, (64, 64, 1, 1) boxes
//   (rows past L and, at head dim 32, columns 32..63 arrive as zeros), so
//   there is no staging launch.  The band is symmetric — a key of window w
//   is seen by exactly the queries of windows w-1..w+1 — so both passes
//   sweep the union of their block's rows' bands under the WindowBand
//   policy (a score outside its row's band is −inf or p = 0, a tile
//   outside every row of a warpgroup is skipped, tiles outside the block's
//   union are never loaded):
//   - pass 1 (stage3_bwd_dq_wgmma_kernel), query-owned: one block per
//     (128 queries, local head, batch row), two consumer warpgroups of 64
//     and a producer warp; Q and dA arrive once, the K and V tiles of the
//     band stream twice through a 3-stage ring.  Sweep 1 forms S = Q·Kᵀ
//     and dP = dA·Vᵀ and keeps online m, l and D̃ = Σ p̃∘dP in f32, saving
//     (m, 1/l, D) a row (log2 units); sweep 2 forms dS in registers and
//     runs dQ += dS·K with dS as the register A operand;
//   - pass 2 (stage3_bwd_dkv_wgmma_kernel), key-owned: one block per (128
//     keys, local head, batch row); K and V arrive once, the Q, dA and
//     statistics tiles of the band stream once.  Sᵀ = K·Qᵀ and dPᵀ = V·dAᵀ,
//     Pᵀ from the saved statistics, dV += bf16(Pᵀ)·dA and dK += dSᵀ·Q,
//     each key row summed over the query tiles in a fixed order.
//   A 64-row warpgroup spans two windows when W < 64, so the band is
//   checked per row; keys and queries at or past L score −inf / weigh 0.
//   Head dim 32 runs on the zero-filled 64-wide tiles: the score products
//   (S, dP and their transposes) reduce over the first 32 columns only
//   (two k-steps), the products with Dh as their width run 64 wide.
// * Linear heads, on CUDA cores.  q' = bf16(softmax(q over Dh)·Dh^-0.5),
//   k' = bf16(softmax(k over L)), ctx = bf16(k'ᵀv); the backward needs ctx
//   and dctx = bf16(q'ᵀ·dA) (Dh x Dh), and the k' softmax backward needs g
//   = Σ_n dk'∘softmax(k) over the whole sequence: three dependent steps,
//   three launches over a grid of (chunk of the sequence, head, batch row),
//   the rows a chunk from ops/kernels.py::stage3_linear_bwd_plan.  (1) k's
//   column max and Σexp and the chunk's part of dctx; (2) k', the chunk's
//   parts of ctx and g, and the dv = k'·dctx rows; (3) the dq and dk rows.
//   In (1) and (2) the block that finishes a pair's chunks last (an
//   integer ticket, as col_sum) adds the parts in chunk order: no float
//   atomics, the same bits every call.  Rows go through shared memory in
//   f32 tiles; a Dh x Dh sum is taken by threads that own 4x4 entries (two
//   16-byte loads for 16 FMAs a row), a row product by threads that hold a
//   row or column of the Dh x Dh matrix in registers (read once through
//   shared memory; the tile's row a broadcast read in 16-byte loads).  The bf16 rounding points of the TPU kernel are kept.
//
// What bounds it on an H100: the function needs 10·Dh FLOP per (query,
// band key) pair and 10·L·Dh² a linear head, against reading qkv and
// dattn and writing dqkv once; at Stage-3 shapes (Dh 32, W 128) the bytes
// bound it.  The band passes do 18·Dh FLOP a pair on the tensor cores
// (sweep 1 two products, sweep 2 three, pass 2 four; at head dim 32 the
// three with Dh as their width run 64 wide: 24·Dh), and read K, V (pass 1)
// and Q, dA (pass 2) once per block whose band holds them, from L2 after
// the first; what the tensor cores wait on is the softmax arithmetic
// between a warpgroup's products, as in esm2_attn_bwd.cu.  The linear
// heads read q, v and dA twice and k three times, and their Dh x Dh
// products are a few FLOPs a byte: they wait on their launches' latency
// and shared-memory reads.
#include "attn_hopper.cuh"

namespace {

using namespace attn;

// ---- band-local heads -----------------------------------------------------

constexpr int NWG = 2;                           // consumer warpgroups
constexpr int BR = 64 * NWG;                     // rows a block owns
constexpr int STAGES = 3;
constexpr int THREADS = NWG * 128 + 32;
constexpr int RESIDENT = 2 * NWG * TILE_BYTES;   // two operands of the block's rows
constexpr int P1_STAGE = 2 * TILE_BYTES;         // K, V
constexpr int STATS_BYTES = TILE * 16;           // (m, 1/l, D, 0) of 64 rows
constexpr int P2_STAGE = 2 * TILE_BYTES + 1024;  // Q, dA, stats (tiles stay 1024-aligned)
constexpr int P1_SMEM = RESIDENT + STAGES * P1_STAGE + (2 * STAGES + 1) * 8 + 1024;
constexpr int P2_SMEM = RESIDENT + STAGES * P2_STAGE + (2 * STAGES + 1) * 8 + 1024;

struct BandArgs {
  bf16 *dqkv;
  float4 *stats;  // (B·nl, L): (m, 1/l, D, 0) per query row, m in log2 units
  int L, d, H, nl, window;
  float scale;
};

// The union of the bands of rows [r0, min(r0 + BR, L)), clipped to [0, L):
// [lo, hi), and the 64-row tiles that cover it from lo.
struct Span {
  int lo, tiles;
  __device__ __forceinline__ Span(int r0, int window, int L) {
    lo = max(0, (r0 / window - 1) * window);
    const int hi = min(L, ((min(r0 + BR, L) - 1) / window + 2) * window);
    tiles = (hi - lo + TILE - 1) / TILE;
  }
};

// Pass 1 (query-owned): queries [q0, q0 + BR) of local head blockIdx.y,
// batch row blockIdx.z.
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
stage3_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                           const __grid_constant__ CUtensorMap map_da, BandArgs a) {
  constexpr int KS = DH / 16;   // k-steps of the score products
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = aligned_smem(smem_raw);
  uint8_t *sq = smem, *sda = smem + NWG * TILE_BYTES, *ring = smem + RESIDENT;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * P1_STAGE);
  uint64_t *empty = full + STAGES, *once = empty + STAGES;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * BR, L = a.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Span keys(q0, a.window, L);
  init_ring<STAGES, NWG>(full, empty, once);
  __syncthreads();

  if (warp == NWG * 4) {  // producer: Q and dA once, then the band's keys twice
    if (lane == 0) {
      mbar_arrive_expect_tx(once, RESIDENT);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        hopper::tma_load_4d(sq + w * TILE_BYTES, &map_qkv, once, 0, q0 + w * TILE, head, b);
        hopper::tma_load_4d(sda + w * TILE_BYTES, &map_da, once, 0, q0 + w * TILE, head, b);
      }
      for (int it = 0; it < 2 * keys.tiles; ++it) {
        const int s = it % STAGES;
        const int k0 = keys.lo + (it < keys.tiles ? it : it - keys.tiles) * TILE;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], P1_STAGE);
        uint8_t *st = ring + s * P1_STAGE;
        hopper::tma_load_4d(st, &map_qkv, &full[s], 0, k0, a.H + head, b);
        hopper::tma_load_4d(st + TILE_BYTES, &map_qkv, &full[s], 0, k0, 2 * a.H + head, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const WindowBand band(q0 + wg * TILE, a.window, L, warp, lane);
  const uint8_t *qt = sq + wg * TILE_BYTES, *dat = sda + wg * TILE_BYTES;
  float s[32], dp[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float corr[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(once, 0);

  // sweep 1: online max m, sum l and dn = Σ_j p̃_j·dP_j (log2 units)
  for (int t = 0; t < keys.tiles; ++t) {
    const int st = t % STAGES, k0 = keys.lo + t * TILE;
    mbar_wait(&full[st], (t / STAGES) & 1);
    if (!band.touches(k0)) {
      if (lane == 0) mbar_arrive(&empty[st]);
      continue;
    }
    const uint8_t *kt = ring + st * P1_STAGE, *vt = kt + TILE_BYTES;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt<KS>(s, qt, kt);
    product_nt<KS>(dp, dat, vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (lane == 0) mbar_arrive(&empty[st]);
    mask_scores<true>(s, 0, k0, L, a.scale, lane, band);
    online_step<true>(s, m, corr);
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
  // A row past L may see no key (m = −inf): its p is then 0, not NaN.
  float inv_l[2], D[2], mref[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    inv_l[h] = sum > 0.f ? 1.f / sum : 0.f;
    D[h] = quad_sum(dn[h]) * inv_l[h];
    mref[h] = m[h] == -INFINITY ? 0.f : m[h];
    const int row = q0 + wg * TILE + acc_row(h, warp, lane);
    if (lane % 4 == 0 && row < L)
      a.stats[(size_t)(b * a.nl + head) * L + row] = make_float4(m[h], inv_l[h], D[h], 0.f);
  }

  // sweep 2: dQ += dS·K
  float dq[32];
  uint32_t frag[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int t = 0; t < keys.tiles; ++t) {
    const int it = keys.tiles + t, st = it % STAGES, k0 = keys.lo + t * TILE;
    mbar_wait(&full[st], (it / STAGES) & 1);
    if (!band.touches(k0)) {
      if (lane == 0) mbar_arrive(&empty[st]);
      continue;
    }
    const uint8_t *kt = ring + st * P1_STAGE, *vt = kt + TILE_BYTES;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt<KS>(s, qt, kt);
    product_nt<KS>(dp, dat, vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mask_scores<true>(s, 0, k0, L, a.scale, lane, band);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      s[i] = exp2f(s[i] - mref[h]) * inv_l[h] * (dp[i] - D[h]) * a.scale;
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
    if (row >= L) continue;
    bf16 *dst = a.dqkv + ((size_t)b * L + row) * 3 * a.d + head * DH;
#pragma unroll
    for (int q = 0; q < DH / 8; ++q)
      *reinterpret_cast<__nv_bfloat162 *>(dst + acc_col(q, 0, lane)) =
          __floats2bfloat162_rn(dq[4 * q + 2 * h], dq[4 * q + 2 * h + 1]);
  }
}

// Pass 2 (key-owned): keys [k0, k0 + BR) of local head blockIdx.y, batch
// row blockIdx.z, over the queries of their band.  Four accumulators (dK,
// dV, Sᵀ, dPᵀ) hold it to one block an SM.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
stage3_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                            const __grid_constant__ CUtensorMap map_da,
                            const __grid_constant__ CUtensorMap map_stats, BandArgs a) {
  constexpr int KS = DH / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = aligned_smem(smem_raw);
  uint8_t *sk = smem, *sv = smem + NWG * TILE_BYTES, *ring = smem + RESIDENT;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * P2_STAGE);
  uint64_t *empty = full + STAGES, *once = empty + STAGES;
  const int b = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * BR, L = a.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Span queries(k0, a.window, L);
  init_ring<STAGES, NWG>(full, empty, once);
  __syncthreads();

  if (warp == NWG * 4) {  // producer: K and V once, then the band's query tiles
    if (lane == 0) {
      mbar_arrive_expect_tx(once, RESIDENT);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        hopper::tma_load_4d(sk + w * TILE_BYTES, &map_qkv, once, 0, k0 + w * TILE, a.H + head, b);
        hopper::tma_load_4d(sv + w * TILE_BYTES, &map_qkv, once, 0, k0 + w * TILE,
                            2 * a.H + head, b);
      }
      for (int t = 0; t < queries.tiles; ++t) {
        const int s = t % STAGES, i0 = queries.lo + t * TILE;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES + STATS_BYTES);
        uint8_t *st = ring + s * P2_STAGE;
        hopper::tma_load_4d(st, &map_qkv, &full[s], 0, i0, head, b);
        hopper::tma_load_4d(st + TILE_BYTES, &map_da, &full[s], 0, i0, head, b);
        tma_load_3d(st + 2 * TILE_BYTES, &map_stats, &full[s], 0, i0, b * a.nl + head);
      }
    }
    return;
  }

  const int wg = warp / 4;
  // the band of a key row is the set of query rows that see it
  const WindowBand band(k0 + wg * TILE, a.window, L, warp, lane);
  const uint8_t *kt = sk + wg * TILE_BYTES, *vt = sv + wg * TILE_BYTES;
  float s[32], dp[32], dk[32], dv[32];
  uint32_t fp[4][4], fd[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dk[i] = dv[i] = 0.f;
  mbar_wait(once, 0);
  for (int t = 0; t < queries.tiles; ++t) {
    const int st = t % STAGES, i0 = queries.lo + t * TILE;
    mbar_wait(&full[st], (t / STAGES) & 1);
    if (!band.touches(i0)) {
      if (lane == 0) mbar_arrive(&empty[st]);
      continue;
    }
    const uint8_t *qt = ring + st * P2_STAGE, *dat = qt + TILE_BYTES;
    const float4 *stats = reinterpret_cast<const float4 *>(qt + 2 * TILE_BYTES);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt<KS>(s, kt, qt);    // Sᵀ: keys x queries
    product_nt<KS>(dp, vt, dat);  // dPᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = acc_col(q, e, lane);
        const float4 rs = stats[i];  // query i0 + i's (m, 1/l, D)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * q + 2 * h + e;
          const bool live = i0 + i < L && !band.masked(h, i0 + i);
          // the score as mask_scores forms it in pass 1
          const float x = __fmul_rn(__fmul_rn(s[r], a.scale), LOG2E);
          const float p = live ? exp2f(x - rs.x) * rs.y : 0.f;
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
    bf16 *dst = a.dqkv + ((size_t)b * L + row) * 3 * a.d + head * DH;
#pragma unroll
    for (int q = 0; q < DH / 8; ++q) {
      const int c = acc_col(q, 0, lane);
      *reinterpret_cast<__nv_bfloat162 *>(dst + a.d + c) =
          __floats2bfloat162_rn(dk[4 * q + 2 * h], dk[4 * q + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162 *>(dst + 2 * a.d + c) =
          __floats2bfloat162_rn(dv[4 * q + 2 * h], dv[4 * q + 2 * h + 1]);
    }
  }
}

template <int DH>
int launch_band(const bf16 *qkv, const bf16 *dattn, BandArgs a, int B, cudaStream_t stream) {
  const int L = a.L, H = a.H;
  // qkv (Dh, L, 3H, B) and dattn (Dh, L, H, B) with their strides, (64,
  // TILE, 1, 1) boxes; the statistics (4, L, B·nl) f32, (4, TILE, 1) boxes
  const uint64_t dq_dims[4] = {(uint64_t)DH, (uint64_t)L, (uint64_t)3 * H, (uint64_t)B};
  const uint64_t dq_strides[3] = {(uint64_t)a.d * 6, (uint64_t)DH * 2, (uint64_t)L * a.d * 6};
  const uint64_t da_dims[4] = {(uint64_t)DH, (uint64_t)L, (uint64_t)H, (uint64_t)B};
  const uint64_t da_strides[3] = {(uint64_t)a.d * 2, (uint64_t)DH * 2, (uint64_t)L * a.d * 2};
  const uint64_t st_dims[3] = {4, (uint64_t)L, (uint64_t)B * a.nl};
  const uint64_t st_strides[2] = {16, (uint64_t)L * 16};
  const uint32_t box[4] = {64, TILE, 1, 1}, st_box[3] = {4, TILE, 1};
  CUtensorMap mqkv, mda, mst;
  int err = hopper::encode_tiled(&mqkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, 4, dq_dims,
                                 dq_strides, box);
  if (!err)
    err = hopper::encode_tiled(&mda, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dattn, 4, da_dims,
                               da_strides, box);
  if (!err)
    err = hopper::encode_tiled(&mst, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.stats, 3, st_dims,
                               st_strides, st_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(stage3_bwd_dq_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, P1_SMEM);
    if (!err)
      err = cudaFuncSetAttribute(stage3_bwd_dkv_wgmma_kernel<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, P2_SMEM);
    if (err) return err;
    sized = true;
  }
  const dim3 grid((L + BR - 1) / BR, a.nl, B);
  stage3_bwd_dq_wgmma_kernel<DH><<<grid, THREADS, P1_SMEM, stream>>>(mqkv, mda, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  stage3_bwd_dkv_wgmma_kernel<DH><<<grid, THREADS, P2_SMEM, stream>>>(mqkv, mda, mst, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- linear heads ---------------------------------------------------------

constexpr int LIN_THREADS = 256;
constexpr int LIN_MAX_PAIRS = 8192;   // pairs that may have more than one chunk
// An integer ticket a pair for lin_bwd1 and one for lin_bwd2; the block
// that takes a pair's last resets it.
__device__ unsigned int s3b_tickets[2][LIN_MAX_PAIRS];

template <int DH>
struct LinTile {
  static constexpr int T = 2048 / DH;               // rows of a shared tile: 64 at Dh 32, 32 at 64
  static constexpr int PAD = DH + 4;                // f32 row stride (rows stay 16-byte aligned)
  static constexpr int VPR = DH / 8;                // 16-byte loads a row: T·VPR = 256 threads
  static constexpr int G = LIN_THREADS / DH;        // row groups of the column owners
  static constexpr int OWNERS = DH * DH / 16;       // 4x4 owners of a Dh x Dh sum
  static constexpr int RG = LIN_THREADS / OWNERS;   // ... and their row groups
};

// A pair's f32 workspace (its size exported as b3_stage3_bwd_ws_floats
// for ops/kernels.py::stage3_attention_bwd): per chunk c of the sequence k's column max and
// Σexp, and the chunk parts of dctx = q'ᵀ·dA, ctx = k'ᵀ·v and g = Σ_n
// dk'∘softmax(k); the sums over the chunks (dctx and ctx rounded to bf16,
// k's max and 1/Σexp).
struct LinWs {
  float *kst, *kfin, *dctx_p, *dctx, *ctx_p, *ctx, *g_p, *g;
  __host__ __device__ static size_t floats(int C, int dh) {
    return (size_t)C * 2 * dh + 2 * dh + 2 * ((size_t)C * dh * dh + dh * dh) + (size_t)C * dh + dh;
  }
  __device__ LinWs(float *ws, int pair, int C, int dh) {
    kst = ws + (size_t)pair * floats(C, dh);   // [C][2][dh]
    kfin = kst + (size_t)C * 2 * dh;           // [2][dh]
    dctx_p = kfin + 2 * dh;                    // [C][dh][dh]
    dctx = dctx_p + (size_t)C * dh * dh;       // [dh][dh]
    ctx_p = dctx + dh * dh;                    // [C][dh][dh]
    ctx = ctx_p + (size_t)C * dh * dh;         // [dh][dh]
    g_p = ctx + dh * dh;                       // [C][dh]
    g = g_p + (size_t)C * dh;                  // [dh]
  }
};

struct Lin {
  const bf16 *qkv, *dattn;
  bf16 *dqkv;
  float *ws;
  int L, d, nl, chunk, C;
  float scale;
};

__device__ __forceinline__ uint4 ld16(const bf16 *p) { return *reinterpret_cast<const uint4 *>(p); }

__device__ __forceinline__ void st8(float *p, const float *v) {
  reinterpret_cast<float4 *>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4 *>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Max and sum over the N lanes of a row (consecutive lanes).
template <int N>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int N>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[x][y] += Σ_r A[r][i0 + x]·B[r][j0 + y] over the tile's rows rg, rg +
// RG, ... < rows (A, B: shared tiles of PAD floats a row).
template <int DH>
__device__ __forceinline__ void outer_acc(const float *A, const float *B, int rows, int rg,
                                          int i0, int j0, float (&acc)[4][4]) {
  using T = LinTile<DH>;
  for (int r = rg; r < rows; r += T::RG) {
    const float4 a = *reinterpret_cast<const float4 *>(A + r * T::PAD + i0);
    const float4 b = *reinterpret_cast<const float4 *>(B + r * T::PAD + j0);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// The block's part of a Dh x Dh sum → dst: the row groups' 4x4 blocks
// added in group order through red (RG·Dh² floats of shared memory that
// the tiles no longer use).
template <int DH>
__device__ __forceinline__ void store_part(float (&acc)[4][4], float *red, int rg, int i0, int j0,
                                           float *dst) {
  using T = LinTile<DH>;
  if constexpr (T::RG > 1) {
    __syncthreads();   // the tiles are consumed
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4 *>(&red[(rg * DH + i0 + x) * DH + j0]) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    __syncthreads();
    if (rg == 0)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          for (int k = 1; k < T::RG; ++k) acc[x][y] += red[(k * DH + i0 + x) * DH + j0 + y];
  }
  if (rg == 0)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4 *>(&dst[(i0 + x) * DH + j0]) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
}

// A Dh x Dh matrix M in global memory → stage, rows of Dh + 1 floats (so
// that thread col's row M[col][·] and column M[·][col] sit in distinct
// banks), read once and coalesced; every thread calls it.
template <int DH>
__device__ __forceinline__ void stage_matrix(const float *M, float *stage) {
  __syncthreads();   // stage is free
  for (int q = threadIdx.x; q < DH * DH; q += LIN_THREADS) stage[(q / DH) * (DH + 1) + q % DH] = M[q];
  __syncthreads();
}

// True in the block that finishes its pair's chunks last (every thread
// calls it after writing its parts): an integer ticket after a fence, as
// col_sum; with one chunk, the block itself.
__device__ __forceinline__ bool last_of_pair(unsigned int *ticket, int C) {
  __shared__ bool last;
  if (C == 1) {
    __syncthreads();
    return true;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == (unsigned)C - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// dst[q] = (bf16 when rnd) Σ_c parts[c][q], in chunk order, for q < n.
__device__ __forceinline__ void sum_parts(const float *parts, int C, int n, float *dst, bool rnd) {
  for (int q = threadIdx.x; q < n; q += LIN_THREADS) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += __ldcg(parts + (size_t)c * n + q);
    dst[q] = rnd ? round_bf16(s) : s;
  }
}

// Block (c, j, b): sequence rows [c·chunk, min(L, (c+1)·chunk)) of linear
// head local + j, batch row b.  Its pair is b·ng + j.
#define B3_LIN_BLOCK                                                                  \
  const int c = blockIdx.x, pair = blockIdx.z * gridDim.y + blockIdx.y;               \
  const int h = a.nl + blockIdx.y, t = threadIdx.x;                                   \
  const int n0 = c * a.chunk, n1 = min(a.L, n0 + a.chunk);                            \
  const size_t rs = 3 * (size_t)a.d;                                                  \
  const bf16 *qb = a.qkv + (size_t)blockIdx.z * a.L * rs + h * DH; /* q; k +d, v +2d */ \
  const size_t orow = (size_t)blockIdx.z * a.L;                                       \
  const LinWs w(a.ws, pair, a.C, DH)

// Pass 1: k's column max and Σexp over the chunk (thread (g, col) walks
// rows g, g + G, ..., the groups merged in order), and the chunk's part of
// dctx = q'ᵀ·dA with q' = bf16(softmax(q over Dh)·Dh^-0.5); the last block
// of a pair sums the parts into dctx and k's statistics into kfin.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS) lin_bwd1(Lin a) {
  using T = LinTile<DH>;
  __shared__ __align__(16) float buf[2 * T::T * T::PAD];   // QF, DA; then the owners' merge
  __shared__ float red_m[T::G][DH], red_s[T::G][DH];
  B3_LIN_BLOCK;
  const int col = t % DH, g = t / DH;
  {
    float m = -INFINITY, s = 0.f;
    for (int n = n0 + g; n < n1; n += T::G) {
      const float x = __bfloat162float(qb[(size_t)n * rs + a.d + col]);
      if (x > m) {
        s = s * __expf(m - x) + 1.f;   // 0 · exp(−inf) on the first row
        m = x;
      } else {
        s += __expf(x - m);
      }
    }
    red_m[g][col] = m;
    red_s[g][col] = s;
  }
  float *QF = buf, *DA = buf + T::T * T::PAD;
  const int e = t % T::OWNERS, rg = t / T::OWNERS;
  const int i0 = (e / (DH / 4)) * 4, j0 = (e % (DH / 4)) * 4;
  const int lr = t / T::VPR, f0 = (t % T::VPR) * 8;   // the row and 8 columns this thread loads
  float acc[4][4] = {};
  for (int s0 = n0; s0 < n1; s0 += T::T) {
    const int rows = min(T::T, n1 - s0), rr = min(lr, rows - 1);   // idle rows redo the last
    __syncthreads();   // the previous tile consumed
    float x[8], y[8];
    unpack8(ld16(qb + (s0 + rr) * rs + f0), x);
    unpack8(ld16(a.dattn + (orow + s0 + rr) * a.d + h * DH + f0), y);
    float mx = x[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) mx = fmaxf(mx, x[k]);
    mx = row_max<T::VPR>(mx);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x[k] = __expf(x[k] - mx);
      sum += x[k];
    }
    sum = row_sum<T::VPR>(sum);
    if (lr < rows) {
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = round_bf16(x[k] / sum * a.scale);
      st8(QF + lr * T::PAD + f0, x);
      st8(DA + lr * T::PAD + f0, y);
    }
    __syncthreads();
    outer_acc<DH>(QF, DA, rows, rg, i0, j0, acc);
  }
  if (t < DH) {
    float mx = red_m[0][t], sum = red_s[0][t];
    for (int k = 1; k < T::G; ++k) merge_stats(mx, sum, red_m[k][t], red_s[k][t]);
    w.kst[(size_t)c * 2 * DH + t] = mx;
    w.kst[(size_t)c * 2 * DH + DH + t] = sum;
  }
  store_part<DH>(acc, buf, rg, i0, j0, w.dctx_p + (size_t)c * DH * DH);
  if (!last_of_pair(&s3b_tickets[0][pair], a.C)) return;
  sum_parts(w.dctx_p, a.C, DH * DH, w.dctx, true);
  if (t < DH) {
    float mx = -INFINITY, sum = 0.f;
    for (int k = 0; k < a.C; ++k) mx = fmaxf(mx, __ldcg(w.kst + (size_t)k * 2 * DH + t));
    for (int k = 0; k < a.C; ++k)
      sum += __ldcg(w.kst + (size_t)k * 2 * DH + DH + t) *
             __expf(__ldcg(w.kst + (size_t)k * 2 * DH + t) - mx);
    w.kfin[t] = mx;
    w.kfin[DH + t] = 1.f / sum;
  }
}

// Pass 2: k' = bf16(softmax(k over L)), the chunk's part of ctx = k'ᵀ·v, the
// rows dv = k'·dctx, and the chunk's part of g = Σ_n dk'∘softmax(k) with dk'
// = v·dctxᵀ; thread (g, col) holds dctx's column and row col in registers
// and takes the tile's rows g, g + G, ...  The last block of a pair sums
// the parts into ctx and g.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS, DH == 32 ? 2 : 1) lin_bwd2(Lin a) {
  using T = LinTile<DH>;
  __shared__ __align__(16) float buf[3 * T::T * T::PAD];   // KF, SK, VV; then the owners' merge
  __shared__ float kM[DH], kI[DH], red_g[T::G][DH];
  B3_LIN_BLOCK;
  const int col = t % DH, g = t / DH;
  if (t < DH) {
    kM[t] = w.kfin[t];
    kI[t] = w.kfin[DH + t];
  }
  float dcol[DH], drow[DH];   // dctx[·][col], dctx[col][·]
  stage_matrix<DH>(w.dctx, buf);
#pragma unroll
  for (int y = 0; y < DH; ++y) {
    dcol[y] = buf[y * (DH + 1) + col];
    drow[y] = buf[col * (DH + 1) + y];
  }
  float *KF = buf, *SK = buf + T::T * T::PAD, *VV = buf + 2 * T::T * T::PAD;
  const int e = t % T::OWNERS, rg = t / T::OWNERS;
  const int i0 = (e / (DH / 4)) * 4, j0 = (e % (DH / 4)) * 4;
  const int lr = t / T::VPR, f0 = (t % T::VPR) * 8;
  float acc[4][4] = {}, gacc = 0.f;
  for (int s0 = n0; s0 < n1; s0 += T::T) {
    const int rows = min(T::T, n1 - s0);
    __syncthreads();   // kM and kI written; the previous tile consumed
    if (lr < rows) {
      const bf16 *row = qb + (s0 + lr) * rs + f0;
      float k[8], v[8], kf[8];
      unpack8(ld16(row + a.d), k);
      unpack8(ld16(row + 2 * a.d), v);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        k[q] = __expf(k[q] - kM[f0 + q]) * kI[f0 + q];
        kf[q] = round_bf16(k[q]);
      }
      st8(KF + lr * T::PAD + f0, kf);
      st8(SK + lr * T::PAD + f0, k);
      st8(VV + lr * T::PAD + f0, v);
    }
    __syncthreads();
    outer_acc<DH>(KF, VV, rows, rg, i0, j0, acc);
    for (int r = g; r < rows; r += T::G) {
      const float *kr = KF + r * T::PAD, *vr = VV + r * T::PAD;
      float dv = 0.f, dkf = 0.f;
#pragma unroll
      for (int y = 0; y < DH; y += 4) {
        const float4 kq = *reinterpret_cast<const float4 *>(kr + y);
        const float4 vq = *reinterpret_cast<const float4 *>(vr + y);
        dv = fmaf(kq.x, dcol[y], dv);
        dv = fmaf(kq.y, dcol[y + 1], dv);
        dv = fmaf(kq.z, dcol[y + 2], dv);
        dv = fmaf(kq.w, dcol[y + 3], dv);
        dkf = fmaf(vq.x, drow[y], dkf);
        dkf = fmaf(vq.y, drow[y + 1], dkf);
        dkf = fmaf(vq.z, drow[y + 2], dkf);
        dkf = fmaf(vq.w, drow[y + 3], dkf);
      }
      a.dqkv[(orow + s0 + r) * rs + 2 * a.d + h * DH + col] = __float2bfloat16(dv);
      gacc = fmaf(dkf, SK[r * T::PAD + col], gacc);
    }
  }
  red_g[g][col] = gacc;
  store_part<DH>(acc, buf, rg, i0, j0, w.ctx_p + (size_t)c * DH * DH);   // synchronises
  if (T::RG == 1) __syncthreads();
  if (t < DH) {
    float s = 0.f;
    for (int k = 0; k < T::G; ++k) s += red_g[k][t];
    w.g_p[(size_t)c * DH + t] = s;
  }
  if (!last_of_pair(&s3b_tickets[1][pair], a.C)) return;
  sum_parts(w.ctx_p, a.C, DH * DH, w.ctx, true);
  sum_parts(w.g_p, a.C, DH, w.g, false);
}

// Pass 3: the rows dq = softmax(q)∘(dsq − Σ dsq∘softmax(q)), dsq = dA·ctxᵀ·
// Dh^-0.5, and dk = softmax(k)∘(v·dctxᵀ − g); thread (g, col) holds ctx's
// and dctx's row col in registers and takes the tile's rows g, g + G, ...;
// each row's Σ dsq∘softmax(q) is summed by warp, then the row's warps in
// order.
template <int DH>
__global__ void __launch_bounds__(LIN_THREADS, DH == 32 ? 2 : 1) lin_bwd3(Lin a) {
  using T = LinTile<DH>;
  constexpr int WPR = DH / 32, RPT = T::T / T::G;   // warps a row spans; rows a thread takes
  __shared__ __align__(16) float buf[4 * T::T * T::PAD];   // SQ, DA, VV, SK
  __shared__ float kM[DH], kI[DH], rdot[T::T][WPR];
  B3_LIN_BLOCK;
  const int col = t % DH, g = t / DH, lane = t % 32;
  if (t < DH) {
    kM[t] = w.kfin[t];
    kI[t] = w.kfin[DH + t];
  }
  float crow[DH], drow[DH];   // ctx[col][·], dctx[col][·]
  stage_matrix<DH>(w.ctx, buf);
#pragma unroll
  for (int y = 0; y < DH; ++y) crow[y] = buf[col * (DH + 1) + y];
  stage_matrix<DH>(w.dctx, buf);
#pragma unroll
  for (int y = 0; y < DH; ++y) drow[y] = buf[col * (DH + 1) + y];
  const float gc = w.g[col];
  float *SQ = buf, *DA = buf + T::T * T::PAD, *VV = buf + 2 * T::T * T::PAD;
  float *SK = buf + 3 * T::T * T::PAD;
  const int lr = t / T::VPR, f0 = (t % T::VPR) * 8;
  for (int s0 = n0; s0 < n1; s0 += T::T) {
    const int rows = min(T::T, n1 - s0), rr = min(lr, rows - 1);
    __syncthreads();   // kM and kI written; the previous tile consumed
    const bf16 *row = qb + (s0 + rr) * rs + f0;
    float x[8], k[8], v[8], y[8];
    unpack8(ld16(row), x);
    unpack8(ld16(row + a.d), k);
    unpack8(ld16(row + 2 * a.d), v);
    unpack8(ld16(a.dattn + (orow + s0 + rr) * a.d + h * DH + f0), y);
    float mx = x[0];
#pragma unroll
    for (int q = 1; q < 8; ++q) mx = fmaxf(mx, x[q]);
    mx = row_max<T::VPR>(mx);
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      x[q] = __expf(x[q] - mx);
      sum += x[q];
    }
    sum = row_sum<T::VPR>(sum);
    if (lr < rows) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        x[q] /= sum;
        k[q] = __expf(k[q] - kM[f0 + q]) * kI[f0 + q];
      }
      st8(SQ + lr * T::PAD + f0, x);
      st8(DA + lr * T::PAD + f0, y);
      st8(VV + lr * T::PAD + f0, v);
      st8(SK + lr * T::PAD + f0, k);
    }
    __syncthreads();
    float dsq[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = g + i * T::G;   // the same in every lane of a warp
      dsq[i] = 0.f;
      if (r >= rows) continue;
      const float *dr = DA + r * T::PAD;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DH; j += 4) {
        const float4 dq = *reinterpret_cast<const float4 *>(dr + j);
        s = fmaf(dq.x, crow[j], s);
        s = fmaf(dq.y, crow[j + 1], s);
        s = fmaf(dq.z, crow[j + 2], s);
        s = fmaf(dq.w, crow[j + 3], s);
      }
      dsq[i] = s * a.scale;
      const float part = warp_sum(dsq[i] * SQ[r * T::PAD + col]);
      if (lane == 0) rdot[r][col / 32] = part;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = g + i * T::G;
      if (r >= rows) continue;
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < WPR; ++q) dot += rdot[r][q];
      const float *vr = VV + r * T::PAD;
      float dkf = 0.f;
#pragma unroll
      for (int j = 0; j < DH; j += 4) {
        const float4 vq = *reinterpret_cast<const float4 *>(vr + j);
        dkf = fmaf(vq.x, drow[j], dkf);
        dkf = fmaf(vq.y, drow[j + 1], dkf);
        dkf = fmaf(vq.z, drow[j + 2], dkf);
        dkf = fmaf(vq.w, drow[j + 3], dkf);
      }
      bf16 *out = a.dqkv + (orow + s0 + r) * rs + h * DH + col;
      out[0] = __float2bfloat16(SQ[r * T::PAD + col] * (dsq[i] - dot));
      out[a.d] = __float2bfloat16(SK[r * T::PAD + col] * (dkf - gc));
    }
  }
}

template <int DH>
int launch(const bf16 *qkv, const bf16 *dattn, BandArgs band, Lin lin, int B, int heads,
           cudaStream_t stream) {
  const float scale = rsqrtf((float)DH);
  if (band.nl > 0) {
    band.scale = scale;
    const int err = launch_band<DH>(qkv, dattn, band, B, stream);
    if (err) return err;
  }
  if (heads > band.nl) {
    lin.scale = scale;
    const dim3 grid(lin.C, heads - band.nl, B);
    lin_bwd1<DH><<<grid, LIN_THREADS, 0, stream>>>(lin);
    lin_bwd2<DH><<<grid, LIN_THREADS, 0, stream>>>(lin);
    lin_bwd3<DH><<<grid, LIN_THREADS, 0, stream>>>(lin);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pairs whose linear heads may take more than one chunk (the tickets).
B3_EXPORT int b3_stage3_bwd_lin_max_pairs() { return LIN_MAX_PAIRS; }

// f32 floats of ws a (batch row, linear head) pair at C chunks.
B3_EXPORT int b3_stage3_bwd_ws_floats(int C, int dh) {
  return static_cast<int>(LinWs::floats(C, dh));
}

// qkv (B, L, 3d) bf16, dattn (B, L, d) bf16 → dqkv (B, L, 3d) bf16, all
// 16-byte aligned.  Head dim d / heads must be 32 or 64; with local heads
// L % window == 0.  Scratch (f32): stats (B, local_heads, L, 4); for the
// linear heads ws, b3_stage3_bwd_ws_floats(C, Dh) a (batch row, linear
// head) pair, C = ceil(L / chunk) chunks of `chunk` rows (more than one
// chunk needs B · linear heads <= b3_stage3_bwd_lin_max_pairs()).  Launches: 2
// for the band heads, 3 for the linear heads.
B3_EXPORT int b3_stage3_attention_bwd(const void *qkv, const void *dattn, void *dqkv,
                                      void *stats, void *ws, int B, int L, int d, int heads,
                                      int local_heads, int window, int chunk, void *stream) {
  const bf16 *q = static_cast<const bf16 *>(qkv);
  const bf16 *da = static_cast<const bf16 *>(dattn);
  bf16 *dq = static_cast<bf16 *>(dqkv);
  const int C = chunk > 0 ? (L + chunk - 1) / chunk : 0;
  if (heads < 1 || local_heads < 0 || local_heads > heads || d % heads || C < 1 ||
      (C > 1 && B * (heads - local_heads) > LIN_MAX_PAIRS) ||
      (local_heads > 0 && (window < 1 || L % window)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BandArgs band{dq, static_cast<float4 *>(stats), L, d, heads, local_heads, window, 0.f};
  const Lin lin{q, da, dq, static_cast<float *>(ws), L, d, local_heads, chunk, C, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / heads) {
    case 32: return launch<32>(q, da, band, lin, B, heads, s);
    case 64: return launch<64>(q, da, band, lin, B, heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
