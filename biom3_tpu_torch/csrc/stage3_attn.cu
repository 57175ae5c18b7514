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
// Linear heads, on CUDA cores with the sequence split across blocks
// (stage3_linear.cuh): their softmax statistics and ctx in two launches,
// then their output rows as extra blocks of the band heads' grid.
//
// What bounds it on an H100: the bytes.  The band heads read their q, k, v
// once a block, 12·W·Dh FLOP a query row on the tensor cores; the linear
// heads are 4·L·Dh² FLOP a head against 8·L·Dh bytes.  The whole function
// reads qkv once and writes the output once; k is read twice, the second
// time mostly from L2.
#include "attn_hopper.cuh"
#include "stage3_linear.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------- band heads

constexpr int NWG = 2;                        // consumer warpgroups
constexpr int BQ = 64 * NWG;                  // queries (or linear rows) a block
constexpr int STAGES = 3;
constexpr int THREADS = NWG * 128 + 32;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // K, V
constexpr int SMEM = NWG * TILE_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;
static_assert(BQ == LIN_BQ, "a linear output tile is a band block's rows");

// Grid (ceil(L / BQ) · local + ceil(L / lrows) · (H − local), B): in each
// batch row first the band heads' blocks, 128 queries of one local head
// each; then the linear heads' output rows, lrows rows (a multiple of BQ)
// of one linear head a block (linear_rows).
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
stage3_local_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          const bf16 *__restrict__ qkv, const float *__restrict__ ctx,
                          bf16 *__restrict__ out, int H, int L, int d, int local, int window,
                          int lrows, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int qtiles = (L + BQ - 1) / BQ, b = blockIdx.y, bx = blockIdx.x;
  if (bx >= qtiles * local) {
    const int j = bx - qtiles * local, ltiles = (L + lrows - 1) / lrows;
    const int ng = H - local, head = local + j / ltiles, r0 = (j % ltiles) * lrows;
    linear_rows<DH, THREADS>(smem, qkv, ctx + ((size_t)b * ng + head - local) * DH * DH, out, b,
                             head, r0, min(L, r0 + lrows), L, d);
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
           int window, int chunks, int per, int srows, int lrows, cudaStream_t stream) {
  const int ng = heads - local;
  int err = launch_linear_ctx<DH>(qkv, ws, B, L, d, heads, local, chunks, per, srows, lrows,
                                  stream);
  if (err) return err;
  // (Dh, L, 3H, B) with qkv's strides, (64, TILE, 1, 1) boxes
  const uint64_t dims[4] = {(uint64_t)DH, (uint64_t)L, (uint64_t)3 * heads, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)d * 6, (uint64_t)DH * 2, (uint64_t)L * d * 6};
  const uint32_t box[4] = {64, TILE, 1, 1};
  CUtensorMap map;
  err = hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, 4, dims, strides, box);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(stage3_local_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err) return err;
    sized = true;
  }
  const float *ctx = ng > 0 ? LinWs(ws, B * ng, L, DH).ctx : nullptr;
  const dim3 grid((L + BQ - 1) / BQ * local + (ng > 0 ? (L + lrows - 1) / lrows * ng : 0), B);
  stage3_local_wgmma_kernel<DH><<<grid, THREADS, SMEM, stream>>>(
      map, qkv, ctx, out, heads, L, d, local, window, lrows, 1.f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
                        s);
    case 64:
      return launch<64>(q, o, w, B, L, d, heads, local_heads, window, chunks, per, srows, lrows,
                        s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
