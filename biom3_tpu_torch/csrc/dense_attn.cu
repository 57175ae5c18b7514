// dense_attention: unmasked softmax attention of the BERT text tower, from
// the fused q/k/v projection (B, L, 3E) to the head outputs (B, L, E) —
// (B, L, H, Dh) in and out, Dh 32 or 64.  PAD tokens attend, as the
// reference calls the tower with no attention mask
// (biom3_tpu/models/bert.py:135-137).
//
// Replaces the per-head attention of the TPU kernel
// biom3_tpu/ops/pallas/bert_stack_tpu.py:198 (fused_bert_cls, head_body
// :97-122): s = q·kᵀ·Dh^-0.5, f32 softmax, p rounded to bf16 for p·v.  The
// TPU holds a head's (L, L) scores in VMEM; here they never exist.
//
// Hopper design, esm2_attention's kernel (esm2_attn.cu, attn_hopper.cuh)
// without its staging launch, since no rotary means nothing needs staging:
// * q, k and v are read in place from qkv through one 4-D TMA map (Dh, L,
//   3H, B) with qkv's strides: head h of q is slice h, of k H + h, of v
//   2H + h, since column part·E + h·Dh of a row is (part·H + h)·Dh.  Boxes
//   are (64, 64, 1, 1): a head's rows past L and, for head dim 32, columns
//   32..63 arrive as zeros (the products then run 64 wide on zeros);
// * one block per (128 queries, head, batch row): two consumer warpgroups
//   of 64 queries and a producer warp.  The Q tile arrives once; K and V
//   tiles of 64 keys stream through a 3-stage ring; forward_sweep runs
//   S = Q·Kᵀ and O += P̃·V on wgmma with the online f32 softmax in the
//   accumulator registers, unmasked as flash_attention runs it, keys >= L
//   at −inf;
// * the epilogue writes O / l as bf16 straight into the (B, L, E) output
//   at column h·Dh, the out-projection's input.
// Rounding: the plain version rounds the normalised p to bf16 before p·v;
// the kernel rounds the unnormalised p̃ and divides the f32 sum by l, as
// flash_attention does; both stay well within the smoke test's 2e-2
// relative tolerance.
//
// What bounds it on an H100: 4·L²·Dh FLOP a head on the tensor cores
// against 2·L·Dh·2 bytes of K/V a block: operations; the softmax between
// the two products is what the tensor cores wait on (one warpgroup's
// products and softmax do not overlap; the other warpgroup and the second
// block on the SM fill in).
#include "attn_hopper.cuh"

namespace {

using namespace attn;

constexpr int NWG = 2;                        // consumer warpgroups
constexpr int BQ = 64 * NWG;                  // queries a block
constexpr int STAGES = 3;
constexpr int THREADS = NWG * 128 + 32;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // K, V
constexpr int SMEM = NWG * TILE_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
dense_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv, bf16 *__restrict__ out,
                        int H, int L, int E, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t *sq = smem, *ring = smem + NWG * TILE_BYTES;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * STAGE_BYTES);
  uint64_t *empty = full + STAGES, *qbar = empty + STAGES;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
  const int tiles = (L + TILE - 1) / TILE;

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
        hopper::tma_load_4d(st, &map_qkv, &full[s], 0, t * TILE, H + head, b);
        hopper::tma_load_4d(st + TILE_BYTES, &map_qkv, &full[s], 0, t * TILE, 2 * H + head, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float o[32], l[2];
  mbar_wait(qbar, 0);
  forward_sweep<STAGES, true>(sq + wg * TILE_BYTES, ring, STAGE_BYTES, full, empty, 0, tiles,
                              NoBand{}, nullptr, L, scale, lane, o, l);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * TILE + acc_row(h, warp, lane);
    if (row >= L) continue;
    const float inv = 1.f / l[h];
    bf16 *dst = out + ((size_t)b * L + row) * E + head * DH;
#pragma unroll
    for (int q = 0; q < DH / 8; ++q)
      *reinterpret_cast<__nv_bfloat162 *>(dst + acc_col(q, 0, lane)) =
          __floats2bfloat162_rn(o[4 * q + 2 * h] * inv, o[4 * q + 2 * h + 1] * inv);
  }
}

template <int DH>
int launch(const bf16 *qkv, bf16 *out, int B, int L, int E, int H, cudaStream_t stream) {
  // (Dh, L, 3H, B) with qkv's strides, (64, TILE, 1, 1) boxes
  const uint64_t dims[4] = {(uint64_t)DH, (uint64_t)L, (uint64_t)3 * H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)E * 6, (uint64_t)DH * 2, (uint64_t)L * E * 6};
  const uint32_t box[4] = {64, TILE, 1, 1};
  CUtensorMap map;
  int err = hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, 4, dims, strides,
                                 box);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(dense_attn_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err) return err;
    sized = true;
  }
  dim3 grid((L + BQ - 1) / BQ, H, B);
  dense_attn_wgmma_kernel<DH><<<grid, THREADS, SMEM, stream>>>(map, out, H, L, E,
                                                              1.f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, L, 3E) bf16 [q | k | v]; out: (B, L, E) bf16; both 16-byte
// aligned; E / heads in {32, 64}.
B3_EXPORT int b3_dense_attention(const void *qkv, void *out, int B, int L, int E, int heads,
                                 void *stream) {
  const bf16 *q = static_cast<const bf16 *>(qkv);
  bf16 *o = static_cast<bf16 *>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E / heads) {
    case 32: return launch<32>(q, o, B, L, E, heads, s);
    case 64: return launch<64>(q, o, B, L, E, heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
