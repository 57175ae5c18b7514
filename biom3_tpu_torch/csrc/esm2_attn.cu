// esm2_attention: the rotary, key-masked softmax attention of one ESM2
// layer, from the fused q/k/v projection (B, L, 3E) to the head outputs
// (B, L, E) — (B, L, H, Dh) in and out, Dh 32 or 64.
//
// Replaces the per-head attention of the TPU kernel
// biom3_tpu/ops/pallas/esm2_stack_tpu.py:294 (fused_esm2_cls, head_body
// :161-206): GPT-NeoX rotary over the full head dim on q and k in bf16
// with bf16 tables, s = q·kᵀ·Dh^-0.5 with −1e9 added on PAD keys
// (tokens == pad_idx, :120, :198), f32 softmax, p rounded to bf16 for p·v.
// The TPU holds a head's (L, L) scores in VMEM; here they never exist.
//
// Hopper design, the flash_attention kernel's (flash_attn.cu,
// attn_hopper.cuh) behind a staging launch:
// * esm2_rope.cuh's staging launch writes rotated q and k (rope8's
//   rounding) into a bf16 scratch (2, B, H, L, Dh), one head's rows
//   contiguous (the TMA cannot rotate); v is read in place from qkv
//   through a 4-D map (Dh, L, H, B), so a head's rows past L zero-fill;
// * one block per (128 queries, head, batch row): two consumer warpgroups
//   of 64 queries and a producer warp.  The Q tile arrives once by TMA; K
//   and V tiles of 64 keys stream through a 3-stage ring; forward_sweep
//   runs S = Q·Kᵀ and O += P̃·V on wgmma with the online f32 softmax in the
//   accumulator registers, PAD keys at score + (−1e9) as the TPU kernel
//   adds its pad bias (an all-PAD row's scores all round to −1e9: it
//   attends uniformly, as there and as the backward recomputes it), keys
//   >= L at −inf;
// * key tiles past the row's last non-PAD key are skipped when the row has
//   a real key (block_live_keys: exact, a −1e9 key's weight is 0 in f32);
// * the epilogue writes O / l as bf16 straight into the (B, L, E) output
//   at column h·Dh, the out-projection's input.
// Head dim 32 runs as zero-filled 64-wide tiles.
//
// What bounds it on an H100: 4·Dh FLOP a (query, live key) pair on the
// tensor cores against 2·L·Dh·2 bytes of K/V a block: operations; the
// softmax between the two products is what the tensor cores wait on (one
// warpgroup's products and softmax do not overlap; the other warpgroup and
// the second block on the SM fill in).  The staging adds a read of q and k
// and a write and read of the scratch: bytes.
#include "attn_hopper.cuh"
#include "esm2_rope.cuh"

namespace {

using namespace attn;

constexpr int NWG = 2;                        // consumer warpgroups
constexpr int BQ = 64 * NWG;                  // queries a block
constexpr int STAGES = 3;
constexpr int THREADS = NWG * 128 + 32;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // K, V
constexpr int SMEM = NWG * TILE_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;

// qkv (B, L, 3E) → ops (2, B, H, L, DH): rotated q, rotated k.
template <int DH>
__global__ void __launch_bounds__(256)
esm2_attn_stage_kernel(const bf16 *__restrict__ qkv, const bf16 *__restrict__ cos,
                       const bf16 *__restrict__ sin, bf16 *__restrict__ ops, int B, int L, int E,
                       int H) {
  stage_operands<DH>(qkv, nullptr, cos, sin, ops, 2, B, L, E, H);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
esm2_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_qk,
                       const __grid_constant__ CUtensorMap map_v, const int *__restrict__ pad,
                       bf16 *__restrict__ out, int H, int L, int E, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t *sq = smem, *ring = smem + NWG * TILE_BYTES;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * STAGE_BYTES);
  uint64_t *empty = full + STAGES, *qbar = empty + STAGES;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * BQ;
  const int bh = b * H + head, BH = gridDim.z * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int *key_pad = pad + (size_t)b * L;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrive per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int live = block_live_keys(key_pad, L);  // synchronises the block
  const int tiles = (live + TILE - 1) / TILE;

  if (warp == NWG * 4) {  // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, NWG * TILE_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
        tma_load_3d(sq + w * TILE_BYTES, &map_qk, qbar, 0, q0 + w * TILE, OP_Q * BH + bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        uint8_t *st = ring + s * STAGE_BYTES;
        tma_load_3d(st, &map_qk, &full[s], 0, t * TILE, OP_K * BH + bh);
        hopper::tma_load_4d(st + TILE_BYTES, &map_v, &full[s], 0, t * TILE, head, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float o[32], l[2];
  mbar_wait(qbar, 0);
  forward_sweep<STAGES, false>(sq + wg * TILE_BYTES, ring, STAGE_BYTES, full, empty, 0, tiles,
                               NoBand{}, key_pad, L, scale, lane, o, l);
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
int launch(const bf16 *qkv, const int *pad, const bf16 *cos, const bf16 *sin, bf16 *out,
           bf16 *ops, int B, int L, int E, int H, cudaStream_t stream) {
  esm2_attn_stage_kernel<DH><<<stage_grid(B, L, E, 2), 256, 0, stream>>>(qkv, cos, sin, ops, B,
                                                                         L, E, H);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  CUtensorMap mqk, mv;
  err = encode_heads(&mqk, ops, DH, L, 2 * B * H);
  if (err) return err;
  // v in place: (Dh, L, H, B) with qkv's strides, (64, TILE, 1, 1) boxes
  const uint64_t dims[4] = {(uint64_t)DH, (uint64_t)L, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)E * 6, (uint64_t)DH * 2, (uint64_t)L * E * 6};
  const uint32_t box[4] = {64, TILE, 1, 1};
  err = hopper::encode_tiled(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv + 2 * E, 4, dims, strides,
                             box);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(esm2_attn_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err) return err;
    sized = true;
  }
  dim3 grid((L + BQ - 1) / BQ, H, B);
  esm2_attn_wgmma_kernel<DH><<<grid, THREADS, SMEM, stream>>>(mqk, mv, pad, out, H, L, E,
                                                             1.f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, L, 3E) bf16 [q | k | v]; pad: (B, L) int32, nonzero = PAD;
// cos, sin: (L, E / heads) bf16; out: (B, L, E) bf16; scratch ops: (2, B,
// heads, L, E / heads) bf16; every pointer 16-byte aligned; E / heads in
// {32, 64}.
B3_EXPORT int b3_esm2_attention(const void *qkv, const void *pad, const void *cos,
                                const void *sin, void *out, void *ops, int B, int L, int E,
                                int heads, void *stream) {
  const bf16 *q = static_cast<const bf16 *>(qkv);
  const int *p = static_cast<const int *>(pad);
  const bf16 *c = static_cast<const bf16 *>(cos), *s = static_cast<const bf16 *>(sin);
  bf16 *o = static_cast<bf16 *>(out), *scratch = static_cast<bf16 *>(ops);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E / heads) {
    case 32: return launch<32>(q, p, c, s, o, scratch, B, L, E, heads, st);
    case 64: return launch<64>(q, p, c, s, o, scratch, B, L, E, heads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
