// flash_attention: softmax attention with an optional key-PAD mask on
// separate q, k, v tensors (B, H, L, D) → (B, H, L, D), D 32 or 64.
//
// Replaces the TPU kernel biom3_tpu/ops/pallas/flash_attention_tpu.py:69
// (flash_attention_pallas), which backs attn_impl="pallas:…" of the
// Stage-1 towers' graph path (biom3_tpu/ops/attention.py:44-53): scale
// D^-0.5, -1e9 on PAD keys, online f32 softmax over key tiles.  A batch row
// whose keys are all PAD attends uniformly (the mean of V over its L keys),
// as there.
//
// Hopper design (attn_hopper.cuh): one block per (128 queries, head, batch
// row): two consumer warpgroups of 64 queries and a producer warp.  The Q
// tile arrives once by TMA; K and V tiles of 64 keys stream through a
// 3-stage ring.  S = Q·Kᵀ is a wgmma with both operands in shared memory;
// the online softmax runs on the accumulator registers; P̃ = exp(S − m),
// rounded to bf16, feeds O += P̃·V as register A fragments, V read MN-major.
// Keys >= L (zero-filled by the 3-D maps) score −inf, so an all-PAD row
// averages over its L keys only.  Key tiles past the last non-PAD key are
// skipped when the row has a real key (block_live_keys).  Epilogue O / l →
// bf16, rows < L.
//
// Rounding: the plain version rounds the normalised p to bf16 before P·V;
// the kernel rounds the unnormalised p̃ and divides the f32 sum by l.  Both
// stay well within the smoke test's 2e-2 relative tolerance.
//
// What bounds it on an H100: 4·L·live·D FLOP per head on the tensor cores
// against 2·L·D·2 bytes of K/V per block: operations; the softmax between
// the two products (exp2 on 32 values a thread per tile) is what the
// tensor cores wait on, since one warpgroup's products and softmax do not
// overlap (the other warpgroup and the second block on the SM fill in).
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
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const int *__restrict__ pad,
                        bf16 *__restrict__ out, int H, int L, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t *sq = smem, *ring = smem + NWG * TILE_BYTES;
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + STAGES * STAGE_BYTES);
  uint64_t *empty = full + STAGES, *qbar = empty + STAGES;
  const int b = blockIdx.z, bh = b * H + blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int *key_pad = pad ? pad + (size_t)b * L : nullptr;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrive per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int live = key_pad ? block_live_keys(key_pad, L) : L;  // synchronises the block
  if (!key_pad) __syncthreads();
  const int tiles = (live + TILE - 1) / TILE;

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
        tma_load_3d(st, &map_k, &full[s], 0, t * TILE, bh);
        tma_load_3d(st + TILE_BYTES, &map_v, &full[s], 0, t * TILE, bh);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float o[32], l[2];
  mbar_wait(qbar, 0);
  forward_sweep<STAGES, true>(sq + wg * TILE_BYTES, ring, STAGE_BYTES, full, empty, 0, tiles,
                              NoBand{}, key_pad, L, scale, lane, o, l);
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
int launch(const bf16 *q, const bf16 *k, const bf16 *v, const int *pad, bf16 *out, int B,
           int H, int L, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = encode_heads(&mq, q, DH, L, B * H);
  if (!err) err = encode_heads(&mk, k, DH, L, B * H);
  if (!err) err = encode_heads(&mv, v, DH, L, B * H);
  if (err) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(flash_attn_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err) return err;
    sized = true;
  }
  dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_attn_wgmma_kernel<DH><<<grid, THREADS, SMEM, stream>>>(mq, mk, mv, pad, out, H, L,
                                                              1.f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (B, H, L, D) bf16, 16-byte aligned; pad: (B, L) int32,
// nonzero = PAD, or null for no mask; D in {32, 64}.
B3_EXPORT int b3_flash_attention(const void *q, const void *k, const void *v, const void *pad,
                                 void *out, int B, int H, int L, int D, void *stream) {
  const bf16 *qp = static_cast<const bf16 *>(q), *kp = static_cast<const bf16 *>(k),
             *vp = static_cast<const bf16 *>(v);
  const int *p = static_cast<const int *>(pad);
  bf16 *o = static_cast<bf16 *>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qp, kp, vp, p, o, B, H, L, st);
    case 64: return launch<64>(qp, kp, vp, p, o, B, H, L, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
