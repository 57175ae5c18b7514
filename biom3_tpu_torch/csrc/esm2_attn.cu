// esm2_attention: the rotary, key-masked softmax attention of one ESM2
// layer, from the fused q/k/v projection (B, L, 3E) to the head outputs
// (B, L, E) — (B, L, H, Dh) in and out.
//
// Replaces the per-head attention of the TPU kernel
// biom3_tpu/ops/pallas/esm2_stack_tpu.py:294 (fused_esm2_cls, head_body
// :161-206): GPT-NeoX rotary over the full head dim on q and k in bf16
// with bf16 tables, scale, -1e9 on PAD keys (tokens == pad_idx, :120), f32
// softmax.
//
// One block per (query tile, head, batch row) walks the keys in shared
// tiles with an online f32 softmax (attn_common.cuh), so the (L, L) score
// matrix of the TPU kernel never exists.  q is rotated once as it is
// loaded into registers; each K tile is rotated as it is staged (each
// staging thread also reads the partner half of its row).  What bounds
// it: 4·L·live·Dh FLOP per head on CUDA cores, where live is one past the
// last non-PAD key — the PAD tail of a padded protein is skipped (exact:
// see live_keys), which at the reference's pad-to-1024 is most of the
// keys of a short sequence.  The tensor-core (mma) form is later work.
#include "attn_common.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(512 * 32 / DH)
esm2_attn_kernel(const bf16 *__restrict__ qkv, const int *__restrict__ pad,
                 const bf16 *__restrict__ cos, const bf16 *__restrict__ sin,
                 bf16 *__restrict__ out, int L, int E, int tq) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * tq;
  const int *key_pad = pad + (size_t)b * L;
  const int live = b3::live_keys(key_pad, L);
  const bf16 *base = qkv + (size_t)b * L * 3 * E + h * DH;
  const b3::Heads a{base, base + E, base + 2 * E, 3 * E, 3 * E, key_pad, cos, sin,
                    out + (size_t)b * L * E + h * DH, E};
  b3::attend_range<DH, true>(a, q0, min(L, q0 + tq), 0, live, rsqrtf((float)DH));
}

template <int DH>
int launch(const bf16 *qkv, const int *pad, const bf16 *cos, const bf16 *sin, bf16 *out,
           int B, int L, int E, int heads, cudaStream_t stream) {
  const int tq = 512 * 32 / DH / b3::S;  // 512 threads at Dh 32, 256 at Dh 64
  dim3 grid((L + tq - 1) / tq, heads, B);
  esm2_attn_kernel<DH><<<grid, tq * b3::S, 0, stream>>>(qkv, pad, cos, sin, out, L, E, tq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, L, 3E) bf16 [q | k | v]; pad: (B, L) int32, nonzero = PAD;
// cos, sin: (L, E / heads) bf16; out: (B, L, E) bf16; E / heads in {32, 64}.
B3_EXPORT int b3_esm2_attention(const void *qkv, const void *pad, const void *cos,
                                const void *sin, void *out, int B, int L, int E, int heads,
                                void *stream) {
  const bf16 *q = static_cast<const bf16 *>(qkv);
  const int *p = static_cast<const int *>(pad);
  const bf16 *c = static_cast<const bf16 *>(cos), *s = static_cast<const bf16 *>(sin);
  bf16 *o = static_cast<bf16 *>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E / heads) {
    case 32: return launch<32>(q, p, c, s, o, B, L, E, heads, st);
    case 64: return launch<64>(q, p, c, s, o, B, L, E, heads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
