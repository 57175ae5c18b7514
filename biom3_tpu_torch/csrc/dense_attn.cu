// dense_attention: unmasked softmax attention of the BERT text tower, from
// the fused q/k/v projection (B, L, 3E) to the head outputs (B, L, E) —
// (B, L, H, Dh) in and out.  PAD tokens attend, as the reference calls the
// tower with no attention mask (biom3_tpu/models/bert.py:136-137).
//
// Replaces the per-head attention of the TPU kernel
// biom3_tpu/ops/pallas/bert_stack_tpu.py:198 (fused_bert_cls, head_body
// :97-122).
//
// One block per (query tile, head, batch row) walks all L keys in shared
// tiles with an online f32 softmax (attn_common.cuh), so the (L, L) score
// matrix of the TPU kernel never exists.  What bounds it: 4·L²·Dh FLOP
// per head on CUDA cores against 2·L·Dh·2 bytes of K/V per block — compute
// bound; the tensor-core (mma) form of the two products is later work.
#include "attn_common.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(512 * 32 / DH)
dense_attn_kernel(const bf16 *__restrict__ qkv, bf16 *__restrict__ out, int L, int E,
                  int tq) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * tq;
  const bf16 *base = qkv + (size_t)b * L * 3 * E + h * DH;
  const b3::Heads a{base, base + E, base + 2 * E, 3 * E, 3 * E, nullptr, nullptr, nullptr,
                    out + (size_t)b * L * E + h * DH, E};
  b3::attend_range<DH>(a, q0, min(L, q0 + tq), 0, L, rsqrtf((float)DH));
}

template <int DH>
int launch(const bf16 *qkv, bf16 *out, int B, int L, int E, int heads,
           cudaStream_t stream) {
  const int tq = 512 * 32 / DH / b3::S;  // 512 threads at Dh 32, 256 at Dh 64
  dim3 grid((L + tq - 1) / tq, heads, B);
  dense_attn_kernel<DH><<<grid, tq * b3::S, 0, stream>>>(qkv, out, L, E, tq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, L, 3E) bf16 [q | k | v]; out: (B, L, E) bf16; E / heads in {32, 64}.
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
