// flash_attention: softmax attention with an optional key-PAD mask on
// separate q, k, v tensors (B, H, L, D) → (B, H, L, D).
//
// Replaces the TPU kernel biom3_tpu/ops/pallas/flash_attention_tpu.py:69
// (flash_attention_pallas), which backs attn_impl="pallas:…" of the
// Stage-1 towers' graph path (biom3_tpu/ops/attention.py:44-53): scale,
// -1e9 on PAD keys, online f32 softmax over key tiles.  A batch row whose
// keys are all PAD attends uniformly (the mean of V), as there.
//
// One block per (query tile, head, batch row) streams the keys through
// shared memory with the online softmax of attn_common.cuh.  Key tiles
// past the last non-PAD key are skipped only when the row has a real key
// (live_keys), where their weight is exactly 0.  What bounds it: 4·L²·D
// FLOP per head on CUDA cores against 2·L·D·2 bytes of K/V per block —
// compute bound; the tensor-core (mma) form is later work.
#include "attn_common.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(512 * 32 / DH)
flash_attn_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k,
                  const bf16 *__restrict__ v, const int *__restrict__ pad,
                  bf16 *__restrict__ out, int H, int L, int tq) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * tq;
  const size_t head = ((size_t)b * H + h) * L * DH;
  const int *key_pad = pad ? pad + (size_t)b * L : nullptr;
  const int live = key_pad ? b3::live_keys(key_pad, L) : L;
  const b3::Heads a{q + head, k + head, v + head, DH, DH, key_pad, nullptr, nullptr,
                    out + head, DH};
  b3::attend_range<DH>(a, q0, min(L, q0 + tq), 0, live, rsqrtf((float)DH));
}

template <int DH>
int launch(const bf16 *q, const bf16 *k, const bf16 *v, const int *pad, bf16 *out, int B,
           int H, int L, cudaStream_t stream) {
  const int tq = 512 * 32 / DH / b3::S;  // 512 threads at D 32, 256 at D 64
  dim3 grid((L + tq - 1) / tq, H, B);
  flash_attn_kernel<DH><<<grid, tq * b3::S, 0, stream>>>(q, k, v, pad, out, H, L, tq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (B, H, L, D) bf16; pad: (B, L) int32, nonzero = PAD, or
// null for no mask; D in {32, 64}.
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
