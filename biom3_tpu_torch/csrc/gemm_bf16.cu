// gemm_bf16: C = op(A)·op(B) on bf16 tensor cores, with a fused epilogue.
//
// Replaces the in-kernel matrix products of the TPU kernels
// (biom3_tpu/ops/pallas/stack_kernel_tpu.py:765 fused_stack_logits,
// fused_layer_tpu.py:186/269 fused_attn_half/fused_ff_half,
// bert_stack_tpu.py:198 fused_bert_cls, esm2_stack_tpu.py:294
// fused_esm2_cls, and the training blocks attn_block_tpu.py:343/379,
// layer_block_tpu.py:382/419 and esm2_block_tpu.py:380/411/524/547).  Three
// entry points:
//
// * b3_gemm_bias_act (forward): act(A·B + bias) + residual, A (M, K) and
//   B (K, N) row-major — the JAX package's (d_in, d_out) layout — with an
//   optional f32 copy of the pre-activation (the FF backward needs it);
// * b3_gemm_dx (input gradient): dX = dY·Wᵀ with W (N, K) row-major — the
//   forward's (d_in, d_out) weight as it lies; optionally times gelu'(h)
//   for an f32 pre-activation h — dh1 = (dY·W2ᵀ)∘gelu'(h1),
//   layer_block_tpu.py:231-235;
// * b3_gemm_dw (weight gradient): dW = Xᵀ·dY with X (K, M) row-major, read
//   transposed, f32 out.  K = B·L rows sum the batch, as the TPU's
//   sequential grid accumulates it (layer_block_tpu.py:180-192); the K
//   loop is split across blocks (split-K) so the few output tiles of a
//   512 x 512 gradient still fill the card, and the f32 partials are summed
//   in a fixed order by col_sum (rowwise.cu) — deterministic, no atomics.
//
// What bounds it on an H100: the products of the main path (M = B·L = 2048
// to 32768 rows, K and N of 512 to 5120) do 2·K operations per output
// element against K·2 bytes a row of A and 2-4 bytes an output: a Stage-3
// layer's products sit at ~250-600 operations a byte, around the card's
// ~295 bf16 ridge, so at B = 4 bytes and tensor cores bound them about
// equally and at B = 32 (and for the wide ESM2 products) the tensor cores
// do.  A weight gradient reduces over the B·L rows: 2·rows operations per
// f32 output against 2 bytes a row of each operand, operations bound.
//
// All three run hopper_gemm.cuh's main loop: TMA loads into a 3-4 stage
// ring, no register staging and no __syncthreads; one producer warp, one
// or two consumer warpgroups issuing wgmma m64n128k16 with one batch in
// flight; persistent blocks, two an SM, so loads and one block's epilogue
// overlap the other's products; the epilogue from the accumulator
// registers.  gemm_bias_act reads A K-major and B (the (K, N) weight as it
// lies) MN-major through wgmma's B-transpose bit.  gemm_dx reads both
// operands K-major as they lie, the int8 kernel's layout in bf16: dY as
// gemm_bias_act's A, W (N, K) in (128, 64) boxes of 128-byte rows along
// the reduced dim; its epilogue multiplies by gelu'(h), h read as the
// residual.  The reduced dim is d_out (8-80 k-tiles), so it is never split:
// one pass, no atomics, the same bits every call.  gemm_dw reads both of
// its operands as they lie, MN-major: X's rows run along the reduced dim,
// so each 128-byte TMA row holds 64 output rows of Xᵀ, read through the
// A-transpose bit; dY is read as gemm_bias_act's B.  The TMA zero-fills
// the ragged tail of the rows.  gemm_dw's split rule and tile come from the
// Python wrapper (ops/kernels.py, gemm_dw_plan), and so does gemm_dx's
// tile (gemm_dx_plan); gemm_bias_act's tile (128x128 or 64x128) follows M
// and N (hopper::wide_tile).
#include "hopper_gemm.cuh"

// column sums of an f32 (rows, n) matrix into out (n,), in a fixed order
// (rowwise.cu)
void b3_col_sum_f32(const float *x, int rows, long long n, float *out, cudaStream_t stream);

namespace {

template <int BN_, int NWG, int STAGES>
__global__ void __launch_bounds__(hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::THREADS,
                                  hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::MIN_BLOCKS)
gemm_bias_act_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, void *C, int M, int N, int K,
                    int k_chunk, hopper::Epilogue ep) {
  hopper::gemm_body<hopper::Op::BF16, BN_, NWG, STAGES>(&map_a, &map_b, C, M, N, K, k_chunk, ep);
}

// dY·Wᵀ: map_b loads W (N, K), a K-major B.
template <int BN_, int NWG, int STAGES>
__global__ void __launch_bounds__(hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::THREADS,
                                  hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::MIN_BLOCKS)
gemm_dx_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              void *C, int M, int N, int K, int k_chunk, hopper::Epilogue ep) {
  hopper::gemm_body<hopper::Op::BF16, BN_, NWG, STAGES, false, true>(&map_a, &map_b, C, M, N, K,
                                                                     k_chunk, ep);
}

// Xᵀ·dY: map_a loads X (K, M), the transposed A.
template <int BN_, int NWG, int STAGES>
__global__ void __launch_bounds__(hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::THREADS,
                                  hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::MIN_BLOCKS)
gemm_dw_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              void *C, int M, int N, int K, int k_chunk, hopper::Epilogue ep) {
  hopper::gemm_body<hopper::Op::BF16, BN_, NWG, STAGES, true>(&map_a, &map_b, C, M, N, K, k_chunk,
                                                              ep);
}

}  // namespace

// All three require K % 8 == 0 and N % 8 == 0 (for dw M % 8 == 0 and N %
// 8 == 0, any K) and 16-byte aligned, contiguous operands (checked by the
// Python wrappers).
B3_EXPORT int b3_gemm_bias_act(const void *A, const void *B, const void *bias,
                               const void *residual, void *pre, void *C, int M, int N, int K,
                               int act, int res_bf16, int out_f32, void *stream) {
  using hopper::Op;
  const hopper::Epilogue ep{nullptr, nullptr, static_cast<const float *>(bias), residual,
                            static_cast<float *>(pre), act, res_bf16, out_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper::wide_tile(M, N))
    return hopper::launch<Op::BF16, 128, 2, 3>(gemm_bias_act_wgmma<128, 2, 3>, A, B, C, M, N, K,
                                               ep, s);
  return hopper::launch<Op::BF16, 128, 1, 4>(gemm_bias_act_wgmma<128, 1, 4>, A, B, C, M, N, K, ep,
                                             s);
}

// dX (M, N) = dY (M, K) · Wᵀ, W (N, K); act: ACT_NONE or ACT_DGELU_* with
// h (M, N) f32; tiles of 128 (wide) or 64 rows.
B3_EXPORT int b3_gemm_dx(const void *dY, const void *W, const void *h, void *dX, int M, int N,
                         int K, int act, int out_f32, int wide, void *stream) {
  using hopper::Op;
  const hopper::Epilogue ep{nullptr, nullptr, nullptr, h, nullptr, h ? act : ACT_NONE, 0,
                            out_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    return hopper::launch<Op::BF16, 128, 2, 3, false, true>(gemm_dx_wgmma<128, 2, 3>, dY, W, dX,
                                                            M, N, K, ep, s);
  return hopper::launch<Op::BF16, 128, 1, 4, false, true>(gemm_dx_wgmma<128, 1, 4>, dY, W, dX, M,
                                                          N, K, ep, s);
}

// dW (M, N) f32 = Xᵀ · dY with X (K, M), dY (K, N), the K rows cut into
// splits of k_chunk rows (a multiple of 64, or K) on tiles of 128 (wide) or
// 64 rows.  With more than one split, ws holds splits x M x N f32
// partials, summed in split order into dW.
B3_EXPORT int b3_gemm_dw(const void *X, const void *dY, void *dW, void *ws, int M, int N, int K,
                         int k_chunk, int wide, void *stream) {
  using hopper::Op;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hopper::Epilogue ep{nullptr, nullptr, nullptr, nullptr, nullptr, ACT_NONE, 0, 1};
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k_chunk <= 0 || k_chunk > K) k_chunk = K;
  const int splits = (K + k_chunk - 1) / k_chunk;
  void *out = splits > 1 ? ws : dW;
  const int err =
      wide ? hopper::launch<Op::BF16, 128, 2, 3, true>(gemm_dw_wgmma<128, 2, 3>, X, dY, out, M, N,
                                                       K, ep, s, k_chunk)
           : hopper::launch<Op::BF16, 128, 1, 4, true>(gemm_dw_wgmma<128, 1, 4>, X, dY, out, M, N,
                                                       K, ep, s, k_chunk);
  if (err || splits == 1) return err;
  b3_col_sum_f32(static_cast<const float *>(ws), splits, (long long)M * N,
                 static_cast<float *>(dW), s);
  return static_cast<int>(cudaGetLastError());
}
