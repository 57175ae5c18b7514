// gemm_i8: C = epilogue(A · Wᵀ) on the int8 tensor cores, the dequantising
// product of the int8 serving recipe (biom3_tpu/ops/pallas/quant.py:3-14).
//
// Replaces the int8 matrix products inside the TPU kernels
// biom3_tpu/ops/pallas/stack_kernel_tpu.py:765 (fused_stack_logits, FF
// :474-486 and projections :77-84, :353-359), bert_stack_tpu.py:198
// (fused_bert_cls, :75-95, :126-158) and esm2_stack_tpu.py:294
// (fused_esm2_cls, :126-147, :239-257): A (M, K) int8 activation codes with
// one f32 scale per row (quant_rows, rowwise.cu), W (N, K) int8 weight codes
// with one f32 scale per output channel (ops/quant.py), int32 accumulation,
// and one epilogue
//
//   f32(acc) · a[m] · s[n] + bias[n] → none / erf / tanh GELU → + residual
//   → bf16 or f32
//
// as gemm_bias_act's (gemm_bf16.cu).
//
// What bounds it on an H100: a Stage-3 layer's four products do 2·K
// operations per output element but read K code bytes per row and write
// and read 2-4 bytes per output element (f32 outputs and residuals): 114
// (K = N = 512, f32 out and residual) to 400 (K = 2048) operations a byte,
// under the int8 ridge of ~590 at every batch, so bytes bound them; the
// wide ESM2 products sit near the ridge.  The first version (mma.sync
// m16n8k32 tiles fed through registers, two stages, a __syncthreads a K
// step) reached 135 TOP/s, 15 % of its byte bound at Stage-3 B = 4.
//
// This version is hopper_gemm.cuh's main loop: W is stored (N, K), K
// contiguous, which is the only layout wgmma takes for s8, so both operands
// load by TMA as K-major 128-byte rows into a 3-4 stage ring, and the
// consumer warpgroups issue wgmma m64n128k32 s32.s8.s8 with one batch in
// flight, so the loads of later k-tiles and the products of this one
// overlap with no register staging; persistent blocks, two an SM, overlap
// one block's epilogue with the other's products.  The tile (128x128 or
// 64x128, hopper::wide_tile) follows M and N, so the N = 512 products and
// the B = 2-4 batches still cover the SMs.
#include "hopper_gemm.cuh"

namespace {

using hopper::Op;

template <int BN, int NWG, int STAGES>
__global__ void __launch_bounds__(hopper::Tile<Op::S8, BN, NWG, STAGES>::THREADS,
                                  hopper::Tile<Op::S8, BN, NWG, STAGES>::MIN_BLOCKS)
gemm_i8_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
              void *C, int M, int N, int K, int k_chunk, hopper::Epilogue ep) {
  hopper::gemm_body<Op::S8, BN, NWG, STAGES>(&map_a, &map_w, C, M, N, K, k_chunk, ep);
}

}  // namespace

// A (M, K) int8, a_scale (M,) f32, W (N, K) int8, w_scale (N,) f32, bias
// (N,) f32 or null, residual (M, N) f32 or bf16 or null → C (M, N) f32 or
// bf16.  K % 32 == 0, N % 8 == 0, 16-byte aligned contiguous operands
// (checked by the Python wrapper).
B3_EXPORT int b3_gemm_i8(const void *A, const void *a_scale, const void *W, const void *w_scale,
                         const void *bias, const void *residual, void *C, int M, int N, int K,
                         int act, int res_bf16, int out_f32, void *stream) {
  const hopper::Epilogue ep{static_cast<const float *>(a_scale),
                            static_cast<const float *>(w_scale),
                            static_cast<const float *>(bias),
                            residual,
                            nullptr,
                            act,
                            res_bf16,
                            out_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper::wide_tile(M, N))
    return hopper::launch<Op::S8, 128, 2, 3>(gemm_i8_wgmma<128, 2, 3>, A, W, C, M, N, K, ep, s);
  return hopper::launch<Op::S8, 128, 1, 4>(gemm_i8_wgmma<128, 1, 4>, A, W, C, M, N, K, ep, s);
}
