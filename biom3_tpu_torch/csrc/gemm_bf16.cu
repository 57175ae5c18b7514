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
// * b3_gemm_dx (input gradient): dX = dY·Wᵀ with W (N, K) row-major, read
//   transposed; optionally times gelu'(h) for an f32 pre-activation h —
//   dh1 = (dY·W2ᵀ)∘gelu'(h1), layer_block_tpu.py:231-235;
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
// gemm_bias_act and gemm_dw run hopper_gemm.cuh's main loop: TMA loads into
// a 3-4 stage ring, no register staging and no __syncthreads; one producer
// warp, one or two consumer warpgroups issuing wgmma m64n128k16 with one
// batch in flight; persistent blocks, two an SM, so loads and one block's
// epilogue overlap the other's products; the epilogue from the accumulator
// registers.  gemm_bias_act reads A K-major and B (the (K, N) weight as it
// lies) MN-major through wgmma's B-transpose bit.  gemm_dw reads both of
// its operands as they lie, MN-major: X's rows run along the reduced dim,
// so each 128-byte TMA row holds 64 output rows of Xᵀ, read through the
// A-transpose bit; dY is read as gemm_bias_act's B.  The TMA zero-fills
// the ragged tail of the rows.  Its split rule and tile come from the
// Python wrapper (ops/kernels.py, gemm_dw_plan); gemm_bias_act's tile
// (128x128 or 64x128) follows M and N (hopper::wide_tile).
//
// gemm_dx stays on the first version's WMMA kernel (gemm_dx_wmma): 16x16x16
// WMMA tiles, A and the transposed W staged through registers into two
// shared buffers (W as it lies, read by a col_major fragment), a
// __syncthreads a K step, ~88-155 TFLOP/s; its epilogue runs per warp
// through a 1 KB shared staging tile (aliased on the A buffers).
#include <mma.h>

#include "hopper_gemm.cuh"

using namespace nvcuda;

// column sums of an f32 (rows, n) matrix into out (n,) (rowwise.cu)
void b3_col_sum_f32(const float *x, int rows, long long n, float *out, float *partial,
                    int parts, cudaStream_t stream);

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int APAD = 8;            // keep rows 16-byte aligned, spread banks
constexpr int THREADS = 256;       // 8 warps: 2 (rows) x 4 (cols), 64x32 each
// bf16 elements of one operand's double buffer
constexpr int TILE_ELEMS = 2 * BM * (BK + APAD);
static_assert(THREADS / 32 * 256 * 4 <= TILE_ELEMS * 2, "staging does not fit the A buffer");

struct Epilogue {
  const float *aux;      // (M, N) f32 pre-activation for ACT_DGELU_*, or null
  int act, out_f32;
};

// C (M, N) = A (M, K) · Wᵀ, W (N, K): both operands' tiles are [rows][BK].
__global__ void __launch_bounds__(THREADS)
gemm_dx_wmma(const bf16 *__restrict__ A, const bf16 *__restrict__ W, void *__restrict__ C,
             int M, int N, int K, Epilogue ep) {
  __shared__ __align__(128) bf16 As[TILE_ELEMS];
  __shared__ __align__(128) bf16 Bs[TILE_ELEMS];
  constexpr int LD = BK + APAD, BUF = BM * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Each thread moves two 16-byte vectors of A and two of W per K step:
  // a 128 x 32 tile is 128 rows of 4 vectors.
  uint4 ra[2], rb[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto load_regs = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * THREADS, r = v >> 2, gc = k0 + (v & 3) * 8;
      ra[s] = (row0 + r < M && gc < K)
                  ? *reinterpret_cast<const uint4 *>(A + (size_t)(row0 + r) * K + gc) : zero;
      rb[s] = (col0 + r < N && gc < K)
                  ? *reinterpret_cast<const uint4 *>(W + (size_t)(col0 + r) * K + gc) : zero;
    }
  };
  auto store_regs = [&](int buf) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * THREADS, i = (v >> 2) * LD + (v & 3) * 8;
      *reinterpret_cast<uint4 *>(&As[buf * BUF + i]) = ra[s];
      *reinterpret_cast<uint4 *>(&Bs[buf * BUF + i]) = rb[s];
    }
  };

  const int KT = (K + BK - 1) / BK;
  if (KT > 0) {
    load_regs(0);
    store_regs(0);
  }
  int buf = 0;
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();
    const bool more = kt + 1 < KT;
    if (more) load_regs((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[buf * BUF + (wm * 64 + i * 16) * LD + kk], LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf * BUF + (wn * 32 + j * 16) * LD + kk], LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more) store_regs(buf ^ 1);
    buf ^= 1;
  }
  __syncthreads();  // every warp is done with As before it becomes staging

  // Epilogue: each lane finishes 8 consecutive columns of one fragment row.
  float *stage = reinterpret_cast<float *>(As) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wm * 64 + i * 16 + er;
      const int gc = col0 + wn * 32 + j * 16 + ec;
      if (gr < M && gc < N) {  // N % 8 == 0, so the 8 columns are all in
        const size_t off = (size_t)gr * N + gc;
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = stage[er * 16 + ec + q];
        if (ep.act >= ACT_DGELU_ERF) {
          const float4 *hp = reinterpret_cast<const float4 *>(ep.aux + off);
          const float4 h0 = hp[0], h1 = hp[1];
          const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] *= gelu_grad(h[q], ep.act);
        }
        if (ep.out_f32) {
          float4 *cp = reinterpret_cast<float4 *>(static_cast<float *>(C) + off);
          cp[0] = make_float4(v[0], v[1], v[2], v[3]);
          cp[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4 *>(static_cast<bf16 *>(C) + off) = pack8(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int BN_, int NWG, int STAGES>
__global__ void __launch_bounds__(hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::THREADS,
                                  hopper::Tile<hopper::Op::BF16, BN_, NWG, STAGES>::MIN_BLOCKS)
gemm_bias_act_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, void *C, int M, int N, int K,
                    int k_chunk, hopper::Epilogue ep) {
  hopper::gemm_body<hopper::Op::BF16, BN_, NWG, STAGES>(&map_a, &map_b, C, M, N, K, k_chunk, ep);
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
// h (M, N) f32.
B3_EXPORT int b3_gemm_dx(const void *dY, const void *W, const void *h, void *dX, int M, int N,
                         int K, int act, int out_f32, void *stream) {
  const Epilogue ep{static_cast<const float *>(h), act, out_f32};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_dx_wmma<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(dY), static_cast<const bf16 *>(W), dX, M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
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
                 static_cast<float *>(dW), nullptr, 1, s);
  return static_cast<int>(cudaGetLastError());
}
