// gemm_bias_act: C = act(A·B + bias) + residual on bf16 tensor cores.
//
// Replaces the in-kernel matrix products of the TPU kernels
// (biom3_tpu/ops/pallas/stack_kernel_tpu.py:765 fused_stack_logits,
// fused_layer_tpu.py:186/269 fused_attn_half/fused_ff_half,
// bert_stack_tpu.py:198 fused_bert_cls): the fused q/k/v projection, the
// out-projection with its bias and residual, and the FF pair W1+bias+GELU,
// W2+bias+residual.  A is (M, K) row-major, B is (K, N) row-major — the
// JAX package's (d_in, d_out) layout — both bf16; sums are f32.
//
// What bounds it on an H100: at the main path's shapes (M = B·L = 2048 to
// 4096 rows, K and N of 512 to 3072) every product is well above the
// card's ~295 FLOP/byte ridge, so it is tensor-core bound.  This first
// version uses WMMA 16x16x16 bf16 tiles (mma.sync underneath) in a
// 128x128x32 block tile with register-staged double buffering: one
// __syncthreads per K step, global loads of step k+1 in flight while the
// tensor cores work on step k.  The epilogue runs per warp through a
// 1 KB shared staging tile so bias, GELU, residual and the output cast
// cost no extra pass over device memory.  wgmma/TMA is later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int APAD = 8, BPAD = 8;  // keep rows 16-byte aligned, spread banks
constexpr int THREADS = 256;       // 8 warps: 2 (rows) x 4 (cols), 64x32 each

__global__ void __launch_bounds__(THREADS)
gemm_bias_act_kernel(const bf16 *__restrict__ A, const bf16 *__restrict__ B,
                     const float *__restrict__ bias, const void *__restrict__ residual,
                     void *__restrict__ C, int M, int N, int K, int act,
                     int res_bf16, int out_f32) {
  __shared__ __align__(128) bf16 As[2][BM][BK + APAD];
  __shared__ __align__(128) bf16 Bs[2][BK][BN + BPAD];
  __shared__ __align__(128) float Cs[THREADS / 32][16][16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Each thread moves two 16-byte vectors of A and two of B per K step.
  uint4 ra[2], rb[2];
  auto load_regs = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * THREADS;
      int r = v >> 2, c = (v & 3) * 8;  // A tile: 128 rows x 4 vectors
      int gr = row0 + r, gc = k0 + c;
      ra[s] = (gr < M && gc < K)
                  ? *reinterpret_cast<const uint4 *>(A + (size_t)gr * K + gc)
                  : make_uint4(0, 0, 0, 0);
      int br = v >> 4, bc = (v & 15) * 8;  // B tile: 32 rows x 16 vectors
      int gbr = k0 + br, gbc = col0 + bc;
      rb[s] = (gbr < K && gbc < N)
                  ? *reinterpret_cast<const uint4 *>(B + (size_t)gbr * N + gbc)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_regs = [&](int buf) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * THREADS;
      *reinterpret_cast<uint4 *>(&As[buf][v >> 2][(v & 3) * 8]) = ra[s];
      *reinterpret_cast<uint4 *>(&Bs[buf][v >> 4][(v & 15) * 8]) = rb[s];
    }
  };

  const int KT = (K + BK - 1) / BK;
  load_regs(0);
  store_regs(0);
  int buf = 0;
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();
    const bool more = kt + 1 < KT;
    if (more) load_regs((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[buf][wm * 64 + i * 16][kk], BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf][kk][wn * 32 + j * 16], BN + BPAD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more) store_regs(buf ^ 1);
    buf ^= 1;
  }

  // Epilogue: each lane finishes 8 consecutive columns of one fragment row.
  float *stage = &Cs[warp][0][0];
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
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float x = stage[er * 16 + ec + q];
          if (bias) x += bias[gc + q];
          v[q] = apply_act(x, act);
        }
        const size_t off = (size_t)gr * N + gc;
        if (residual) {
          if (res_bf16) {
            float r[8];
            unpack8(*reinterpret_cast<const uint4 *>(
                        static_cast<const bf16 *>(residual) + off), r);
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] += r[q];
          } else {
            const float4 *rp =
                reinterpret_cast<const float4 *>(static_cast<const float *>(residual) + off);
            float4 r0 = rp[0], r1 = rp[1];
            v[0] += r0.x; v[1] += r0.y; v[2] += r0.z; v[3] += r0.w;
            v[4] += r1.x; v[5] += r1.y; v[6] += r1.z; v[7] += r1.w;
          }
        }
        if (out_f32) {
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

}  // namespace

// Requires K % 8 == 0 and N % 8 == 0 and 16-byte aligned, contiguous
// operands (checked by the Python wrapper).
B3_EXPORT int b3_gemm_bias_act(const void *A, const void *B, const void *bias,
                               const void *residual, void *C, int M, int N, int K,
                               int act, int res_bf16, int out_f32, void *stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_act_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16 *>(A), static_cast<const bf16 *>(B),
      static_cast<const float *>(bias), residual, C, M, N, K, act, res_bf16, out_f32);
  return static_cast<int>(cudaGetLastError());
}
