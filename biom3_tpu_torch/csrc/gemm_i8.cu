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
// as gemm_bias_act's (gemm_bf16.cu).  W is stored (N, K), K contiguous: the
// "col" operand of mma.sync.m16n8k32.row.col.s32.s8.s8.s32 then loads as
// 32-bit words straight from shared memory.
//
// What bounds it on an H100: at the serving shapes (M = B·L = 2048 to 32768
// rows, K and N of 512 to 5120) the products sit above the int8 ridge of
// ~590 operations per byte, so the tensor cores bound it.  This first
// version is a 128x128x64 block tile of mma.sync (8 warps, 64x32 each, 16
// m16n8k32 products per warp per 32-deep slice) with register-staged double
// buffering, one __syncthreads per K step, and rows padded to 80 bytes so
// the fragment loads of a warp fall in 32 distinct banks.  The epilogue
// works from the accumulator registers (two adjacent columns a lane).  The
// TMA/wgmma s8 form is later work.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // BK in bytes (= int8 elements)
constexpr int LDS = BK + 16;                // padded shared row: 80 bytes
constexpr int THREADS = 256;                // 8 warps: 2 (rows) x 4 (cols)

struct Epilogue {
  const float *a_scale;  // (M,)
  const float *w_scale;  // (N,)
  const float *bias;     // (N,) or null
  const void *residual;  // (M, N) f32 or bf16, or null
  int act, res_bf16, out_f32;
};

__device__ __forceinline__ void mma_s8(int *c, const unsigned *a, const unsigned *b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t *p) {
  return *reinterpret_cast<const unsigned *>(p);
}

__global__ void __launch_bounds__(THREADS)
gemm_i8_kernel(const int8_t *__restrict__ A, const int8_t *__restrict__ W, void *__restrict__ C,
               int M, int N, int K, Epilogue ep) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Ws[2][BN * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group, thread in group
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // A 128 x 64 tile is 128 rows of four 16-byte vectors: two per thread,
  // and the same for W.  K % 16 == 0, so a vector is all in or all out.
  uint4 ra[2], rw[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto load_regs = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * THREADS, r = v >> 2, gk = k0 + (v & 3) * 16;
      const int gm = row0 + r, gn = col0 + r;
      ra[s] = (gm < M && gk < K) ? *reinterpret_cast<const uint4 *>(A + (size_t)gm * K + gk)
                                 : zero;
      rw[s] = (gn < N && gk < K) ? *reinterpret_cast<const uint4 *>(W + (size_t)gn * K + gk)
                                 : zero;
    }
  };
  auto store_regs = [&](int buf) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * THREADS, off = (v >> 2) * LDS + (v & 3) * 16;
      *reinterpret_cast<uint4 *>(&As[buf][off]) = ra[s];
      *reinterpret_cast<uint4 *>(&Ws[buf][off]) = rw[s];
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
    const int8_t *as = As[buf], *ws = Ws[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // rows g and g + 8, columns 4·tg.. and 16 + 4·tg.. of a 16 x 32 tile
        const int8_t *p = as + (wm * 64 + i * 16 + g) * LDS + kk + tg * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // column g of a 32 x 8 tile: k = 4·tg.. and 16 + 4·tg..
        const int8_t *p = ws + (wn * 32 + j * 8 + g) * LDS + kk + tg * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (more) store_regs(buf ^ 1);
    buf ^= 1;
  }

  // Epilogue: registers 0, 1 hold row g, columns 2·tg, 2·tg + 1 of a 16 x 8
  // tile; registers 2, 3 the same columns of row g + 8.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + wn * 32 + j * 8 + tg * 2;
    if (c >= N) continue;  // N % 8 == 0: c < N means c + 1 < N
    const float s0 = ep.w_scale[c], s1 = ep.w_scale[c + 1];
    const float b0 = ep.bias ? ep.bias[c] : 0.f, b1 = ep.bias ? ep.bias[c + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * 64 + i * 16 + g + h * 8;
        if (r >= M) continue;
        const float a = ep.a_scale[r];
        float v0 = __int2float_rn(acc[i][j][2 * h]) * a * s0;
        float v1 = __int2float_rn(acc[i][j][2 * h + 1]) * a * s1;
        if (ep.bias) {
          v0 += b0;
          v1 += b1;
        }
        v0 = apply_act(v0, ep.act);
        v1 = apply_act(v1, ep.act);
        const size_t off = (size_t)r * N + c;
        if (ep.residual) {
          if (ep.res_bf16) {
            const float2 rr = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162 *>(static_cast<const bf16 *>(ep.residual) + off));
            v0 += rr.x;
            v1 += rr.y;
          } else {
            const float2 rr = *reinterpret_cast<const float2 *>(
                static_cast<const float *>(ep.residual) + off);
            v0 += rr.x;
            v1 += rr.y;
          }
        }
        if (ep.out_f32)
          *reinterpret_cast<float2 *>(static_cast<float *>(C) + off) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162 *>(static_cast<bf16 *>(C) + off) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// A (M, K) int8, a_scale (M,) f32, W (N, K) int8, w_scale (N,) f32, bias
// (N,) f32 or null, residual (M, N) f32 or bf16 or null → C (M, N) f32 or
// bf16.  K % 32 == 0, N % 8 == 0, 16-byte aligned contiguous operands
// (checked by the Python wrapper).
B3_EXPORT int b3_gemm_i8(const void *A, const void *a_scale, const void *W, const void *w_scale,
                         const void *bias, const void *residual, void *C, int M, int N, int K,
                         int act, int res_bf16, int out_f32, void *stream) {
  const Epilogue ep{static_cast<const float *>(a_scale), static_cast<const float *>(w_scale),
                    static_cast<const float *>(bias), residual, act, res_bf16, out_f32};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(A), static_cast<const int8_t *>(W), C, M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}
