// Hopper GEMM main loop shared by gemm_bias_act, gemm_dx and gemm_dw
// (gemm_bf16.cu) and gemm_i8 (gemm_i8.cu): TMA tile loads into a ring of shared-memory
// stages, handed between one producer warp and the consumer warpgroups by
// mbarrier pairs, and wgmma.mma_async on the staged tiles with one batch
// kept in flight.
//
//   producer (one thread of the last warp): wait empty[s] → expect_tx on
//     full[s] → cp.async.bulk.tensor loads of the A and B slices of k-tile
//     kt into stage s = kt % STAGES;
//   consumers (warpgroups 0..NWG-1, 64 output rows each): wait full[s] →
//     wgmma over the stage → commit → wait_group 1 (the previous k-tile's
//     products are done) → arrive on empty of the previous stage.
//
// Every staged row is 128 bytes (64 bf16 or 128 int8 along K for a K-major
// operand: A, the int8 W and gemm_dx's W (N, K); 64 bf16 along N for the
// MN-major B, or along M for gemm_dw's MN-major A) under the TMA's 128-byte
// swizzle, which is the layout wgmma's
// B128 descriptors read: 8-row atoms of 1024 bytes.  Split-K (gemm_dw):
// the K range is cut into chunks of whole k-tiles, and a work unit is one
// output tile of one chunk, written to its own f32 slab of C.  TMA
// zero-fills the parts of a box past the tensor's edge, so ragged M, N and
// K need no masking in the main loop; the epilogue masks its stores.  The
// epilogue works from the accumulator registers: f32(acc) [· a_scale[m] ·
// w_scale[n] for int8] + bias → f32 pre-activation copy → none / erf /
// tanh GELU → + residual (f32 or bf16) → f32 or bf16 out, two adjacent
// columns a lane; gemm_dx's form instead multiplies f32(acc) by gelu'(h),
// h an f32 pre-activation read through the residual slot.
//
// Tensor maps are encoded on the host for every launch with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library links without -lcuda; each map reaches the kernel as a
// __grid_constant__ parameter.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace hopper {

enum class Op { BF16, S8 };

template <Op OP>
struct OpTraits;
template <>
struct OpTraits<Op::BF16> {
  using acc_t = float;
  static constexpr int BK = 64;   // K elements a stage: one 128-byte row of A
};
template <>
struct OpTraits<Op::S8> {
  using acc_t = int;
  static constexpr int BK = 128;
};

// BM = 64·NWG rows (one consumer warpgroup each) by BN columns (multiple of
// 128: one m64n128 wgmma per 128 columns); a stage holds BM rows of A and
// the B slice, both 128 bytes a row (bf16: 64 K-rows of BN columns; int8: BN
// rows of W).  Large rings run one block an SM, small ones two.
template <Op OP, int BN, int NWG, int STAGES>
struct Tile {
  static constexpr int BM = 64 * NWG;
  static constexpr int BK = OpTraits<OP>::BK;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment slack
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int MIN_BLOCKS = SMEM > 113 * 1024 ? 1 : 2;
  static_assert(BN % 128 == 0 && BN <= 256, "BN is 128 or 256");
};

struct Epilogue {
  const float *a_scale;  // (M,) int8 row scales, or null
  const float *w_scale;  // (N,) int8 channel scales, or null
  const float *bias;     // (N,) or null
  const void *residual;  // (M, N) f32 or bf16, or null
  float *pre;            // (M, N) f32 copy of the biased product before act, or null
  int act, res_bf16, out_f32;
};

// ---------------------------------------------------------------- host

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A tiled map of rank 2 to 4: dims[0] is the contiguous dimension, each
// later one strides[i - 1] bytes apart; box[i] elements are loaded along
// dimension i.  The parts of a box past the tensor's edge arrive as zeros,
// box[0] larger than dims[0] included.  Needs a 16-byte aligned base and
// strides that are multiples of 16 bytes (the wrappers' alignment checks);
// under a swizzle, box[0] · elem_bytes must not exceed its span.
inline int encode_tiled(CUtensorMap *map, CUtensorMapDataType type, const void *ptr, int rank,
                        const uint64_t *dims, const uint64_t *strides, const uint32_t *box,
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const auto fn = encode_fn();
  if (!fn) return cudaErrorNotSupported;
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    if (i) st[i - 1] = strides[i - 1];
  }
  const CUresult r = fn(map, type, rank, const_cast<void *>(ptr), d, st, bx, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// Row-major (rows, cols) tensor of elem_bytes elements → a map that loads
// (box_rows, box_cols) boxes under the 128-byte swizzle (box_cols ·
// elem_bytes must be 128).
inline int encode_2d(CUtensorMap *map, CUtensorMapDataType type, int elem_bytes, const void *ptr,
                     int rows, int cols, int box_rows, int box_cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * elem_bytes};
  const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
  return encode_tiled(map, type, ptr, 2, dims, strides, box);
}

inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Tile by problem size: 128x128 (two consumer warpgroups) for products
// at least 1024 wide whose 128x128 tiles still cover every SM, else 64x128,
// which keeps the N = 512 products and small M busy.  Both run two blocks
// an SM, so one block's epilogue overlaps the other's main loop; a 128x256
// tile fits one block an SM and measured slower on every Stage-3 product
// (PERF.md).  Returns true for 128x128.
inline bool wide_tile(int M, int N) {
  return N >= 1024 && ((M + 127) / 128) * ((N + 127) / 128) >= sm_count();
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t *bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity ``parity`` has completed (a fresh barrier
// counts parity 1 as completed).  A wait of more than ~10 s of SM clock
// traps: a broken hand-off surfaces as a failed launch, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Box of the map at (column c0, row c1) → dst; completion counted on bar.
__device__ __forceinline__ void tma_load_2d(void *dst, const CUtensorMap *map, uint64_t *bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Box of a rank-3 map at (c0, c1, c2) → dst; completion counted on bar.
__device__ __forceinline__ void tma_load_3d(void *dst, const CUtensorMap *map, uint64_t *bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Box of a rank-4 map at (c0, c1, c2, c3) → dst; completion counted on bar.
__device__ __forceinline__ void tma_load_4d(void *dst, const CUtensorMap *map, uint64_t *bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma descriptor of a B128-swizzled tile at p (1024-byte aligned atoms,
// or 32-byte steps along K inside one): sbo = bytes between 8-row groups,
// lbo = bytes between 64-element MN chunks of an MN-major operand (unused
// by K-major ones).
__device__ __forceinline__ uint64_t smem_desc(const void *p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products (the registers change behind its back).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define HG_R8(C, d, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define HG_R64(C, d)                                                                  \
  HG_R8(C, d, 0), HG_R8(C, d, 8), HG_R8(C, d, 16), HG_R8(C, d, 24), HG_R8(C, d, 32), \
      HG_R8(C, d, 40), HG_R8(C, d, 48), HG_R8(C, d, 56)
#define HG_OPS64                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "   \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "    \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "    \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// D(64x128 f32) += A(64x16) · B(16x128); A K-major, or MN-major (A's
// transpose bit) with TA = 1; B MN-major (B's transpose bit) with TB = 1,
// or K-major (W (N, K) rows) with TB = 0
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HG_OPS64
      ", %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : HG_R64("+f", d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D(64x128 s32) += A(64x32 s8, K-major) · B(32x128 s8, K-major: W (N, K) rows)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HG_OPS64 ", %64, %65, p;\n"
      "}\n"
      : HG_R64("+r", d)
      : "l"(da), "l"(db), "r"(1));
}

// Epilogue of one tile from the accumulators of warpgroup wg (rows m0 +
// wg·64 ..) into C, masked at the M and N edges.  DGELU (gemm_dx): no
// bias or pre-activation copy, dropped at compile time (left to their
// run-time null checks, gemm_dx's GELU-derivative product took 0.65 ms
// instead of 0.41 at Stage-3 B=32, PERF.md); the residual slot holds h
// (M, N) f32, and for ACT_DGELU_* the product is multiplied by gelu'(h)
// instead of the activation and residual add.
template <Op OP, int NSUB, bool DGELU = false>
__device__ __forceinline__ void epilogue(
    const typename OpTraits<OP>::acc_t (&acc)[NSUB][64], int m0, int n0, int wg, int warp,
    int lane, void *C, int M, int N, const Epilogue &ep) {
  // Lane l of warp w holds, for each 8-column group q of a
  // 128-column slice, rows w·16 + l/4 (registers 4q, 4q+1) and + 8
  // (4q+2, 4q+3), columns 8q + 2·(l%4) and + 1.  The loads of QG groups
  // (bias, int8 channel scales, residual) issue together before their
  // stores, through restrict-qualified pointers: a load waits on no store.
  // QG = 2: two 128x128 blocks of 9 warps an SM leave 96 registers a
  // thread, and 4 groups spilled 2-4.5 KB a thread (PERF.md).
  constexpr int QG = 2;
  const float *__restrict__ bias = DGELU ? nullptr : ep.bias;
  const float *__restrict__ w_scale = ep.w_scale;
  const float *__restrict__ res32 =
      ep.res_bf16 ? nullptr : static_cast<const float *>(ep.residual);
  const bf16 *__restrict__ res16 = ep.res_bf16 ? static_cast<const bf16 *>(ep.residual) : nullptr;
  float *__restrict__ pre = DGELU ? nullptr : ep.pre;
  float *__restrict__ out32 = ep.out_f32 ? static_cast<float *>(C) : nullptr;
  bf16 *__restrict__ out16 = ep.out_f32 ? nullptr : static_cast<bf16 *>(C);
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  float rs[2] = {1.f, 1.f};
  if constexpr (OP == Op::S8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < M) rs[h] = ep.a_scale[row + 8 * h];
  }
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
#pragma unroll
    for (int q0 = 0; q0 < 16; q0 += QG) {
      float2 bv[QG], sv[QG], rv[QG][2];
#pragma unroll
      for (int qi = 0; qi < QG; ++qi) {
        const int c = n0 + j * 128 + (q0 + qi) * 8 + 2 * (lane % 4);
        const bool in = c < N;  // N % 8 == 0: c < N means c + 1 < N
        bv[qi] = make_float2(0.f, 0.f);
        if (bias && in) bv[qi] = *reinterpret_cast<const float2 *>(bias + c);
        sv[qi] = make_float2(1.f, 1.f);
        if constexpr (OP == Op::S8)
          if (in) sv[qi] = *reinterpret_cast<const float2 *>(w_scale + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t off = (size_t)(row + 8 * h) * N + c;
          rv[qi][h] = make_float2(0.f, 0.f);
          if (in && row + 8 * h < M) {
            if (res32)
              rv[qi][h] = *reinterpret_cast<const float2 *>(res32 + off);
            else if (res16)
              rv[qi][h] = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162 *>(res16 + off));
          }
        }
      }
#pragma unroll
      for (int qi = 0; qi < QG; ++qi) {
        const int q = q0 + qi;
        const int c = n0 + j * 128 + q * 8 + 2 * (lane % 4);
        if (c >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r >= M) continue;
          float v0, v1;
          if constexpr (OP == Op::S8) {
            v0 = __int2float_rn(acc[j][4 * q + 2 * h]) * rs[h] * sv[qi].x;
            v1 = __int2float_rn(acc[j][4 * q + 2 * h + 1]) * rs[h] * sv[qi].y;
          } else {
            v0 = acc[j][4 * q + 2 * h];
            v1 = acc[j][4 * q + 2 * h + 1];
          }
          v0 += bv[qi].x;
          v1 += bv[qi].y;
          const size_t off = (size_t)r * N + c;
          if (pre) *reinterpret_cast<float2 *>(pre + off) = make_float2(v0, v1);
          if constexpr (DGELU) {
            if (ep.act != ACT_NONE) {
              v0 *= gelu_grad(rv[qi][h].x, ep.act);
              v1 *= gelu_grad(rv[qi][h].y, ep.act);
            }
          } else {
            v0 = apply_act(v0, ep.act) + rv[qi][h].x;
            v1 = apply_act(v1, ep.act) + rv[qi][h].y;
          }
          if (out32)
            *reinterpret_cast<float2 *>(out32 + off) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162 *>(out16 + off) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// The whole kernel body; each .cu wraps it in a __global__ of its own name
// that takes the two maps as __grid_constant__ parameters.  For BF16, map_a
// loads A (M, K) in (BM, 64) boxes — with A_MN, Aᵀ = X (K, M) in (64, 64)
// boxes, one per consumer warpgroup — and map_b B (K, N) in (64, 64)
// boxes, or with B_K (gemm_dx) W (N, K) in (BN, 64) boxes, read K-major
// as the int8 W; for S8, map_a loads A (M, K) in (BM, 128) boxes and map_b
// W (N, K) in (BN, 128) boxes.  B_K also selects gemm_dx's epilogue.
// k_chunk (a multiple of BK unless it is K) cuts K into splits: unit u is
// output tile u % tiles of split u / tiles, written to slab u / tiles of C
// (M x N each).  Persistent: block b takes units b,
// b + gridDim.x, … (N fastest), and the producer and consumers walk one
// stage ring across them, so the loads of a unit's first k-tiles overlap
// the previous unit's epilogue.
template <Op OP, int BN, int NWG, int STAGES, bool A_MN = false, bool B_K = false>
__device__ __forceinline__ void gemm_body(const CUtensorMap *map_a, const CUtensorMap *map_b,
                                          void *__restrict__ C, int M, int N, int K, int k_chunk,
                                          const Epilogue &ep) {
  using T = Tile<OP, BN, NWG, STAGES>;
  using acc_t = typename OpTraits<OP>::acc_t;
  constexpr int NSUB = BN / 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t *sa = smem;
  uint8_t *sb = smem + STAGES * T::A_BYTES;
  uint64_t *full = reinterpret_cast<uint64_t *>(sb + STAGES * T::B_BYTES);
  uint64_t *empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (N + BN - 1) / BN, tiles = n_tiles * ((M + T::BM - 1) / T::BM);
  const int units = tiles * ((K + k_chunk - 1) / k_chunk);
  const size_t slab = (size_t)M * N * (ep.out_f32 ? 4 : 2);  // bytes of one split's C
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer
    if (lane == 0) {
      int it = 0;  // k-tiles loaded so far: the ring position
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int t = u % tiles, k_beg = u / tiles * k_chunk;
        const int m0 = t / n_tiles * T::BM, n0 = t % n_tiles * BN;
        const int KT = (min(K, k_beg + k_chunk) - k_beg + T::BK - 1) / T::BK;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES, k0 = k_beg + kt * T::BK;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
          uint8_t *a = sa + s * T::A_BYTES, *b = sb + s * T::B_BYTES;
          if constexpr (A_MN) {
#pragma unroll
            for (int w = 0; w < NWG; ++w)  // 64 columns of X's 64 K-rows a warpgroup
              tma_load_2d(a + w * 64 * 128, map_a, &full[s], m0 + w * 64, k0);
          } else {
            tma_load_2d(a, map_a, &full[s], k0, m0);
          }
          if constexpr (OP == Op::BF16 && !B_K) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)  // 64-column chunks of B's 64 K-rows
              tma_load_2d(b + c * 64 * 128, map_b, &full[s], n0 + c * 64, k0);
          } else {
            tma_load_2d(b, map_b, &full[s], k0, n0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg·64 .. wg·64 + 63 of each tile
  const int wg = warp / 4;
  acc_t acc[NSUB][64];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int t = u % tiles, k_beg = u / tiles * k_chunk;
    const int m0 = t / n_tiles * T::BM, n0 = t % n_tiles * BN;
    const int KT = (min(K, k_beg + k_chunk) - k_beg + T::BK - 1) / T::BK;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t *a = sa + s * T::A_BYTES + wg * 64 * 128;
      const uint8_t *b = sb + s * T::B_BYTES;
#pragma unroll
      for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 32 bytes of K per product
        // an MN-major A, as B below: 16 K-rows further down per step, its
        // 64 rows one 64-element chunk
        const uint64_t da = A_MN ? smem_desc(a + kk * 16 * 128, 64 * 128, 1024)
                                 : smem_desc(a + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          if constexpr (OP == Op::BF16 && B_K) {
            // K-major W: 32 bytes along each of its 128 N-rows per step
            wgmma_bf16_n128<A_MN, 0>(acc[j], da, smem_desc(b + j * 128 * 128 + kk * 32, 16, 1024));
          } else if constexpr (OP == Op::BF16) {
            // MN-major B: 16 K-rows further down per step; the 128 columns
            // are two 64-column chunks of 8 KB (lbo)
            wgmma_bf16_n128<A_MN, 1>(acc[j], da,
                                     smem_desc(b + j * 2 * 64 * 128 + kk * 16 * 128, 64 * 128,
                                               1024));
          } else {
            wgmma_s8_n128(acc[j], da, smem_desc(b + j * 128 * 128 + kk * 32, 16, 1024));
          }
        }
      }
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
      if (kt > 0) {
        wgmma_wait<1>();  // k-tile kt-1's products are done: free its stage
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);  // the tile's last stage
    epilogue<OP, NSUB, B_K>(acc, m0, n0, wg, warp, lane,
                            static_cast<char *>(C) + u / tiles * slab, M, N, ep);
  }
}

// Encode both maps and launch KERNEL<BN, NWG, STAGES> persistent: one block
// for each work unit, at most MIN_BLOCKS an SM.  k_chunk: K elements a
// split (K: no split); A_MN: A is given as X (K, M); B_K: B is given as
// W (N, K).
template <Op OP, int BN, int NWG, int STAGES, bool A_MN = false, bool B_K = false,
          typename Kernel>
int launch(Kernel kernel, const void *A, const void *B, void *C, int M, int N, int K,
           const Epilogue &ep, cudaStream_t stream, int k_chunk = 0) {
  using T = Tile<OP, BN, NWG, STAGES>;
  if (K <= 0) return cudaErrorInvalidValue;
  if (k_chunk <= 0 || k_chunk > K) k_chunk = K;
  if (k_chunk < K && k_chunk % T::BK) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int err;
  if constexpr (A_MN) {
    err = encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, K, M, 64, 64);
    if (!err) err = encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, K, N, 64, 64);
  } else if constexpr (OP == Op::BF16) {
    err = encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, M, K, T::BM, 64);
    if (!err)
      err = B_K ? encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, N, K, BN, 64)
                : encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, K, N, 64, 64);
  } else {
    err = encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, A, M, K, T::BM, 128);
    if (!err) err = encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, N, K, BN, 128);
  }
  if (err) return err;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err) return err;
    sized = true;
  }
  const int units =
      ((N + BN - 1) / BN) * ((M + T::BM - 1) / T::BM) * ((K + k_chunk - 1) / k_chunk);
  const int grid = units < sm_count() * T::MIN_BLOCKS ? units : sm_count() * T::MIN_BLOCKS;
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(ma, mb, C, M, N, K, k_chunk, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper
