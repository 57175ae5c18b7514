// stage3_attention_core_i8: one ProteoScribe layer's attention with the
// band-local heads' two products in int8, from the fused q/k/v projection
// (B, L, 3d) to the head outputs (B, L, d); the linear heads in bf16 as in
// stage3_attention_core (stage3_linear.cuh).
//
// Replaces the attn_quant="int8" branch of _attn_core_t inside the TPU
// kernel biom3_tpu/ops/pallas/stack_kernel_tpu.py:112-180 (fused_stack_logits):
// * q and k are quantized per (head, token) over Dh, v per (head, channel)
//   over the whole sequence: amax = max(max|x|, 1e-6), code = rint(x ·
//   (127 / amax)) clipped to ±127 (round half to even, as jnp.round), scale
//   amax · (1/127);
// * scores (int32 q8·k8) · s_q · s_k · Dh^-0.5 in f32, the f32 softmax over
//   the row's band (windows w-1..w+1 that exist: edge windows see 2W keys);
// * p is quantized per (head, query): pamax = max_j p = 1 / l, pq =
//   rint(p · (127 / pamax)); out = int32(Σ_j pq · v8) · s_v[channel] ·
//   (pamax · (1/127)), rounded to bf16.
// p · (127 / pamax) is 127 · exp(s − m) up to two roundings, so the band
// kernel forms pq = rint(127 · exp2((s − m) · log2 e)) from the row's final
// max m alone: a first pass over the band finds m, the second forms the
// codes, l = Σ exp and the int32 PV.  A code departs from the plain
// version's by one step where 127 · exp(s − m) lies within those roundings
// of a half (ops/kernels.py::stage3_i8_band_plain(rounding="kernel")).
//
// Four launches:
// 1. stage3_i8_quant_kernel, grid (row chunks, local heads, B), the chunk
//    from ops/kernels.py::stage3_i8_quant_plan (at least a wave at Stage-3
//    B=4): q and k codes of the chunk's rows, a row in 16-byte vectors over
//    Dh / 8 lanes; v's amax a channel over all L rows (every block of the
//    head reads them: a max is order-free, so each gets the same bits), then
//    the chunk's v codes channel-major (B, local, Dh, Lp), Lp = L rounded up
//    to 32 (zeros past L), the keys of each 32-key group in the order the
//    PV product's register A fragments take them (pv_pos);
// 2, 3. the linear heads' statistics and ctx (stage3_linear.cuh);
// 4. stage3_i8_band_wgmma_kernel, grid (ceil(L / 128) · local + the linear
//    heads' output blocks, B): a band block per (128 queries, local head,
//    batch row), two warpgroups of 64 queries.  Thread 0 starts every TMA
//    load at once: the q codes (a (Dh, 128) box under the TMA's Dh-byte
//    swizzle), then per 128-key tile of the block's band (from its first
//    key rounded down to a multiple of 32) the k codes (likewise), the v
//    codes ((128 keys, Dh) under the 128-byte swizzle: K-major for the PV
//    product, which an s8 wgmma needs) and the k scales, each tile on its
//    own mbarrier.  The whole band stays in shared memory for both passes.
//    Per 64-key half tile: S = Q8·K8ᵀ on wgmma m64n64k32 s8 (IGMMA; Dh / 32
//    k-steps); pass 1 keeps the row max of s_k·S; pass 2 forms e =
//    exp2(fma(s_k·S, s_q·Dh^-0.5·log2 e, −m)), its code rint(127·e) by one
//    FMA with 1.5·2^23 (the low byte of the sum is the code), l += e, packs
//    the codes as the A fragments of two k32 steps and adds P·V8 on wgmma
//    m64nDhk32 with A from registers into int32 accumulators.  Keys outside
//    a row's band (or at or past L) take part in neither m nor l and get
//    code 0; a half tile inside every row's band of its warpgroup runs
//    without masks, one outside all of them is skipped.
//
// What bounds it on an H100: the bytes at the least (qkv in, the outputs
// out); the codes, ~2 bytes a band value, go out and come back mostly from
// L2.  In practice the band kernel's issue slots: a (query, key) pair costs
// ~3 instructions in pass 1 (an I2FP conversion, the scale, the max) and ~8
// in pass 2 (conversion, scale, exp2, sum, code, pack), the products next to
// nothing on IGMMA.  The warpgroups wait for each product: overlapping the
// next group's product with this group's elementwise work (32-key groups,
// two accumulator sets) measured slower on an H100 (PERF.md).  At head
// dim 32 three blocks fit an SM (80 registers, a few spilled), at 64 two.
#include <type_traits>

#include "attn_hopper.cuh"
#include "stage3_linear.cuh"

namespace {

using attn::acc_row;
using attn::aligned_smem;
using attn::quad_max;
using attn::quad_sum;
using hopper::fence_regs;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int BQ = 128;               // queries a band block: two warpgroups of 64
constexpr int NT = 256;               // threads a block of the band kernel's grid
constexpr int KT = 128;               // keys a staged tile
constexpr int HALF = 64;              // keys a product
constexpr int QUANT_THREADS = 256;
constexpr int VSLICE = 128;           // rows a pre-pass block codes v in at a time
constexpr int MAX_SMEM = 232448;      // dynamic shared memory a block may have
constexpr float INV127 = (float)(1.0 / 127.0);
constexpr float MAGIC = 12582912.f;   // 1.5 · 2^23: x + MAGIC rounds x to an integer
static_assert(BQ == LIN_BQ, "a linear output tile is a band block's rows");

__device__ __forceinline__ uint4 ld16v(const bf16 *p) {
  return *reinterpret_cast<const uint4 *>(p);
}

__device__ __forceinline__ uint32_t code_of(float x, float mul) {
  return static_cast<uint32_t>(static_cast<int>(
             fminf(fmaxf(rintf(__fmul_rn(x, mul)), -127.f), 127.f))) & 0xffu;
}

// Position of key c (0..31) of a 32-key group in the PV operand's order.
// A thread's S accumulator holds the columns 8q + 2·(lane % 4) + e (q 0..3
// within a 32-key group, e 0..1); the register A fragment of a k32 step
// takes the bytes 4·(lane % 4) + i and 16 + 4·(lane % 4) + i.  Packing the
// codes of q = 0, 1 into the first register and q = 2, 3 into the other,
// column c lands at k = 16·(q / 2) + 4·(lane % 4) + 2·(q % 2) + e, so v8
// keeps key c at that position (ops/kernels.py::stage3_i8_pv_order).
__host__ __device__ __forceinline__ int pv_pos(int c) {
  const int q = c / 8, t = (c % 8) / 2, e = c % 2;
  return 16 * (q / 2) + 4 * t + 2 * (q % 2) + e;
}

// The 128-key tiles of the band block at q0: from kt0, the first key of
// the union of its rows' bands rounded down to a multiple of 32, to the
// last (ops/kernels.py::stage3_i8_band_tiles).
__host__ __device__ __forceinline__ void band_tiles(int q0, int L, int window, int &kt0,
                                                    int &tiles) {
  const int last = (q0 + BQ < L ? q0 + BQ : L) - 1;
  const int lo = q0 / window > 0 ? (q0 / window - 1) * window : 0;
  int hi = (last / window + 2) * window;
  if (hi > L) hi = L;
  kt0 = lo / 32 * 32;
  tiles = (hi - kt0 + KT - 1) / KT;
}

// ---------------------------------------------------------------- pre-pass

// Block (c, h, b): rows [c·rows, min(L, (c+1)·rows)) of local head h of
// batch row b; Dh / 8 threads a row, one 16-byte vector each, U rows'
// loads in flight.
template <int DH>
__global__ void __launch_bounds__(QUANT_THREADS)
stage3_i8_quant_kernel(const bf16 *__restrict__ qkv, int8_t *__restrict__ q8,
                       float *__restrict__ sq, int8_t *__restrict__ k8, float *__restrict__ sk,
                       int8_t *__restrict__ v8, float *__restrict__ sv, int L, int Lp, int d,
                       int nl, int rows) {
  constexpr int TPR = DH / 8, RPP = QUANT_THREADS / TPR, WARPS = QUANT_THREADS / 32, U = 4;
  __shared__ float red[WARPS][DH];
  __shared__ float mul_v[DH];
  __shared__ __align__(16) uint8_t vt[DH][VSLICE];   // a slice's v codes, channel-major
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int lr = t % TPR, rr = t / TPR;
  const size_t rs = 3 * (size_t)d, hb = (size_t)b * nl + h;
  const bf16 *base = qkv + (size_t)b * L * rs + h * DH + lr * 8;
  const int r0 = c * rows, r1 = min(L, r0 + rows);

  // q, then k: each row's codes and scale from that row alone
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    int8_t *codes = which ? k8 : q8;
    float *scales = which ? sk : sq;
    for (int g0 = r0; g0 < r1; g0 += U * RPP) {   // a trip count uniform over the block
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = g0 + u * RPP + rr;
        raw[u] = r < r1 ? ld16v(base + r * rs + which * d) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = g0 + u * RPP + rr;
        float x[8];
        unpack8(raw[u], x);
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        amax = fmaxf(amax, 1e-6f);
        const float mul = __fdiv_rn(127.f, amax);
        uint32_t w[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          w[i] = code_of(x[4 * i], mul) | code_of(x[4 * i + 1], mul) << 8 |
                 code_of(x[4 * i + 2], mul) << 16 | code_of(x[4 * i + 3], mul) << 24;
        if (r < r1) {
          *reinterpret_cast<uint2 *>(codes + (hb * L + r) * DH + lr * 8) = make_uint2(w[0], w[1]);
          if (lr == 0) scales[hb * L + r] = __fmul_rn(amax, INV127);
        }
      }
    }
  }

  // v: each channel's amax over all L rows
  const bf16 *vbase = base + 2 * d;
  float m8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m8[e] = 0.f;
  for (int g0 = 0; g0 < L; g0 += U * RPP) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = g0 + u * RPP + rr;
      raw[u] = r < L ? ld16v(vbase + r * rs) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[8];
      unpack8(raw[u], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) m8[e] = fmaxf(m8[e], fabsf(x[e]));
    }
  }
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1)   // the warp's rows of the same channels
#pragma unroll
    for (int e = 0; e < 8; ++e) m8[e] = fmaxf(m8[e], __shfl_xor_sync(0xffffffffu, m8[e], off));
  if (t % 32 < TPR)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[t / 32][lr * 8 + e] = m8[e];
  __syncthreads();
  if (t < DH) {
    float m = red[0][t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w][t]);
    m = fmaxf(m, 1e-6f);
    mul_v[t] = __fdiv_rn(127.f, m);
    if (c == 0) sv[hb * DH + t] = __fmul_rn(m, INV127);
  }
  __syncthreads();

  // v codes of the chunk, VSLICE rows at a time: into vt at their PV
  // positions, then out as 16-byte rows of each channel (positions < Lp)
  float mul[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mul[e] = mul_v[lr * 8 + e];
  const int s1 = min(r0 + rows, Lp);
  for (int s0 = r0; s0 < s1; s0 += VSLICE) {
#pragma unroll
    for (int o = rr; o < VSLICE; o += RPP) {
      const int r = s0 + o;
      float x[8];
      if (r < L) {
        unpack8(ld16v(vbase + r * rs), x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      const int pos = o / 32 * 32 + pv_pos(o % 32);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[lr * 8 + e][pos] = static_cast<uint8_t>(code_of(x[e], mul[e]));
    }
    __syncthreads();
    for (int i = t; i < DH * VSLICE / 16; i += QUANT_THREADS) {
      const int ch = i / (VSLICE / 16), part = i % (VSLICE / 16);
      if (s0 + part * 16 < Lp)
        *reinterpret_cast<uint4 *>(v8 + (hb * DH + ch) * Lp + s0 + part * 16) =
            *reinterpret_cast<const uint4 *>(&vt[ch][part * 16]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- band kernel

#define I8_R8(C, d, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define I8_R16(C, d) I8_R8(C, d, 0), I8_R8(C, d, 8)
#define I8_R32(C, d) I8_R8(C, d, 0), I8_R8(C, d, 8), I8_R8(C, d, 16), I8_R8(C, d, 24)
#define I8_OPS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define I8_OPS32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// S(64 x 64 s32) (+)= A(64 x 32 s8) · B(32 x 64 s8), both from shared memory,
// K-major; acc = 0 overwrites S.
__device__ __forceinline__ void wgmma_s8_ss_n64(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " I8_OPS32 ", %32, %33, p;\n"
      "}\n"
      : I8_R32("+r", d)
      : "l"(da), "l"(db), "r"(acc));
}

// O(64 x N s32) += A(64 x 32 s8, registers) · B(32 x N s8, K-major), N = 32 or 64.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " I8_OPS16
      ", {%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : I8_R16("+r", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " I8_OPS32
      ", {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : I8_R32("+r", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Descriptor of a K-major int8 tile of DH-byte rows under the TMA's DH-byte
// swizzle (32B: layout 3, 64B: layout 2), 8-row groups 8·DH bytes apart,
// at k-step kk (32 bytes along the rows).
template <int DH>
__device__ __forceinline__ uint64_t desc_rows(const uint8_t *tile, int kk) {
  constexpr uint64_t layout = DH == 32 ? 3 : 2;
  return (uint64_t)((smem_addr(tile + 32 * kk) & 0x3FFFF) >> 4) | 1ull << 16 |
         (uint64_t)((8 * DH) >> 4) << 32 | layout << 62;
}
// ... of the v tile, 128-byte rows (128 keys a channel) under the 128-byte
// swizzle, at key offset koff (a multiple of 32).
__device__ __forceinline__ uint64_t desc_v(const uint8_t *tile, int koff) {
  return hopper::smem_desc(tile + koff, 16, 1024);
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
struct BandSmem {
  static constexpr int Q_BYTES = BQ * DH;
  static constexpr int K_BYTES = KT * DH;
  static constexpr int V_BYTES = DH * KT;
  static constexpr int S_BYTES = KT * 4;
  static constexpr int TILE_STRIDE = K_BYTES + V_BYTES + 1024;   // + the k scales, padded
  static constexpr int bytes(int tiles) {
    return 1024 + Q_BYTES + tiles * TILE_STRIDE + (tiles + 1) * 8;
  }
};

template <int DH>
__global__ void __launch_bounds__(NT, DH == 32 ? 3 : 2)
stage3_i8_band_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_s,
                            const float *__restrict__ sq, const float *__restrict__ sv,
                            const bf16 *__restrict__ qkv, const float *__restrict__ ctx,
                            bf16 *__restrict__ out, uint8_t *__restrict__ pq_out, int H, int L,
                            int d, int nl, int window, int lrows, float scale_log2) {
  using S = BandSmem<DH>;
  constexpr int OR = DH / 2;   // PV accumulator registers (m64nDH)
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = aligned_smem(smem_raw);
  const int qtiles = (L + BQ - 1) / BQ, b = blockIdx.y, bx = blockIdx.x;
  if (bx >= qtiles * nl) {   // the linear heads' output rows
    const int j = bx - qtiles * nl, ltiles = (L + lrows - 1) / lrows;
    const int ng = H - nl, head = nl + j / ltiles, r0 = (j % ltiles) * lrows;
    linear_rows<DH, NT>(smem, qkv, ctx + ((size_t)b * ng + head - nl) * DH * DH, out, b, head,
                        r0, min(L, r0 + lrows), L, d);
    return;
  }
  const int q0 = (bx % qtiles) * BQ, head = bx / qtiles, hb = b * nl + head;
  int kt0, tiles;
  band_tiles(q0, L, window, kt0, tiles);
  uint8_t *sQ = smem, *sT = smem + S::Q_BYTES;
  // barriers: the q tile's, then one a key tile
  uint64_t *bar = reinterpret_cast<uint64_t *>(sT + tiles * S::TILE_STRIDE);
  if (threadIdx.x == 0) {
    for (int i = 0; i <= tiles; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar[0], S::Q_BYTES);
    hopper::tma_load_3d(sQ, &map_q, &bar[0], 0, q0, hb);
    for (int t = 0; t < tiles; ++t) {
      uint8_t *st = sT + t * S::TILE_STRIDE;
      const int k0 = kt0 + t * KT;
      mbar_arrive_expect_tx(&bar[1 + t], S::K_BYTES + S::V_BYTES + S::S_BYTES);
      hopper::tma_load_3d(st, &map_k, &bar[1 + t], 0, k0, hb);
      hopper::tma_load_3d(st + S::K_BYTES, &map_v, &bar[1 + t], k0, 0, hb);
      hopper::tma_load_2d(st + S::K_BYTES + S::V_BYTES, &map_s, &bar[1 + t], k0, hb);
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, t4 = lane % 4;
  const int row0 = q0 + wg * 64;
  if (row0 >= L) return;   // no valid row in this warpgroup (its loads land regardless)
  const int last = min(row0 + 63, L - 1);
  // the union of the warpgroup's rows' bands, and the keys every one of them sees
  const int u_lo = max(0, (row0 / window - 1) * window);
  const int u_hi = min(L, (last / window + 2) * window);
  const int f_lo = max(0, (last / window - 1) * window);
  const int f_hi = min(L, (row0 / window + 2) * window);
  const unsigned span = 3u * window;
  int row[2], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = row0 + acc_row(h, warp, lane);
    lo[h] = (row[h] / window - 1) * window;
  }
  // bitwise, not short-circuit: a select, not a branch, per value
  auto masked = [&](int h, int key) { return ((unsigned)(key - lo[h]) >= span) | (key >= L); };
  const uint8_t *qt = sQ + wg * 64 * DH;
  int s[32];

  // S of the 64 keys at kt (a half tile) into s
  auto scores = [&](const uint8_t *kt) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk)
      wgmma_s8_ss_n64(s, desc_rows<DH>(qt, kk), desc_rows<DH>(kt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  };
  // The half tiles of tile t that touch a row's band (ops/kernels.py::
  // stage3_i8_half_tiles).  Each one's elementwise work comes in two forms,
  // chosen once a half tile: without masks where every row of the warpgroup
  // sees all its keys, else with a select per value (a branch per value would cut the unrolled
  // code into blocks that the compiler cannot schedule across)
  auto each_half = [&](int t, auto &&work) {
#pragma unroll
    for (int j = 0; j < KT / HALF; ++j) {
      const int k0 = kt0 + t * KT + j * HALF;
      if (k0 >= u_hi || k0 + HALF <= u_lo) continue;   // outside every row's band
      if (k0 >= f_lo && k0 + HALF <= f_hi) work(j, k0, std::true_type{});
      else work(j, k0, std::false_type{});
    }
  };

  // pass 1: the row max of s_k · S (the rows' scale and Dh^-0.5 are > 0)
  mbar_wait(&bar[0], 0);
  float mx[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < tiles; ++t) {
    mbar_wait(&bar[1 + t], 0);
    const uint8_t *st = sT + t * S::TILE_STRIDE;
    const float *skt = reinterpret_cast<const float *>(st + S::K_BYTES + S::V_BYTES);
    each_half(t, [&](int j, int k0, auto whole) {
      scores(st + j * HALF * DH);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 skv = *reinterpret_cast<const float2 *>(skt + j * HALF + 8 * q + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x0 = __fmul_rn(__int2float_rn(s[4 * q + 2 * h]), skv.x);
          float x1 = __fmul_rn(__int2float_rn(s[4 * q + 2 * h + 1]), skv.y);
          if constexpr (!decltype(whole)::value) {
            const int key = k0 + 8 * q + 2 * t4;
            x0 = masked(h, key) ? -INFINITY : x0;
            x1 = masked(h, key + 1) ? -INFINITY : x1;
          }
          mx[h] = fmaxf(mx[h], fmaxf(x0, x1));
        }
      }
    });
  }
  float c[2], m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    const bool live = row[h] < L && mx[h] > -INFINITY;
    c[h] = live ? __fmul_rn(sq[(size_t)hb * L + row[h]], scale_log2) : 0.f;
    m[h] = live ? __fmul_rn(mx[h], c[h]) : 0.f;
  }

  // pass 2: the codes, l and P·V.  The codes of a half tile's 64 keys are
  // the A fragments of two k32 steps against them in v8
  int o[OR];
#pragma unroll
  for (int i = 0; i < OR; ++i) o[i] = 0;
  float l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    const uint8_t *st = sT + t * S::TILE_STRIDE;
    const uint8_t *vt = st + S::K_BYTES;
    const float *skt = reinterpret_cast<const float *>(st + S::K_BYTES + S::V_BYTES);
    each_half(t, [&](int j, int k0, auto whole) {
      scores(st + j * HALF * DH);
      uint32_t a[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t bits[4];
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              const int q = 4 * kk + 2 * half + qq;
              const float2 skv =
                  *reinterpret_cast<const float2 *>(skt + j * HALF + 8 * q + 2 * t4);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x =
                    __fmul_rn(__int2float_rn(s[4 * q + 2 * h + e]), e ? skv.y : skv.x);
                float p = ex2(fmaf(x, c[h], -m[h]));
                if constexpr (!decltype(whole)::value)
                  p = masked(h, k0 + 8 * q + 2 * t4 + e) ? 0.f : p;
                l[h] += p;
                bits[2 * qq + e] = __float_as_uint(fmaf(p, 127.f, MAGIC));   // low byte: the code
              }
            }
            a[kk][2 * half + h] = __byte_perm(__byte_perm(bits[0], bits[1], 0x0040),
                                              __byte_perm(bits[2], bits[3], 0x0040), 0x5410);
          }
      if (pq_out) {   // the codes at the plain version's band positions (checks only)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * q + 2 * t4 + e;
              if (row[h] >= L || masked(h, key)) continue;
              pq_out[((size_t)hb * L + row[h]) * span + key - lo[h]] = static_cast<uint8_t>(
                  a[q / 4][2 * ((q % 4) / 2) + h] >> (8 * (2 * (q % 2) + e)));
            }
      }
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_s8_rs(o, a[kk], desc_v(vt, j * HALF + 32 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    });
  }

  // out = int32(Σ pq·v8) · s_v · (pamax / 127), pamax = max(1 / l, 1e-6)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= L) continue;
    const float f = __fmul_rn(fmaxf(__fdiv_rn(1.f, quad_sum(l[h])), 1e-6f), INV127);
    bf16 *dst = out + ((size_t)b * L + row[h]) * d + head * DH;
#pragma unroll
    for (int q = 0; q < DH / 8; ++q) {
      const int col = 8 * q + 2 * t4;
      const float2 s2 = *reinterpret_cast<const float2 *>(sv + (size_t)hb * DH + col);
      *reinterpret_cast<__nv_bfloat162 *>(dst + col) = __floats2bfloat162_rn(
          __fmul_rn(__fmul_rn((float)o[4 * q + 2 * h], s2.x), f),
          __fmul_rn(__fmul_rn((float)o[4 * q + 2 * h + 1], s2.y), f));
    }
  }
}

template <int DH>
int launch(const bf16 *qkv, bf16 *out, int8_t *q8, float *sq, int8_t *k8, float *sk, int8_t *v8,
           float *sv, float *ws, uint8_t *pq, int B, int L, int d, int heads, int nl, int window,
           int rows, int chunks, int per, int srows, int lrows, cudaStream_t stream) {
  using S = BandSmem<DH>;
  const int ng = heads - nl, Lp = (L + 31) / 32 * 32;
  if (nl > 0 && (rows < VSLICE || rows % VSLICE)) return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 0;   // the most tiles a band block stages
  for (int q0 = 0; nl > 0 && q0 < L; q0 += BQ) {
    int kt0, n;
    band_tiles(q0, L, window, kt0, n);
    if (n > tiles) tiles = n;
  }
  const int band_smem = S::bytes(tiles), lin_smem = linear_rows_smem(DH) + 1024;
  const int smem = band_smem > lin_smem ? band_smem : lin_smem;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (nl > 0) {
    stage3_i8_quant_kernel<DH><<<dim3((L + rows - 1) / rows, nl, B), QUANT_THREADS, 0, stream>>>(
        qkv, q8, sq, k8, sk, v8, sv, L, Lp, d, nl, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int e = launch_linear_ctx<DH>(qkv, ws, B, L, d, heads, nl, chunks, per, srows, lrows, stream);
  if (e) return e;
  CUtensorMap map_q{}, map_k{}, map_v{}, map_s{};
  if (nl > 0) {
    const uint64_t n = (uint64_t)B * nl;
    const uint64_t qk_dims[3] = {(uint64_t)DH, (uint64_t)L, n};
    const uint64_t qk_strides[2] = {(uint64_t)DH, (uint64_t)L * DH};
    const uint32_t q_box[3] = {DH, BQ, 1}, k_box[3] = {DH, KT, 1};
    const CUtensorMapSwizzle sw = DH == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
    const uint64_t v_dims[3] = {(uint64_t)Lp, (uint64_t)DH, n};
    const uint64_t v_strides[2] = {(uint64_t)Lp, (uint64_t)Lp * DH};
    const uint32_t v_box[3] = {KT, DH, 1};
    const uint64_t s_dims[2] = {(uint64_t)L, n};
    const uint64_t s_strides[1] = {(uint64_t)L * 4};
    const uint32_t s_box[2] = {KT, 1};
    if ((e = hopper::encode_tiled(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q8, 3, qk_dims,
                                  qk_strides, q_box, sw)) ||
        (e = hopper::encode_tiled(&map_k, CU_TENSOR_MAP_DATA_TYPE_UINT8, k8, 3, qk_dims,
                                  qk_strides, k_box, sw)) ||
        (e = hopper::encode_tiled(&map_v, CU_TENSOR_MAP_DATA_TYPE_UINT8, v8, 3, v_dims,
                                  v_strides, v_box)) ||
        (e = hopper::encode_tiled(&map_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sk, 2, s_dims,
                                  s_strides, s_box, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return e;
  }
  static int sized = 48 << 10;   // the most dynamic shared memory allowed so far
  if (smem > sized) {
    err = cudaFuncSetAttribute(stage3_i8_band_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = smem;
  }
  const float *ctx = ng > 0 ? LinWs(ws, B * ng, L, DH).ctx : nullptr;
  const dim3 grid((L + BQ - 1) / BQ * nl + (ng > 0 ? (L + lrows - 1) / lrows * ng : 0), B);
  stage3_i8_band_wgmma_kernel<DH><<<grid, NT, smem, stream>>>(
      map_q, map_k, map_v, map_s, sq, sv, qkv, ctx, out, pq, heads, L, d, nl, window, lrows,
      1.4426950408889634f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, L, 3d) bf16 [q | k | v], 16-byte aligned; out (B, L, d) bf16.
// Codes and scales of the local heads, all written here: q8, k8 (B, local,
// L, Dh) int8, sq, sk (B, local, L) f32, v8 (B, local, Dh, Lp) int8 with
// Lp = L rounded up to 32, each 32-key group in PV order (pv_pos), sv (B,
// local, Dh) f32.  ws: the linear heads' f32 scratch and their splits
// (chunks, per, srows, lrows) as b3_stage3_attention_core takes them;
// quant_rows: rows a pre-pass block (a multiple of 128).  pq: null, or (B,
// local, L, 3·window) uint8 zeros that take each band key's p code at the
// plain version's position (checks only).  Head dim d / heads 32 or 64;
// window % 4 == 0 and L % window == 0.  Launches: 4 (fewer without local
// or linear heads).
B3_EXPORT int b3_stage3_attention_i8(const void *qkv, void *out, void *q8, void *sq, void *k8,
                                     void *sk, void *v8, void *sv, void *ws, void *pq, int B,
                                     int L, int d, int heads, int local_heads, int window,
                                     int quant_rows, int chunks, int per, int srows, int lrows,
                                     void *stream) {
  if (B < 1 || L < 1 || heads < 1 || local_heads < 0 || local_heads > heads || d % heads ||
      (local_heads > 0 && (window < 4 || window % 4 || L % window)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *x = static_cast<const bf16 *>(qkv);
  bf16 *o = static_cast<bf16 *>(out);
  int8_t *q = static_cast<int8_t *>(q8), *k = static_cast<int8_t *>(k8),
         *v = static_cast<int8_t *>(v8);
  float *a = static_cast<float *>(sq), *c = static_cast<float *>(sk),
        *e = static_cast<float *>(sv), *w = static_cast<float *>(ws);
  uint8_t *p = static_cast<uint8_t *>(pq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / heads) {
    case 32:
      return launch<32>(x, o, q, a, k, c, v, e, w, p, B, L, d, heads, local_heads, window,
                        quant_rows, chunks, per, srows, lrows, s);
    case 64:
      return launch<64>(x, o, q, a, k, c, v, e, w, p, B, L, d, heads, local_heads, window,
                        quant_rows, chunks, per, srows, lrows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
