// Tensor-core softmax attention for Hopper, shared by flash_attention
// (flash_attn.cu), dense_attention (dense_attn.cu), esm2_attention
// (esm2_attn.cu), esm2_attention_bwd (esm2_attn_bwd.cu), the bf16
// local_window_attention (local_attn.cu, a band of keys) and the band heads
// of stage3_attention_core (stage3_attn.cu) and stage3_attention_bwd
// (stage3_attn_bwd.cu): head dim 64
// tiles in shared memory loaded by TMA, products on wgmma, an online f32
// softmax in the accumulator registers.
//
// Every operand is a (rows, 64) bf16 tile of one head: 64 rows of 128
// bytes under the TMA's 128-byte swizzle (8-row atoms of 1024 bytes), the
// layout wgmma's B128 descriptors read.  The maps are 3-D, (Dh, L, heads),
// with a (64, rows, 1) box, so the TMA zero-fills the rows past a head's
// end (a 2-D map would read the next head's rows into a ragged last tile)
// and, for head dim 32, columns 32..63: the products then run at 64 wide
// on zeros, and the stores keep the real columns.  One tile serves both
// operand majors: read K-major (rows contiguous along the reduced dim) for
// S = Q·Kᵀ, and MN-major (the transpose bit) for P·V, where the reduced
// dim runs down the rows.
//
// Accumulator layout of an m64n64 f32 product (32 registers a thread):
// warp w of the warpgroup holds rows 16w + lane/4 (registers 4q, 4q + 1)
// and 16w + lane/4 + 8 (4q + 2, 4q + 3) of each 8-column group q, columns
// 8q + 2·(lane % 4) + {0, 1}.  The four lanes of a quad share a row, so a
// row reduction is two shuffles; and the registers of columns 16kk .. 16kk
// + 15, packed to bf16 pairs in order, are the A fragment of the k-step kk
// of a register-A wgmma (as FlashAttention-3 feeds P to P·V): P never
// goes through shared memory.
//
// The block: NWG consumer warpgroups of 64 rows each and one producer warp
// whose lane 0 starts every TMA load, handed over by mbarrier pairs as in
// hopper_gemm.cuh.  Softmax in log2 units (exp2f): a score s becomes
// s·log2(e); the statistics a kernel keeps are in those units.
#pragma once

#include <math.h>

#include "hopper_gemm.cuh"

namespace attn {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;
using hopper::smem_desc;
using hopper::tma_load_3d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int TILE = 64;                       // rows of a streamed tile; rows of a warpgroup
constexpr int TILE_BYTES = TILE * 128;         // 64 rows of 64 bf16
constexpr float MASKED = -1e9f;                // score of a PAD key
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- host

// (Dh, L, n) bf16 rows, contiguous per head → a map of (64, TILE, 1)
// boxes under the 128-byte swizzle; Dh 32 boxes are zero-filled past it.
inline int encode_heads(CUtensorMap *map, const void *ptr, int dh, int L, int n) {
  const uint64_t dims[3] = {(uint64_t)dh, (uint64_t)L, (uint64_t)n};
  const uint64_t strides[2] = {(uint64_t)dh * 2, (uint64_t)L * dh * 2};
  const uint32_t box[3] = {64, TILE, 1};
  return hopper::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims, strides, box);
}

// ---------------------------------------------------------------- device

#define AH_R8(C, d, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define AH_R32(C, d) AH_R8(C, d, 0), AH_R8(C, d, 8), AH_R8(C, d, 16), AH_R8(C, d, 24)
#define AH_OPS32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D(64x64 f32) (+)= A(64x16, K-major tile) · B(16x64); TB = 1: B MN-major.
// acc = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AH_OPS32
      ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : AH_R32("+f", d)
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// D(64x64 f32) += A(64x16 bf16, registers) · B(16x64); TB = 1: B MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AH_OPS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : AH_R32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// Descriptor of k-step kk (16 elements of the reduced dim) of a tile read
// K-major (32 bytes along each row) or MN-major (16 rows down).
__device__ __forceinline__ uint64_t desc_k(const uint8_t *tile, int kk) {
  return smem_desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(const uint8_t *tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, TILE_BYTES, 1024);
}

// S (+)= A·Bᵀ over the reduced dim: both tiles K-major.  KSTEPS = 4 takes
// the tiles' 64 columns; 2 takes the first 32 (head dim 32, whose columns
// 32..63 are zeros).
template <int KSTEPS = 4>
__device__ __forceinline__ void product_nt(float (&d)[32], const uint8_t *a, const uint8_t *b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss<0>(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// D += P·B, P (64 x 64) as A fragments, B the tile read MN-major.
__device__ __forceinline__ void product_pv(float (&d)[32], const uint32_t (&a)[4][4],
                                           const uint8_t *b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(d, a[kk], desc_mn(b, kk));
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The first 1024-byte-aligned byte of a dynamic shared-memory block (the
// 128-byte swizzle's atoms).
__device__ __forceinline__ uint8_t *aligned_smem(uint8_t *raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// A ring of STAGES (full, empty) barrier pairs, emptied by one arrive per
// consumer warp of NWG warpgroups, and one barrier for the tiles a block
// loads once; thread 0 initialises them (the caller synchronises).
template <int STAGES, int NWG>
__device__ __forceinline__ void init_ring(uint64_t *full, uint64_t *empty, uint64_t *once) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t *>(&h);
}

// Accumulator-layout values → bf16 A fragments of the four k-steps.
__device__ __forceinline__ void to_frags(const float (&p)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Column of register pair q (8-column group) and element e of this lane.
__device__ __forceinline__ int acc_col(int q, int e, int lane) { return 8 * q + 2 * (lane % 4) + e; }
// Row (0..63) of this thread's half h (registers 4q + 2h + e) in its warpgroup.
__device__ __forceinline__ int acc_row(int h, int warp, int lane) {
  return (warp % 4) * 16 + lane / 4 + 8 * h;
}

// One past the last non-PAD key of a (L,) PAD row, or L when every key is
// PAD; every thread of the block calls it (it synchronises the block).
// Key tiles past it may be skipped when a real key exists: a −1e9 key's
// weight exp(−1e9 − max) is 0 in f32.
__device__ __forceinline__ int block_live_keys(const int *__restrict__ key_pad, int L) {
  __shared__ int hi;
  if (threadIdx.x == 0) hi = 0;
  __syncthreads();
  int mine = 0;
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    if (!key_pad[j]) mine = j + 1;
  atomicMax(&hi, mine);
  __syncthreads();
  return hi ? hi : L;
}

// The PAD flags of the 64 keys of the tile at k0 (bit c: key k0 + c), 0
// without a mask; keys >= L read as not PAD.  Every lane of the warp calls
// it: two loads and two ballots a warp.
__device__ __forceinline__ uint64_t pad_mask(const int *__restrict__ key_pad, int k0, int L,
                                             int lane) {
  if (!key_pad) return 0;
  const int j0 = k0 + lane, j1 = j0 + 32;
  const uint32_t lo = __ballot_sync(0xffffffffu, j0 < L && __ldg(key_pad + j0));
  const uint32_t hi = __ballot_sync(0xffffffffu, j1 < L && __ldg(key_pad + j1));
  return (uint64_t)hi << 32 | lo;
}

// Key bands.  NoBand: every key < L is a key of every query row.
// WindowBand: the row of window w = row / W sees keys [(w−1)·W, (w+2)·W)
// only (local_window_attention's three windows; keys past L and before 0
// fall away on their own), the rest score −inf.  The sweep also skips a
// key tile outside every row of its warpgroup.
struct NoBand {
  static constexpr bool kBand = false;
  __device__ __forceinline__ bool masked(int, int) const { return false; }
};

struct WindowBand {
  static constexpr bool kBand = true;
  int lo[2];            // first key of this thread's two rows' bands (may be −W)
  unsigned span;        // 3W keys a band
  int wg_lo, wg_hi;     // the union of the warpgroup's valid rows' bands
  // row0: the warpgroup's first query row.
  __device__ __forceinline__ WindowBand(int row0, int window, int L, int warp, int lane)
      : span(3u * window) {
#pragma unroll
    for (int h = 0; h < 2; ++h) lo[h] = ((row0 + acc_row(h, warp, lane)) / window - 1) * window;
    const int last = min(row0 + TILE, L) - 1;   // < row0: no valid row, no tile
    wg_lo = (row0 / window - 1) * window;
    wg_hi = last < row0 ? wg_lo : (last / window + 2) * window;
  }
  __device__ __forceinline__ bool masked(int h, int key) const {
    return (unsigned)(key - lo[h]) >= span;
  }
  __device__ __forceinline__ bool touches(int k0) const { return k0 < wg_hi && k0 + TILE > wg_lo; }
};

// Scores of a (64 queries x 64 keys) tile at k0 → log2 units in place:
// s·scale, a PAD key at −1e9 (FILL: the score replaced, as a masked fill;
// else −1e9 added, as the ESM2 kernels add their pad bias), a key >= L at
// −inf (excluded: it is not a key of the head), as is a key outside the
// row's band.  The products are rounded
// (__fmul_rn, never contracted into an FMA), so a kernel that recomputes a
// score gets the same f32 value: an all-PAD row's scores sit near
// −1.44e9, where the f32 spacing is 128, and an unrounded product would
// move exp2(s − m) by up to 2^64.
template <bool FILL, class Band = NoBand>
__device__ __forceinline__ void mask_scores(float (&s)[32], uint64_t pad, int k0, int L,
                                            float scale, int lane, const Band &band = Band{}) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = acc_col(q, e, lane);
      const bool is_pad = (pad >> c) & 1u, out = k0 + c >= L;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float &v = s[4 * q + 2 * h + e];
        float x = __fmul_rn(v, scale);
        if (is_pad) x = FILL ? MASKED : x + MASKED;
        v = out || band.masked(h, k0 + c) ? -INFINITY : __fmul_rn(x, LOG2E);
      }
    }
}

// Online-softmax step of one tile for this thread's two rows: raise the
// running max m (log2 units) by the tile's row max, return each row's
// correction factor exp2(m_old − m_new) and turn s into p̃ = exp2(s − m).
// Without a band every tile holds a key < L, so the row max is finite.
// BAND: a row may have seen no key of its band yet (m = −inf); it then
// takes 0 as its reference, so p̃ = 0 and corr = 0, not NaN.
template <bool BAND = false>
__device__ __forceinline__ void online_step(float (&s)[32], float (&m)[2], float (&corr)[2]) {
  float ref[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < 8; ++q) mx = fmaxf(mx, fmaxf(s[4 * q + 2 * h], s[4 * q + 2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(mx));
    ref[h] = BAND && mn == -INFINITY ? 0.f : mn;
    corr[h] = exp2f(m[h] - ref[h]);  // 0 on the first tile (m = −inf)
    m[h] = mn;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[4 * q + i] = exp2f(s[4 * q + i] - ref[i / 2]);
}

// The forward sweep of one warpgroup over the key tiles at k_lo + t·TILE,
// t in [0, tiles), of a ring of (K, V) stages: o = Σ p̃·V and l = Σ p̃
// (quad-summed, f32) for this thread's two rows, p̃ = exp2(s − m) rounded
// to bf16 for P·V.  q_tile: the warpgroup's 64 query rows; stage
// t % STAGES holds K at +0 and V at +TILE_BYTES; lane 0 of each warp
// arrives on empty once a stage is used (or skipped: a WindowBand tile
// outside the warpgroup's rows' bands).
template <int STAGES, bool FILL, class Band>
__device__ __forceinline__ void forward_sweep(const uint8_t *q_tile, const uint8_t *ring,
                                              int stage_bytes, uint64_t *full, uint64_t *empty,
                                              int k_lo, int tiles, const Band &band,
                                              const int *__restrict__ key_pad, int L,
                                              float scale, int lane, float (&o)[32],
                                              float (&l)[2]) {
  float s[32], m[2] = {-INFINITY, -INFINITY}, corr[2];
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.f;
  l[0] = l[1] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, k0 = k_lo + t * TILE;
    const uint64_t pad = pad_mask(key_pad, k0, L, lane);
    mbar_wait(&full[st], (t / STAGES) & 1);
    if constexpr (Band::kBand) {
      if (!band.touches(k0)) {
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
    }
    const uint8_t *kt = ring + st * stage_bytes, *vt = kt + TILE_BYTES;
    fence_regs(s);
    wgmma_fence();
    product_nt(s, q_tile, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mask_scores<FILL>(s, pad, k0, L, scale, lane, band);
    online_step<Band::kBand>(s, m, corr);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i / 2) % 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += s[4 * q + 2 * h] + s[4 * q + 2 * h + 1];
      l[h] = l[h] * corr[h] + sum;
    }
    to_frags(s, a);
    fence_regs(a);
    fence_regs(o);
    wgmma_fence();
    product_pv(o, a, vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

}  // namespace attn
