// gather_head — the l == depth-1 epilogue of the Stage-3 stack kernel
// (biom3_tpu/ops/pallas/stack_kernel_tpu.py:765 fused_stack_logits,
// :562-581): gather the k decode positions of h, final LayerNorm (two-pass
// statistics in f32, eps passed in), hn rounded to bf16 (the TPU kernel's
// hn.astype(cdtype)), then hn · head accumulated in f32, plus the bias.
//
// k runs from 1 (exact mode) to L (confidence order and MaskGIT rank the
// whole grid: 32768 rows of 512 at Stage-3 B=32, 34 MB of h to read), so
// the kernel is built for the rows' bytes:
//
// * tiles of 64 gathered rows; a block of three warpgroups an SM (its
//   shared memory: three tile buffers and the head), each block walking
//   tiles gridDim apart, so k <= 8 (one to four tiles) spreads a tile over
//   12 warps and k = L keeps every SM busy;
// * the rows arrive by cp.async straight into a tile buffer laid out as
//   the product's A operand, two tiles ahead of the one being normalised
//   (128 KB in flight an SM at d = 512), pos read a tile ahead of the
//   copies that need it;
// * each warp normalises its 5 or 6 rows of a tile in place, a lane
//   reading back the 16-byte chunks it copied, 3 rows at a time (sum, then
//   centred sum of squares, by shuffles; for d = 256·NC with no branch);
//   the normalising is what bounds the kernel on the SM (issue slots), so
//   the 12 warps share it and the product runs beside it;
// * hn stays in shared memory as bf16 under the 128-byte swizzle, the
//   layout wgmma's descriptors read, and the head product runs on the
//   tensor cores, one warpgroup in turn a tile: wgmma m64n32k16, A the hn
//   tile, B the head — packed once with the weights as (d, 32), zero
//   columns past C (ops/kernels.pad_head) — staged once a block,
//   transposed to K-major in 8x8 register blocks (eight 16-byte loads,
//   byte permutes, eight 16-byte stores);
// * d > 512 runs in slabs of 512 columns, one warpgroup a block: a
//   statistics pass over each row (global memory, as layernorm's rows too
//   wide for a block), then per slab the head's and hn's columns staged and
//   multiplied in.
//
// No float atomics and a fixed order everywhere: the same bits from call to
// call.
#include <algorithm>

#include "hopper_gemm.cuh"

namespace {

using hopper::fence_regs;
using hopper::smem_addr;
using hopper::smem_desc;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int GH_ROWS = 64;            // gathered rows a tile: one warpgroup's m64
constexpr int GH_THREADS = 128;        // one warpgroup
constexpr int GH_N = 32;               // classes of the packed head (n32 products)
constexpr int GH_GROUP = 3;            // rows a warp normalises at once (of its 5 or 6)
constexpr int GH_WG = 3;               // warpgroups, and tile buffers, a one-slab block
constexpr int GH_SLAB = 512;           // hn columns in shared memory at once
constexpr int A_BLOCK = GH_ROWS * 128; // bytes of 64 columns of the hn tile
constexpr int B_BLOCK = GH_N * 128;    // bytes of 64 columns (K) of the head

// Shared memory of a block: the head's columns, `tiles` hn tiles, the slab
// kernel's row statistics, and 1024 bytes of alignment slack.
__host__ __device__ constexpr int gh_smem(int cols, int tiles) {
  return (cols + 63) / 64 * (tiles * A_BLOCK + B_BLOCK) + GH_ROWS * 8 + 1024;
}

// Byte offset of 16-byte chunk j (8 columns, 0..7) of row r inside a block
// of 64 columns under the 128-byte swizzle (8-row atoms of 1024 bytes).
__device__ __forceinline__ int swz(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }

// D(64x32 f32) (+)= A(64x16) · B(16x32), both K-major B128 tiles; acc = 0
// overwrites D.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void load8f(float (&v)[8], const float *__restrict__ p) {
  const float4 a = reinterpret_cast<const float4 *>(p)[0], b = reinterpret_cast<const float4 *>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Columns [c0, c0 + nk) of the (d, 32) head → shared memory as 32 K-major
// rows (one a class) of 64-column blocks, by every thread of the block: an
// 8x8 block (8 K rows of 8 classes) a thread at a time, eight 16-byte
// loads, transposed by byte permutes, eight 16-byte stores; up to two
// blocks' loads in flight (nk <= 512).
__device__ __forceinline__ void stage_head(uint8_t *bs, const bf16 *__restrict__ hw, int c0,
                                           int nk) {
  const int items = nk / 8 * (GH_N / 8);   // 8x8 blocks
  for (int u0 = threadIdx.x; u0 < items; u0 += 2 * blockDim.x) {
    uint4 v[2][8];
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int u = u0 + it * blockDim.x;
      if (u >= items) continue;
      const bf16 *src = hw + (size_t)(c0 + (u / (GH_N / 8)) * 8) * GH_N + (u % (GH_N / 8)) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[it][i] = *reinterpret_cast<const uint4 *>(src + i * GH_N);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int u = u0 + it * blockDim.x;
      if (u >= items) continue;
      const int kr = (u / (GH_N / 8)) * 8, n0 = (u % (GH_N / 8)) * 8;
      uint8_t *blk = bs + (kr >> 6) * B_BLOCK;
      const int j = (kr & 63) >> 3;
      const uint32_t *w = reinterpret_cast<const uint32_t *>(v[it]);   // w[4i + c/2]
#pragma unroll
      for (int c = 0; c < 8; ++c) {   // class n0 + c: K rows kr .. kr + 7
        const uint32_t sel = (c & 1) ? 0x7632u : 0x5410u;
        uint4 o;
        o.x = __byte_perm(w[0 * 4 + c / 2], w[1 * 4 + c / 2], sel);
        o.y = __byte_perm(w[2 * 4 + c / 2], w[3 * 4 + c / 2], sel);
        o.z = __byte_perm(w[4 * 4 + c / 2], w[5 * 4 + c / 2], sel);
        o.w = __byte_perm(w[6 * 4 + c / 2], w[7 * 4 + c / 2], sel);
        *reinterpret_cast<uint4 *>(blk + swz(n0 + c, j)) = o;
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the stores → wgmma
}

// acc (+)= hn tile · head over nk columns (nk % 16 == 0; first: acc is
// overwritten), then wait for it.  The caller has synchronised the block
// after its hn stores and their proxy fence.
__device__ __forceinline__ void head_product(float (&acc)[16], const uint8_t *as,
                                             const uint8_t *bs, int nk, bool first) {
  wgmma_fence();
  for (int kb = 0; kb * 64 < nk; ++kb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kb * 64 + kk * 16 < nk)
        wgmma_n32(acc, smem_desc(as + kb * A_BLOCK + kk * 32, 16, 1024),
                  smem_desc(bs + kb * B_BLOCK + kk * 32, 16, 1024), !(first && kb + kk == 0));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The same over d = 16·NKS columns known at compile time: the k-steps
// unrolled with no branch between them, so the products issue back to back.
template <int NKS>
__device__ __forceinline__ void head_product_k(float (&acc)[16], const uint8_t *as,
                                               const uint8_t *bs) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
    wgmma_n32(acc, smem_desc(as + (ks >> 2) * A_BLOCK + (ks & 3) * 32, 16, 1024),
              smem_desc(bs + (ks >> 2) * B_BLOCK + (ks & 3) * 32, 16, 1024), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// Accumulator rows of this thread: warp w, rows 16w + lane/4 (+ 8); its
// columns 8q + 2·(lane % 4) + e of the register pair q.
__device__ __forceinline__ void store_tile(const float (&acc)[16], const float (&bias)[8],
                                           float *__restrict__ out, int row0, int rows, int C) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;   // in its warpgroup
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + warp * 16 + (lane >> 2) + 8 * hh;
    if (r >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * q + 2 * (lane & 3) + e;
        if (col < C) out[(size_t)r * C + col] = acc[4 * q + 2 * hh + e] + bias[2 * q + e];
      }
  }
}

__device__ __forceinline__ void load_bias(float (&bias)[8], const float *__restrict__ hb, int C) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * q + 2 * (lane & 3) + e;
      bias[2 * q + e] = col < C ? hb[col] : 0.f;
    }
}

__device__ __forceinline__ uint8_t *align1024(uint8_t *raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// Row r of the gathered rows: (b, j) = (r / k, r % k), h row pos[r] of batch b.
__device__ __forceinline__ const bf16 *row_src(const bf16 *__restrict__ h,
                                               const int *__restrict__ pos, int r, int L, int k,
                                               int d) {
  return h + ((size_t)(r / k) * L + pos[r]) * d;
}

// The rows of a tile a warp owns: tile rows base + j·step, j < count.
struct WarpRows {
  int base, step, count;
  // rows of tile `tile` below `rows`
  __device__ __forceinline__ int live(int tile, int rows) const {
    const int left = rows - tile * GH_ROWS - base;
    return left <= 0 ? 0 : min(count, (left + step - 1) / step);
  }
};

// Copies of this warp's rows of tile `tile` into `buf` (the swizzled hn
// layout), lane l taking 16-byte chunks l, l + 32, ...; rows past `rows`
// are not copied (their products are never stored).  `p` is the h row
// (pos) of the warp's row j, held by lane j.  One commit group, empty past
// the last tile.
__device__ __forceinline__ void issue_rows(uint8_t *buf, const bf16 *__restrict__ h, int p,
                                           const WarpRows &wr, int tile, int rows, int L, int k,
                                           int d) {
  const int lane = threadIdx.x & 31, chunks = d / 8, live = wr.live(tile, rows);
  for (int j = 0; j < live; ++j) {
    const int rl = wr.base + j * wr.step, r = tile * GH_ROWS + rl;
    const bf16 *src = h + ((size_t)(r / k) * L + __shfl_sync(0xffffffffu, p, j)) * d;
    for (int cc = lane; cc < chunks; cc += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(buf + (cc >> 3) * A_BLOCK + swz(rl, cc & 7))),
                   "l"(src + cc * 8)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// pos of this warp's row `lane` of tile `tile` (0 past the rows).
__device__ __forceinline__ int row_pos(const int *__restrict__ pos, const WarpRows &wr,
                                       int tile, int rows) {
  const int lane = threadIdx.x & 31;
  return lane < wr.live(tile, rows) ? pos[tile * GH_ROWS + wr.base + lane * wr.step] : 0;
}

// d <= 256·NC <= 512 (one slab): a block of GH_WG warpgroups walks tiles
// gridDim apart through three tile buffers.  At step i its 12 warps
// normalise tile i in place, 5 or 6 rows each — a lane reads back the
// chunks it copied, three rows at a time, groups past the last row skipped
// — and after one barrier warpgroup i % 3 multiplies the tile by the
// staged head on the tensor cores and stores its logits, while the other
// warps go on: they copy the rows of tile i + 2 into the buffer tile i - 1
// left (its product ended before the barrier) and normalise tile i + 1.
// Two tiles' rows are in flight while one is normalised and one multiplied.
template <int NC, bool FULL>
__global__ void __launch_bounds__(GH_WG * GH_THREADS, 1)
gather_head_kernel(const bf16 *__restrict__ h, const int *__restrict__ pos,
                   const float *__restrict__ scale, const float *__restrict__ shift,
                   const bf16 *__restrict__ hw, const float *__restrict__ hb,
                   float *__restrict__ out, int rows, int L, int k, int d, int C, float eps) {
  extern __shared__ uint8_t gh_raw[];
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, gw = threadIdx.x >> 5;
  constexpr int NW = GH_WG * 4;
  const int nkb = (d + 63) / 64;
  uint8_t *bs = align1024(gh_raw);
  auto tile_buf = [&](int j) { return bs + nkb * (B_BLOCK + j * A_BLOCK); };
  const int tiles = (rows + GH_ROWS - 1) / GH_ROWS, G = gridDim.x;
  const float inv_d = 1.0f / d;
  const WarpRows wr{gw, NW, (GH_ROWS - gw + NW - 1) / NW};
  // a lane's chunk c of a row is chunk lane + 32c (it copied it); with FULL
  // (d = 256·NC) every lane has NC, and the loops below have no branch
  auto has = [&](int c) { return FULL || (lane + 32 * c) * 8 < d; };
  int t = blockIdx.x;
  // the first two tiles in flight while the head is staged; the pos of the
  // third loaded a tile ahead of its copies
  const int p0 = row_pos(pos, wr, t, rows), p1 = row_pos(pos, wr, t + G, rows);
  int p = row_pos(pos, wr, t + 2 * G, rows);
  issue_rows(tile_buf(0), h, p0, wr, t, rows, L, k, d);
  issue_rows(tile_buf(1), h, p1, wr, t + G, rows, L, k, d);
  stage_head(bs, hw, 0, d);
  float g[NC][8], b[NC][8], bias[8];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (has(i)) {
      load8f(g[i], scale + lane * 8 + i * 256);
      load8f(b[i], shift + lane * 8 + i * 256);
    }
  }
  load_bias(bias, hb, C);
  __syncthreads();   // the head is staged
  for (int step = 0; t < tiles; ++step, t += G) {
    uint8_t *buf = tile_buf(step % 3);
    uint4 *buf4 = reinterpret_cast<uint4 *>(buf);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // this tile's copies
    const int live = wr.live(t, rows);
#pragma unroll 1
    for (int grp = 0; grp * GH_GROUP < live; ++grp) {
      int at[GH_GROUP][NC];   // uint4 index of row i's chunk c
      float v[GH_GROUP][NC][8], s[GH_GROUP], q[GH_GROUP];
#pragma unroll
      for (int i = 0; i < GH_GROUP; ++i) {
        const int rl = wr.base + min(grp * GH_GROUP + i, wr.count - 1) * wr.step;
        s[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int cc = lane + 32 * c;
          at[i][c] = (cc >> 3) * (A_BLOCK / 16) + rl * 8 + ((cc & 7) ^ (rl & 7));
          if (has(c)) {
            unpack8(buf4[at[i][c]], v[i][c]);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[i] += v[i][c][e];
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < GH_GROUP; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
#pragma unroll
      for (int i = 0; i < GH_GROUP; ++i) {
        s[i] *= inv_d;   // the mean
        q[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (has(c))
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float x = v[i][c][e] - s[i];
              q[i] += x * x;
            }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < GH_GROUP; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
#pragma unroll
      for (int i = 0; i < GH_GROUP; ++i) {
        const float rstd = rsqrtf(q[i] * inv_d + eps);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!has(c)) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[i][c][e] = (v[i][c][e] - s[i]) * rstd * g[c][e] + b[c][e];
          buf4[at[i][c]] = pack8(v[i][c]);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // hn stores → wgmma
    __syncthreads();
    if (wg == step % 3) {
      float acc[16];
      if constexpr (FULL) head_product_k<NC * 16>(acc, buf, bs);
      else head_product(acc, buf, bs, d, true);
      store_tile(acc, bias, out, t * GH_ROWS, rows, C);
    }
    issue_rows(tile_buf((step + 2) % 3), h, p, wr, t + 2 * G, rows, L, k, d);
    p = row_pos(pos, wr, t + 3 * G, rows);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d > GH_SLAB: statistics from global memory, then slab by slab.
__global__ void __launch_bounds__(GH_THREADS)
gather_head_slab_kernel(const bf16 *__restrict__ h, const int *__restrict__ pos,
                        const float *__restrict__ scale, const float *__restrict__ shift,
                        const bf16 *__restrict__ hw, const float *__restrict__ hb,
                        float *__restrict__ out, int rows, int L, int k, int d, int C,
                        float eps) {
  extern __shared__ uint8_t gh_raw[];
  uint8_t *bs = align1024(gh_raw);
  uint8_t *as = bs + GH_SLAB / 64 * B_BLOCK;
  float2 *stats = reinterpret_cast<float2 *>(as + GH_SLAB / 64 * A_BLOCK);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (rows + GH_ROWS - 1) / GH_ROWS;
  float bias[8];
  load_bias(bias, hb, C);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int i = 0; i < 16; ++i) {
      const int rl = warp * 16 + i, r = t * GH_ROWS + rl;
      if (r >= rows) continue;
      const bf16 *src = row_src(h, pos, r, L, k, d);
      float v[8], s = 0.f;
      for (int c = lane * 8; c < d; c += 256) {
        unpack8(*reinterpret_cast<const uint4 *>(src + c), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
      const float mean = warp_sum(s) / d;
      float q = 0.f;
      for (int c = lane * 8; c < d; c += 256) {
        unpack8(*reinterpret_cast<const uint4 *>(src + c), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = v[e] - mean;
          q += x * x;
        }
      }
      q = warp_sum(q);
      if (lane == 0) stats[rl] = make_float2(mean, rsqrtf(q / d + eps));
    }
    __syncwarp();
    float acc[16];
    for (int c0 = 0; c0 < d; c0 += GH_SLAB) {
      const int nk = min(GH_SLAB, d - c0);
      stage_head(bs, hw, c0, nk);
      for (int i = 0; i < 16; ++i) {
        const int rl = warp * 16 + i, r = t * GH_ROWS + rl;
        if (r >= rows) continue;
        const bf16 *src = row_src(h, pos, r, L, k, d) + c0;
        const float2 st = stats[rl];
        for (int c = lane * 8; c < nk; c += 256) {
          float v[8];
          unpack8(*reinterpret_cast<const uint4 *>(src + c), v);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (v[e] - st.x) * st.y * scale[c0 + c + e] + shift[c0 + c + e];
          *reinterpret_cast<uint4 *>(as + (c >> 6) * A_BLOCK + swz(rl, (c >> 3) & 7)) = pack8(v);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // hn stores → wgmma
      __syncthreads();
      head_product(acc, as, bs, nk, c0 == 0);
      __syncthreads();   // the product has read the slab before it is rewritten
    }
    store_tile(acc, bias, out, t * GH_ROWS, rows, C);
  }
}

// The one-slab kernel: its shared-memory ceiling set once, at the widest
// one-slab row, and its blocks an SM read once (one: its registers).
template <int NC, bool FULL>
int launch_tiles(int smem, int tiles, const void *h, const void *pos, const void *scale,
                 const void *shift, const void *hw, const void *hb, void *out, int rows, int L,
                 int k, int d, int C, float eps, cudaStream_t stream) {
  const auto kernel = gather_head_kernel<NC, FULL>;
  const int threads = GH_WG * GH_THREADS;
  static int per_sm = -1;   // one for each instantiation
  if (per_sm < 0) {
    const int most = gh_smem(GH_SLAB, GH_WG);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, most);
    per_sm = std::max(n, 1);
  }
  const int grid = std::min(tiles, per_sm * hopper::sm_count());
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16 *>(h), static_cast<const int *>(pos),
      static_cast<const float *>(scale), static_cast<const float *>(shift),
      static_cast<const bf16 *>(hw), static_cast<const float *>(hb), static_cast<float *>(out),
      rows, L, k, d, C, eps);
  return static_cast<int>(cudaGetLastError());
}

int launch_slabs(int smem, int tiles, const void *h, const void *pos, const void *scale,
                 const void *shift, const void *hw, const void *hb, void *out, int rows, int L,
                 int k, int d, int C, float eps, cudaStream_t stream) {
  const auto kernel = gather_head_slab_kernel;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GH_THREADS, smem);
  const int grid = std::min(tiles, std::max(per_sm, 1) * hopper::sm_count());
  kernel<<<grid, GH_THREADS, smem, stream>>>(
      static_cast<const bf16 *>(h), static_cast<const int *>(pos),
      static_cast<const float *>(scale), static_cast<const float *>(shift),
      static_cast<const bf16 *>(hw), static_cast<const float *>(hb), static_cast<float *>(out),
      rows, L, k, d, C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h (B, L, d) bf16, pos (B, k) int32, scale/shift (d,) f32, hw (d, 32) bf16
// (zero columns past C), hb (C,) f32 → out (B, k, C) f32.  d % 16 == 0,
// C <= 32 (the wrapper checks).
B3_EXPORT int b3_gather_head(const void *h, const void *pos, const void *scale,
                             const void *shift, const void *hw, const void *hb, void *out,
                             int B, int L, int k, int d, int C, float eps, void *stream) {
  const int rows = B * k, tiles = (rows + GH_ROWS - 1) / GH_ROWS;
  if (rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int smem = gh_smem(d, GH_WG);
  if (d == 256)
    return launch_tiles<1, true>(smem, tiles, h, pos, scale, shift, hw, hb, out, rows, L, k, d,
                                 C, eps, s);
  if (d == GH_SLAB)
    return launch_tiles<2, true>(smem, tiles, h, pos, scale, shift, hw, hb, out, rows, L, k, d,
                                 C, eps, s);
  if (d < 256)
    return launch_tiles<1, false>(smem, tiles, h, pos, scale, shift, hw, hb, out, rows, L, k,
                                  d, C, eps, s);
  if (d < GH_SLAB)
    return launch_tiles<2, false>(smem, tiles, h, pos, scale, shift, hw, hb, out, rows, L, k,
                                  d, C, eps, s);
  return launch_slabs(gh_smem(GH_SLAB, 1), tiles, h, pos, scale, shift, hw, hb, out, rows, L, k,
                      d, C, eps, s);
}
