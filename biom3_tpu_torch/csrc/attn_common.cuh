// Softmax attention over a key range, shared by the Stage-3 band-local
// heads (stage3_attn.cu) and the BERT tower's dense heads (dense_attn.cu).
//
// S threads cooperate on one query row: each walks every S-th key of the
// range with a running (max, sum, acc) — an online softmax in f32 that
// rescales only when the running max grows — and the S partial states
// merge through warp shuffles at the end.  Keys and values stream through
// shared memory in tiles of TK rows; the padded row stride keeps the S
// different rows a warp reads at one time in distinct banks.
#pragma once

#include "common.cuh"

namespace b3 {

constexpr int TK = 128;  // key rows per shared-memory tile
constexpr int S = 4;     // threads per query row

// q/k/v rows are read from a packed (rows, row_stride) bf16 buffer at the
// given column offsets; keys [k_lo, k_hi) of batch b; the output row goes
// to `out` at column out_col.  blockDim.x = TQ * S; query of this thread is
// q_row0 + threadIdx.x / S (skipped if >= q_end).
template <int DH>
__device__ void attend_range(const bf16 *__restrict__ base, int row_stride, int q_col,
                             int k_col, int v_col, int q_row0, int q_end, int k_lo,
                             int k_hi, float scale, bf16 *__restrict__ out,
                             int out_stride, int out_col) {
  constexpr int PAD = DH + 8;
  __shared__ __align__(16) bf16 Ks[TK][PAD];
  __shared__ __align__(16) bf16 Vs[TK][PAD];

  const int t = threadIdx.x, sub = t % S;
  const int qi = q_row0 + t / S;
  const bool active = qi < q_end;

  float q[DH];
  if (active) {
    const bf16 *qp = base + (size_t)qi * row_stride + q_col;
#pragma unroll
    for (int c = 0; c < DH; c += 8) {
      unpack8(*reinterpret_cast<const uint4 *>(qp + c), q + c);
    }
#pragma unroll
    for (int c = 0; c < DH; ++c) q[c] *= scale;
  }
  float m = -INFINITY, s = 0.f, acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = 0.f;

  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  for (int k0 = k_lo; k0 < k_hi; k0 += TK) {
    const int n = min(TK, k_hi - k0);
    __syncthreads();  // previous tile fully consumed
    for (int v = t; v < n * VPR; v += blockDim.x) {
      const int r = v / VPR, c = (v % VPR) * 8;
      const bf16 *row = base + (size_t)(k0 + r) * row_stride;
      *reinterpret_cast<uint4 *>(&Ks[r][c]) =
          *reinterpret_cast<const uint4 *>(row + k_col + c);
      *reinterpret_cast<uint4 *>(&Vs[r][c]) =
          *reinterpret_cast<const uint4 *>(row + v_col + c);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = sub; j < n; j += S) {
      float kv[8], sc = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        unpack8(*reinterpret_cast<const uint4 *>(&Ks[j][c]), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) sc = fmaf(q[c + e], kv[e], sc);
      }
      if (sc > m) {
        const float corr = __expf(m - sc);  // 0 on the first key
        s *= corr;
#pragma unroll
        for (int c = 0; c < DH; ++c) acc[c] *= corr;
        m = sc;
      }
      const float p = __expf(sc - m);
      s += p;
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        unpack8(*reinterpret_cast<const uint4 *>(&Vs[j][c]), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[c + e] = fmaf(p, kv[e], acc[c + e]);
      }
    }
  }

  // merge the S partial softmax states of this query (lanes t..t+S-1)
#pragma unroll
  for (int off = 1; off < S; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, mo);
    const float a = (m == -INFINITY) ? 0.f : __expf(m - mn);
    const float b = (mo == -INFINITY) ? 0.f : __expf(mo - mn);
    s = s * a + so * b;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[c], off);
      acc[c] = acc[c] * a + ao * b;
    }
    m = mn;
  }
  if (!active) return;
  const float inv = 1.f / s;
  constexpr int PER = DH / S;  // output channels written by this thread
  float o[PER];
#pragma unroll
  for (int c = 0; c < DH; ++c) {
    // static indexing only: select this thread's slice without a dynamic
    // index into acc[], which would spill it to local memory
    if (c / PER == sub) o[c % PER] = acc[c] * inv;
  }
  bf16 *op = out + (size_t)qi * out_stride + out_col + sub * PER;
#pragma unroll
  for (int c = 0; c < PER; c += 8) *reinterpret_cast<uint4 *>(op + c) = pack8(o + c);
}

}  // namespace b3
