// esm2_attention_bwd: the gradient of esm2_attention (esm2_attn.cu) with
// respect to its fused [q | k | v] input: (qkv, dattn, PAD mask, rotary
// tables) → dqkv, all (B, L, ·) bf16, dq and dk in pre-rotation
// coordinates.  Every softmax is recomputed from qkv.
//
// Replaces the per-head backward of the TPU kernel
// biom3_tpu/ops/pallas/esm2_block_tpu.py:411 (_attn_bwd_call,
// _attn_bwd_kernel :193-261), at its rounding points: rotated q and k in
// bf16 (rope8, as the forward), s = q·kᵀ·Dh^-0.5 with −1e9 added on PAD
// keys (:218), f32 softmax, dV = bf16(p)ᵀ·dA, dP = dA·Vᵀ, D = Σ dP∘p,
// dS = bf16(p∘(dP − D)·Dh^-0.5), dQ = dS·K, dK = dSᵀ·Q in f32, then the
// adjoint of the rotation, dz = dy·cos + rotate_halfᵀ(bf16(dy·sin))
// (unrot, :202-208), rounded to bf16 (the TPU's bf16 dqkv staging).
//
// The TPU holds each head's whole (L, L) f32 score matrix in VMEM and sums
// dK/dV of all queries in one pass.  An SM has 227 KB of shared memory and
// blocks run in parallel, so the work is split the FlashAttention-2 way,
// with nothing shared between blocks and no atomics (deterministic):
// * pass 1, query-owned (one block per 64 query rows of a head): an online
//   sweep over the keys gives each row's max m, sum l and D; a second
//   sweep gives dQ; (m, 1/l, D) are saved per row.  m and 1/l rather than
//   a logsumexp: an all-PAD row has m = −1e9, where m + log(l) rounds
//   back to m.
// * pass 2, key-owned (one block per 64 key rows): loops over every query
//   row, recomputing p and dS from the saved statistics, and sums each
//   key row's dK/dV in a fixed order.
// Four threads share a row and split its head dim (16 channels each at Dh
// 64): the two dot products of a (query, key) pair are reduced by two
// shuffles, and each thread keeps only its slice of the accumulators (no
// spills), while all threads of a warp read the same shared tile row.
//
// PAD keys, as the forward (attn_common.cuh): a row walks keys only up to
// one past its batch row's last non-PAD key, and a key block past it
// writes zeros — exact, since p of a −1e9 key is 0 in f32 when a real key
// exists.  An all-PAD batch row attends uniformly (every score rounds to
// −1e9), so its gradient reaches every key and query as on the TPU.  PAD
// query rows are computed, as on the TPU.
//
// What bounds it on an H100: 10·Dh FLOP per (query, live key) pair on
// CUDA cores (the recomputed scores twice, dP twice, dQ, dK, dV), so the
// CUDA-core rate, as the forward; tensor-core (mma/wgmma) tiles are later
// work.
#include "attn_common.cuh"

namespace {

constexpr int S = 4;     // threads per row, each with DH / S channels
constexpr int TR = 64;   // rows a block owns
constexpr int TT = 64;   // streamed rows per shared-memory tile

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < S; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Σ over this thread's C channels of a[c]·row[c] (row in shared memory).
template <int C>
__device__ __forceinline__ float dot_slice(const float *a, const bf16 *row) {
  float s = 0.f, v[8];
#pragma unroll
  for (int c = 0; c < C; c += 8) {
    unpack8(*reinterpret_cast<const uint4 *>(row + c), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(a[c + e], v[e], s);
  }
  return s;
}

// acc[c] += w·row[c] over this thread's C channels.
template <int C>
__device__ __forceinline__ void axpy_slice(float w, const bf16 *row, float *acc) {
  float v[8];
#pragma unroll
  for (int c = 0; c < C; c += 8) {
    unpack8(*reinterpret_cast<const uint4 *>(row + c), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[c + e] = fmaf(w, v[e], acc[c + e]);
  }
}

template <int C>
__device__ __forceinline__ void load_slice(const bf16 *p, float *v) {
#pragma unroll
  for (int c = 0; c < C; c += 8) unpack8(*reinterpret_cast<const uint4 *>(p + c), v + c);
}

// 8 rotated columns [c, c + 8) of a head row (global memory), rotary
// tables at the row's position.
template <int DH>
__device__ __forceinline__ void rope_chunk(const bf16 *row, const bf16 *cs, const bf16 *sn,
                                           int c, float *out) {
  float x[8], partner[8], co[8], si[8];
  unpack8(*reinterpret_cast<const uint4 *>(row + c), x);
  unpack8(*reinterpret_cast<const uint4 *>(row + (c + DH / 2) % DH), partner);
  unpack8(*reinterpret_cast<const uint4 *>(cs + c), co);
  unpack8(*reinterpret_cast<const uint4 *>(sn + c), si);
  b3::rope8<DH>(c, x, partner, co, si, out);
}

// Rows [r0, r0 + n) of one head, rotated, into a shared tile.
template <int DH>
__device__ __forceinline__ void stage_rotated(bf16 (*dst)[DH + 8], const bf16 *head, size_t rs,
                                              const bf16 *cos, const bf16 *sin, int r0, int n) {
  for (int v = threadIdx.x; v < n * (DH / 8); v += blockDim.x) {
    const int r = v / (DH / 8), c = (v % (DH / 8)) * 8;
    const size_t row = (size_t)(r0 + r);
    float o[8];
    rope_chunk<DH>(head + row * rs, cos + row * DH, sin + row * DH, c, o);
    *reinterpret_cast<uint4 *>(&dst[r][c]) = pack8(o);  // exact: o holds bf16 values
  }
}

template <int DH>
__device__ __forceinline__ void stage_plain(bf16 (*dst)[DH + 8], const bf16 *head, size_t rs,
                                            int r0, int n) {
  for (int v = threadIdx.x; v < n * (DH / 8); v += blockDim.x) {
    const int r = v / (DH / 8), c = (v % (DH / 8)) * 8;
    *reinterpret_cast<uint4 *>(&dst[r][c]) =
        *reinterpret_cast<const uint4 *>(head + (size_t)(r0 + r) * rs + c);
  }
}

// The adjoint of the rotation on this thread's channels [c0, c0 + C) of a
// row's gradient d (the partner channels c ± DH/2 live in lane ^ S/2),
// stored as bf16 at dst + c0 unless dst is null.  Every lane must call it.
template <int DH>
__device__ __forceinline__ void unrotate_store(const float *d, const bf16 *cs, const bf16 *sn,
                                               int c0, bf16 *dst) {
  constexpr int C = DH / S;
  const int pc = (c0 + DH / 2) % DH;
  const float sign = c0 < DH / 2 ? 1.f : -1.f;
  float o[C];
#pragma unroll
  for (int c = 0; c < C; c += 8) {
    float co[8], sp[8];
    unpack8(*reinterpret_cast<const uint4 *>(cs + c0 + c), co);
    unpack8(*reinterpret_cast<const uint4 *>(sn + pc + c), sp);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float partner = __shfl_xor_sync(0xffffffffu, d[c + e], S / 2);
      o[c + e] = fmaf(d[c + e], co[e], sign * round_bf16(partner * sp[e]));
    }
  }
  if (dst)
#pragma unroll
    for (int c = 0; c < C; c += 8) *reinterpret_cast<uint4 *>(dst + c0 + c) = pack8(o + c);
}

struct Args {
  const bf16 *qkv, *dattn;
  const int *pad;
  const bf16 *cos, *sin;
  bf16 *dqkv;
  float4 *stats;  // (B, H, L): (m, 1/l, D, 0) per query row
  int L, E;
  float scale;
};

// Pass 1 (query-owned): rows [q0, q0 + TR) of head h, batch row b.
template <int DH>
__global__ void __launch_bounds__(TR * S) esm2_bwd_dq_kernel(Args a) {
  constexpr int C = DH / S;
  __shared__ __align__(16) bf16 Ks[TT][DH + 8];
  __shared__ __align__(16) bf16 Vs[TT][DH + 8];
  __shared__ unsigned char Kp[TT];
  const int b = blockIdx.z, h = blockIdx.y, L = a.L, E = a.E;
  const int t = threadIdx.x, c0 = (t % S) * C, qi = blockIdx.x * TR + t / S;
  const bool active = qi < L;
  const int qr = active ? qi : L - 1;  // idle threads shadow the last row
  const int *key_pad = a.pad + (size_t)b * L;
  const int live = b3::live_keys(key_pad, L);
  const size_t rs = 3 * (size_t)E;
  const bf16 *head = a.qkv + (size_t)b * L * rs + h * DH;  // q; k at +E, v at +2E

  float q[C], da[C];
#pragma unroll
  for (int c = 0; c < C; c += 8)
    rope_chunk<DH>(head + qr * rs, a.cos + (size_t)qr * DH, a.sin + (size_t)qr * DH, c0 + c,
                   q + c);
  load_slice<C>(a.dattn + ((size_t)b * L + qr) * E + h * DH + c0, da);

  auto stage = [&](int k0, int n) {
    __syncthreads();  // previous tile consumed
    stage_rotated<DH>(Ks, head + E, rs, a.cos, a.sin, k0, n);
    stage_plain<DH>(Vs, head + 2 * E, rs, k0, n);
    for (int r = t; r < n; r += blockDim.x) Kp[r] = key_pad[k0 + r] != 0;
    __syncthreads();
  };
  auto score = [&](int j) {
    float s = row_sum(dot_slice<C>(q, &Ks[j][c0])) * a.scale;
    return Kp[j] ? s + b3::MASKED : s;
  };

  // sweep 1: online max m, sum l and dn = Σ_j exp(s_j − m)·dP_j
  float m = -INFINITY, l = 0.f, dn = 0.f;
  for (int k0 = 0; k0 < live; k0 += TT) {
    const int n = min(TT, live - k0);
    stage(k0, n);
    for (int j = 0; j < n; ++j) {
      const float s = score(j);
      const float dp = row_sum(dot_slice<C>(da, &Vs[j][c0]));
      if (s > m) {
        const float corr = __expf(m - s);  // 0 on the first key
        l *= corr;
        dn *= corr;
        m = s;
      }
      const float p = __expf(s - m);
      l += p;
      dn = fmaf(p, dp, dn);
    }
  }
  const float inv_l = 1.f / l, D = dn * inv_l;

  // sweep 2: dQ (rotated coordinates) = Σ_j dS_j·k_j
  float dq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dq[c] = 0.f;
  for (int k0 = 0; k0 < live; k0 += TT) {
    const int n = min(TT, live - k0);
    stage(k0, n);
    for (int j = 0; j < n; ++j) {
      const float p = __expf(score(j) - m) * inv_l;
      const float dp = row_sum(dot_slice<C>(da, &Vs[j][c0]));
      axpy_slice<C>(round_bf16(p * (dp - D) * a.scale), &Ks[j][c0], dq);
    }
  }
  bf16 *out = a.dqkv + ((size_t)b * L + qi) * rs + h * DH;
  unrotate_store<DH>(dq, a.cos + (size_t)qr * DH, a.sin + (size_t)qr * DH, c0,
                     active ? out : nullptr);
  if (active && t % S == 0)
    a.stats[((size_t)b * gridDim.y + h) * L + qi] = make_float4(m, inv_l, D, 0.f);
}

// Pass 2 (key-owned): key rows [k0, k0 + TR) of head h, batch row b, over
// every query row.
template <int DH>
__global__ void __launch_bounds__(TR * S) esm2_bwd_dkv_kernel(Args a) {
  constexpr int C = DH / S;
  __shared__ __align__(16) bf16 Qs[TT][DH + 8];
  __shared__ __align__(16) bf16 As[TT][DH + 8];
  __shared__ float4 St[TT];
  const int b = blockIdx.z, h = blockIdx.y, L = a.L, E = a.E;
  const int t = threadIdx.x, c0 = (t % S) * C, k0 = blockIdx.x * TR, kj = k0 + t / S;
  const bool active = kj < L;
  const int kr = active ? kj : L - 1;
  const int *key_pad = a.pad + (size_t)b * L;
  const int live = b3::live_keys(key_pad, L);
  const size_t rs = 3 * (size_t)E;
  const bf16 *head = a.qkv + (size_t)b * L * rs + h * DH;
  bf16 *out = a.dqkv + ((size_t)b * L + kj) * rs + h * DH;

  float dk[C], dv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dk[c] = dv[c] = 0.f;
  if (k0 >= live) {  // every key of the block is past the last live key: p = 0
    if (active)
#pragma unroll
      for (int c = 0; c < C; c += 8) {
        *reinterpret_cast<uint4 *>(out + E + c0 + c) = pack8(dk + c);
        *reinterpret_cast<uint4 *>(out + 2 * E + c0 + c) = pack8(dv + c);
      }
    return;
  }
  float k[C], v[C];
#pragma unroll
  for (int c = 0; c < C; c += 8)
    rope_chunk<DH>(head + E + kr * rs, a.cos + (size_t)kr * DH, a.sin + (size_t)kr * DH, c0 + c,
                   k + c);
  load_slice<C>(head + 2 * E + kr * rs + c0, v);
  const bool kpad = key_pad[kr] != 0;
  const float4 *sb = a.stats + ((size_t)b * gridDim.y + h) * L;

  for (int i0 = 0; i0 < L; i0 += TT) {
    const int n = min(TT, L - i0);
    __syncthreads();
    stage_rotated<DH>(Qs, head, rs, a.cos, a.sin, i0, n);
    stage_plain<DH>(As, a.dattn + (size_t)b * L * E + h * DH, E, i0, n);
    for (int r = t; r < n; r += blockDim.x) St[r] = sb[i0 + r];
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      float s = row_sum(dot_slice<C>(k, &Qs[i][c0])) * a.scale;
      if (kpad) s += b3::MASKED;
      const float4 st = St[i];
      const float dp = row_sum(dot_slice<C>(v, &As[i][c0]));
      const float p = __expf(s - st.x) * st.y;
      axpy_slice<C>(round_bf16(p * (dp - st.z) * a.scale), &Qs[i][c0], dk);
      axpy_slice<C>(round_bf16(p), &As[i][c0], dv);
    }
  }
  unrotate_store<DH>(dk, a.cos + (size_t)kr * DH, a.sin + (size_t)kr * DH, c0,
                     active ? out + E : nullptr);
  if (active)
#pragma unroll
    for (int c = 0; c < C; c += 8)
      *reinterpret_cast<uint4 *>(out + 2 * E + c0 + c) = pack8(dv + c);
}

template <int DH>
int launch(Args a, int B, int heads, cudaStream_t stream) {
  a.scale = 1.f / sqrtf((float)DH);
  dim3 grid((a.L + TR - 1) / TR, heads, B);
  esm2_bwd_dq_kernel<DH><<<grid, TR * S, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  esm2_bwd_dkv_kernel<DH><<<grid, TR * S, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B, L, 3E) bf16 [q | k | v]; dattn (B, L, E) bf16; pad (B, L) int32,
// nonzero = PAD; cos, sin (L, E / heads) bf16 → dqkv (B, L, 3E) bf16;
// stats (B, heads, L, 4) f32 scratch; E / heads in {32, 64}.
B3_EXPORT int b3_esm2_attention_bwd(const void *qkv, const void *dattn, const void *pad,
                                    const void *cos, const void *sin, void *dqkv, void *stats,
                                    int B, int L, int E, int heads, void *stream) {
  const Args a{static_cast<const bf16 *>(qkv), static_cast<const bf16 *>(dattn),
               static_cast<const int *>(pad), static_cast<const bf16 *>(cos),
               static_cast<const bf16 *>(sin), static_cast<bf16 *>(dqkv),
               static_cast<float4 *>(stats), L, E, 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E / heads) {
    case 32: return launch<32>(a, B, heads, st);
    case 64: return launch<64>(a, B, heads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
