// stage3_attention_core_i8: the band-local heads of one ProteoScribe layer's
// attention with their two products in int8, from the fused q/k/v
// projection (B, L, 3d) to the head outputs (B, L, d) (the linear heads are
// stage3_attn.cu's, in bf16, through b3_stage3_attention_linear).
//
// Replaces the attn_quant="int8" branch of _attn_core_t inside the TPU
// kernel biom3_tpu/ops/pallas/stack_kernel_tpu.py:112-180 (fused_stack_logits):
// * q and k are quantized per (head, token) over Dh, v per (head, channel)
//   over the whole sequence: amax = max(max|x|, 1e-6), code = rint(x ·
//   (127 / amax)) clipped to ±127 (round half to even, as jnp.round), scale
//   amax · (1/127);
// * scores (int32 q8·k8) · s_q · s_k · Dh^-0.5 in f32, the f32 softmax over
//   the row's band (windows w-1..w+1 that exist: edge windows see 2W keys);
// * p is quantized per (head, query): pamax = max(max_j p, 1e-6), pq =
//   rint(p · (127 / pamax)); out = int32(Σ_j pq · v8) · s_v[channel] ·
//   (pamax · (1/127)), rounded to bf16.
// max_j p is p at the row's largest score, exp(0) / l = 1 / l, so pq needs
// the row's final max and sum before any p is quantized: the band kernel
// walks the band twice, first for (max, Σexp) online, then for p.
//
// Two launches:
// 1. stage3_i8_quant_kernel, grid (local heads, B): a block takes one
//    (batch row, head) over all L rows; q and k codes a row a thread (Dh
//    codes and their scale), then v's column amax over L and v's codes
//    channel-major (Dh, L), 4 rows a word — the layout the PV product reads;
// 2. stage3_i8_band_kernel, grid (ceil(L / 128), local heads, B): one query
//    a thread; the block stages the k codes, k scales and v codes of the
//    union of its rows' bands in shared memory; scores by __dp4a over Dh
//    (8 a key at Dh 32), then PV by __dp4a over 4 keys' pq at a time, Dh
//    int32 sums in registers.
//
// What bounds it on an H100: the bytes, 12 B·L·d of bf16 qkv in and 2 B·L·d
// out (0.040 ms at Stage-3 B=32); the pre-pass reads q, k and v of the
// band heads and writes ~2 bytes a value of codes, which the band kernel
// reads again (mostly from L2).  This first version computes on CUDA cores
// (dp4a: 4 int8 products an instruction) with an IEEE division and an expf
// per (query, key); IGMMA tiles and a fused pre-pass are later work.
#include "common.cuh"

namespace {

constexpr int QT = 128;              // queries (threads) a band block
constexpr int QUANT_THREADS = 256;
constexpr float INV127 = (float)(1.0 / 127.0);

__device__ __forceinline__ uint32_t code_of(float x, float mul, int e) {
  const int c = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(x, mul)), -127.f), 127.f));
  return (static_cast<uint32_t>(c) & 0xffu) << (8 * e);
}

template <int DH>
__global__ void __launch_bounds__(QUANT_THREADS)
stage3_i8_quant_kernel(const bf16 *__restrict__ qkv, int8_t *__restrict__ q8,
                       float *__restrict__ sq, int8_t *__restrict__ k8, float *__restrict__ sk,
                       int8_t *__restrict__ v8, float *__restrict__ sv, int L, int d, int nl) {
  constexpr int G = QUANT_THREADS / DH;   // row groups of the v pass
  __shared__ float red[G][DH];
  __shared__ float mul_v[DH];
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const size_t rs = 3 * (size_t)d, hb = (size_t)b * nl + h;
  const bf16 *base = qkv + (size_t)b * L * rs + h * DH;

  // q and k: rows 0..L-1 of q, then of k, one a thread
  for (int task = t; task < 2 * L; task += QUANT_THREADS) {
    const int which = task >= L, r = task - which * L;
    const bf16 *src = base + (size_t)r * rs + which * d;
    float x[DH];
#pragma unroll
    for (int c = 0; c < DH; c += 8) unpack8(*reinterpret_cast<const uint4 *>(src + c), x + c);
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) amax = fmaxf(amax, fabsf(x[c]));
    amax = fmaxf(amax, 1e-6f);
    const float mul = __fdiv_rn(127.f, amax);
    uint32_t w[DH / 4];
#pragma unroll
    for (int i = 0; i < DH / 4; ++i)
      w[i] = code_of(x[4 * i], mul, 0) | code_of(x[4 * i + 1], mul, 1) |
             code_of(x[4 * i + 2], mul, 2) | code_of(x[4 * i + 3], mul, 3);
    uint4 *dst = reinterpret_cast<uint4 *>((which ? k8 : q8) + (hb * L + r) * DH);
#pragma unroll
    for (int i = 0; i < DH / 16; ++i)
      dst[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    (which ? sk : sq)[hb * L + r] = __fmul_rn(amax, INV127);
  }

  // v: each channel's amax over the sequence, then its codes 4 rows a word
  const int c = t % DH, g = t / DH;
  const bf16 *vc = base + 2 * d + c;
  float amax = 0.f;
  for (int r = g; r < L; r += G) amax = fmaxf(amax, fabsf(__bfloat162float(vc[(size_t)r * rs])));
  red[g][c] = amax;
  __syncthreads();
  if (t < DH) {
    float m = red[0][t];
#pragma unroll
    for (int i = 1; i < G; ++i) m = fmaxf(m, red[i][t]);
    m = fmaxf(m, 1e-6f);
    mul_v[t] = __fdiv_rn(127.f, m);
    sv[hb * DH + t] = __fmul_rn(m, INV127);
  }
  __syncthreads();
  const float mul = mul_v[c];
  uint32_t *vdst = reinterpret_cast<uint32_t *>(v8 + (hb * DH + c) * L);
  for (int r0 = 4 * g; r0 < L; r0 += 4 * G) {
    uint32_t w = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w |= code_of(__bfloat162float(vc[(size_t)(r0 + e) * rs]), mul, e);
    vdst[r0 / 4] = w;
  }
}

// The union of the bands of rows [q0, min(q0 + QT, L)): keys [lo, hi).
__host__ __device__ __forceinline__ void block_band(int q0, int L, int window, int &lo, int &hi) {
  const int last = (q0 + QT < L ? q0 + QT : L) - 1;
  lo = q0 / window > 0 ? (q0 / window - 1) * window : 0;
  hi = (last / window + 2) * window;
  if (hi > L) hi = L;
}

template <int DH>
__global__ void __launch_bounds__(QT)
stage3_i8_band_kernel(const int8_t *__restrict__ q8, const float *__restrict__ sq,
                      const int8_t *__restrict__ k8, const float *__restrict__ sk,
                      const int8_t *__restrict__ v8, const float *__restrict__ sv,
                      bf16 *__restrict__ out, int L, int d, int nl, int window, int span,
                      float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const size_t hb = (size_t)b * nl + h;
  int k_lo, k_hi;
  block_band(q0, L, window, k_lo, k_hi);
  const int n = k_hi - k_lo;                     // a multiple of 4, at most span
  int8_t *K = reinterpret_cast<int8_t *>(smem);  // [span][DH] k codes
  int8_t *V = K + (size_t)span * DH;             // [DH][span] v codes, channel-major
  float *SK = reinterpret_cast<float *>(V + (size_t)DH * span);   // [span]
  float *SV = SK + span;                         // [DH]

  const uint4 *ksrc = reinterpret_cast<const uint4 *>(k8 + (hb * L + k_lo) * DH);
  for (int i = t; i < n * DH / 16; i += QT) reinterpret_cast<uint4 *>(K)[i] = ksrc[i];
  const int nw = n / 4, sw = span / 4;
  for (int i = t; i < DH * nw; i += QT) {
    const int ch = i / nw, w = i % nw;
    reinterpret_cast<uint32_t *>(V)[ch * sw + w] =
        reinterpret_cast<const uint32_t *>(v8 + (hb * DH + ch) * L + k_lo)[w];
  }
  for (int i = t; i < n; i += QT) SK[i] = sk[hb * L + k_lo + i];
  if (t < DH) SV[t] = sv[hb * DH + t];
  __syncthreads();

  const int row = q0 + t;
  if (row >= L) return;
  int qw[DH / 4];
  const uint4 *qsrc = reinterpret_cast<const uint4 *>(q8 + (hb * L + row) * DH);
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
    const uint4 u = qsrc[i];
    qw[4 * i] = (int)u.x;
    qw[4 * i + 1] = (int)u.y;
    qw[4 * i + 2] = (int)u.z;
    qw[4 * i + 3] = (int)u.w;
  }
  const float sqi = sq[hb * L + row];
  const int win = row / window;
  const int lo = max(0, (win - 1) * window) - k_lo, hi = min(L, (win + 2) * window) - k_lo;
  // the score of key j (shared-memory index): the same operations in both
  // passes, so the row's largest score gives exp(0) = 1 exactly in the second
  auto score = [&](int j) {
    const uint4 *kr = reinterpret_cast<const uint4 *>(K + (size_t)j * DH);
    int acc = 0;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      const uint4 u = kr[i];
      acc = __dp4a(qw[4 * i], (int)u.x, acc);
      acc = __dp4a(qw[4 * i + 1], (int)u.y, acc);
      acc = __dp4a(qw[4 * i + 2], (int)u.z, acc);
      acc = __dp4a(qw[4 * i + 3], (int)u.w, acc);
    }
    return __fmul_rn(__fmul_rn(__fmul_rn((float)acc, sqi), SK[j]), scale);
  };

  float m = -INFINITY, l = 0.f;
  for (int j = lo; j < hi; ++j) {
    const float s = score(j);
    if (s > m) {
      l = __fmaf_rn(l, expf(m - s), 1.f);   // 0 · exp(−inf) on the first key
      m = s;
    } else {
      l += expf(s - m);
    }
  }
  const float pamax = fmaxf(__fdiv_rn(1.f, l), 1e-6f);
  const float mul = __fdiv_rn(127.f, pamax);
  int acc[DH];
#pragma unroll
  for (int ch = 0; ch < DH; ++ch) acc[ch] = 0;
  for (int j0 = lo; j0 < hi; j0 += 4) {
    uint32_t pw = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __fdiv_rn(expf(score(j0 + e) - m), l);
      pw |= static_cast<uint32_t>(rintf(__fmul_rn(p, mul))) << (8 * e);   // 0..127
    }
    const int *vw = reinterpret_cast<const int *>(V) + j0 / 4;
#pragma unroll
    for (int ch = 0; ch < DH; ++ch) acc[ch] = __dp4a((int)pw, vw[ch * sw], acc[ch]);
  }
  const float f = __fmul_rn(pamax, INV127);
  bf16 *dst = out + ((size_t)b * L + row) * d + h * DH;
#pragma unroll
  for (int c0 = 0; c0 < DH; c0 += 8) {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(__fmul_rn((float)acc[c0 + e], SV[c0 + e]), f);
    *reinterpret_cast<uint4 *>(dst + c0) = pack8(o);
  }
}

template <int DH>
int launch(const bf16 *qkv, bf16 *out, int8_t *q8, float *sq, int8_t *k8, float *sk, int8_t *v8,
           float *sv, int B, int L, int d, int nl, int window, cudaStream_t stream) {
  stage3_i8_quant_kernel<DH><<<dim3(nl, B), QUANT_THREADS, 0, stream>>>(qkv, q8, sq, k8, sk, v8,
                                                                        sv, L, d, nl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int span = 0;   // the widest block band
  for (int q0 = 0; q0 < L; q0 += QT) {
    int lo, hi;
    block_band(q0, L, window, lo, hi);
    if (hi - lo > span) span = hi - lo;
  }
  const int smem = span * DH * 2 + (span + DH) * 4;
  static int sized = 48 << 10;   // the most dynamic shared memory allowed so far
  if (smem > sized) {
    err = cudaFuncSetAttribute(stage3_i8_band_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = smem;
  }
  stage3_i8_band_kernel<DH><<<dim3((L + QT - 1) / QT, nl, B), QT, smem, stream>>>(
      q8, sq, k8, sk, v8, sv, out, L, d, nl, window, span, 1.f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, L, 3d) bf16 [q | k | v], 16-byte aligned; out (B, L, d) bf16:
// this writes the first local_heads heads' columns.  Codes and scales, all
// written here: q8, k8 (B, local, L, Dh) int8, sq, sk (B, local, L) f32,
// v8 (B, local, Dh, L) int8, sv (B, local, Dh) f32.  Head dim d / heads 32
// or 64; window % 4 == 0 and L % window == 0.  Launches: 2.
B3_EXPORT int b3_stage3_attention_i8(const void *qkv, void *out, void *q8, void *sq, void *k8,
                                     void *sk, void *v8, void *sv, int B, int L, int d,
                                     int heads, int local_heads, int window, void *stream) {
  if (B < 1 || heads < 1 || local_heads < 1 || local_heads > heads || d % heads || window < 4 ||
      window % 4 || L % window)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *x = static_cast<const bf16 *>(qkv);
  bf16 *o = static_cast<bf16 *>(out);
  int8_t *q = static_cast<int8_t *>(q8), *k = static_cast<int8_t *>(k8),
         *v = static_cast<int8_t *>(v8);
  float *a = static_cast<float *>(sq), *c = static_cast<float *>(sk),
        *e = static_cast<float *>(sv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / heads) {
    case 32: return launch<32>(x, o, q, a, k, c, v, e, B, L, d, local_heads, window, s);
    case 64: return launch<64>(x, o, q, a, k, c, v, e, B, L, d, local_heads, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
