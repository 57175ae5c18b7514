// The rotary staging launch of the ESM2 attention kernels (esm2_attn.cu,
// esm2_attn_bwd.cu): GPT-NeoX rotary of q and k with rope8's rounding (bf16
// products and sum, as the TPU kernel rotates in bf16:
// biom3_tpu/ops/pallas/esm2_stack_tpu.py:164-176), written with the other
// operands a kernel streams into a bf16 scratch (nops, B, H, L, Dh), one
// head's rows contiguous, so that every operand is a plain TMA tile of a
// 3-D map (attn_hopper.cuh's encode_heads): the TMA cannot rotate.
//
// Operands, in the scratch's order: rotated q, rotated k, then (the
// backward only) v and dA.  The forward stages two and reads v in place.
// One thread per 8-column chunk of a row; bound by bytes (read and write
// once).  Each file wraps the body in a kernel of its own name, so a
// profile tells the forward's staging from the backward's.
#pragma once

#include "attn_common.cuh"
#include "hopper_gemm.cuh"

namespace {

enum { OP_Q = 0, OP_K = 1, OP_V = 2, OP_DA = 3 };   // the scratch's operands

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

// qkv (B, L, 3E) and, with nops = 4, dattn (B, L, E) → ops (nops, B, H, L,
// DH): rotated q, rotated k[, v, dA].  The body of each file's staging
// kernel (esm2_attn_stage_kernel, esm2_bwd_stage_kernel), launched on
// stage_grid blocks of 256 threads.
template <int DH>
__device__ __forceinline__ void stage_operands(const bf16 *__restrict__ qkv,
                                               const bf16 *__restrict__ dattn,
                                               const bf16 *__restrict__ cos,
                                               const bf16 *__restrict__ sin,
                                               bf16 *__restrict__ ops, int nops, int B, int L,
                                               int E, int H) {
  const int chunks = E / 8;
  const size_t total = (size_t)B * L * nops * chunks;
  for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(u % chunks) * 8, op = (int)(u / chunks % nops);
    const size_t row = u / chunks / nops;  // b·L + position
    const int b = (int)(row / L), pos = (int)(row % L), head = col / DH, c = col % DH;
    uint4 val;
    if (op == OP_DA) {
      val = *reinterpret_cast<const uint4 *>(dattn + row * E + col);
    } else if (op == OP_V) {
      val = *reinterpret_cast<const uint4 *>(qkv + row * 3 * E + 2 * E + col);
    } else {
      float o[8];
      rope_chunk<DH>(qkv + row * 3 * E + (size_t)op * E + head * DH, cos + (size_t)pos * DH,
                     sin + (size_t)pos * DH, c, o);
      val = pack8(o);  // exact: o holds bf16 values
    }
    *reinterpret_cast<uint4 *>(ops + ((((size_t)op * B + b) * H + head) * L + pos) * DH + c) =
        val;
  }
}

// Blocks of the staging grid-stride loop: one 8-column chunk a thread, at
// most eight blocks an SM.
inline int stage_grid(int B, int L, int E, int nops) {
  const size_t chunks = (size_t)B * L * nops * (E / 8), blocks = (chunks + 255) / 256;
  const size_t cap = (size_t)hopper::sm_count() * 8;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace
