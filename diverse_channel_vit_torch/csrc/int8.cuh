// Shared device helpers of the int8 ln_mlp kernels: B7 (ln_mlp_q.cu), B8
// (ln_mlp_q_bwd.cu) and the benchmark script's S3 (int8_ln_mlp.cu).
//
// The exact-rounding arithmetic all three share, so that they write the same
// int8 codes as each other and as the plain versions: quantisation and
// dequantisation follow ops/fused_block.py operation by operation, with the
// round-to-nearest intrinsics, which the compiler never contracts into fused
// multiply-adds: the scale of a row is max(max|v| / 127, 1e-8) by IEEE
// division, a code is round-half-even(v / s), and a dequantised product is
// (float(acc) * row_scale) * col_scale (+ bias); tanh-GELU and its
// derivative use tanhf, never the core's faster tanh (wgmma_core.cuh), which
// would change codes; LayerNorm runs one warp a row (`ln_row`).
//
// The warp-level int8 tensor-core path below (`mma.sync.m16n8k32`, operands
// staged by `cp.async` and read by `ldmatrix`) serves S3 only: B7 and B8 run
// their int8 products as `wgmma` (wgmma_core.cuh). Its fragments, counted in
// bytes, are laid out as the bf16 m16n8k16 fragments of common.cuh are: A is
// 16 rows x 32 bytes in four 32-bit registers (rows g / g + 8, bytes 4 t ..
// 4 t + 3 and 16 + 4 t ..), B is 8 columns x 32 bytes of k in two registers,
// C is the same 16 x 8 layout as the f32 accumulator. So `ldmatrix` (which
// moves 8 x 8 tiles of 16-bit values, i.e. 8 rows x 16 bytes) loads both
// operands from int8 tiles whose k axis is contiguous in shared memory.
// There is no transposing ldmatrix for 8-bit values: every int8 operand is
// stored k-major (the weight copies come from `quantize_mlp_weights` in the
// layout their product reads). Int8 shared tiles keep a row stride of
// (width + 16) bytes: row addresses of one 8 x 8 ldmatrix tile fall in eight
// different 16-byte bank groups for the widths used here (64 and 384),
// and every row stays 16-byte aligned.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace dcvit {

// Row stride in bytes of an int8 shared tile `width` bytes wide.
__host__ __device__ constexpr int padded_s8(int width) { return width + 16; }

// Copy a rows x cols int8 tile (cols % 16 == 0) from global memory with row
// stride `gstride` into shared memory with row stride `sstride`.
DEV void load_s8_async(int8_t* smem, const int8_t* gmem, int rows, int cols, long long gstride,
                       int sstride, int tid, int nthreads) {
  const int per_row = cols / 16;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 16;
    cp_async16(smem + r * sstride + c, gmem + r * gstride + c);
  }
}

// A fragment (16 rows x 32 k) of a row-major int8 shared tile at (row0, k0).
DEV void load_a_frag_s8(uint32_t (&a)[4], const int8_t* tile, int stride, int row0, int k0,
                        int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * stride + k0 + (lane >> 4) * 16);
}

// B fragments of two adjacent n-tiles (16 n x 32 k) of an int8 shared tile
// stored [n][k]: b[0], b[1] feed n-tile n0, b[2], b[3] n-tile n0 + 8.
DEV void load_b_frag_s8(uint32_t (&b)[4], const int8_t* tile, int stride, int n0, int k0,
                        int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
                     ((lane >> 3) & 1) * 16);
}

// d += a(16x32, row) * b(32x8, col), int8 in, exact int32 accumulate.
DEV void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[2 * NP] (16 rows from row0 x 16 NP columns from n0) += A B^T over
// K = 32 KSTEPS, A [rows][K] and B [n][K] int8 shared tiles.
template <int KSTEPS, int NP>
DEV void mma_s8_rows(int (&acc)[2 * NP][4], const int8_t* a, int sa, int row0, const int8_t* b,
                     int sb, int n0, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t af[4];
    load_a_frag_s8(af, a, sa, row0, kk * 32, lane);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bfr[4];
      load_b_frag_s8(bfr, b, sb, n0 + np * 16, kk * 32, lane);
      mma_s8(acc[2 * np], af, bfr[0], bfr[1]);
      mma_s8(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

template <int N>
DEV void zero_acc(int (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
}

// Max over all 32 lanes of a warp.
DEV float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Max over the four lanes of a quad (one accumulator row).
DEV float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The per-row scale of a row whose max|v| is amax: max(amax / 127, 1e-8).
DEV float row_scale(float amax) { return fmaxf(__fdiv_rn(amax, 127.f), 1e-8f); }

// round-half-even(v / s) as an int8 code (|v / s| <= 127 by construction).
DEV int8_t quant_s8(float v, float s) { return (int8_t)__float2int_rn(__fdiv_rn(v, s)); }

// (float(acc) * rs) * cs, rounded after each product.
DEV float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

// tanh-GELU in f32, in the plain versions' order of operations
// (ops/fused_block.py `_gelu_tanh_f32`), each step rounded.
DEV float gelu_tanh_rn(float x) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

// Where |gelu_tanh_rn| over the negative numbers (at most 0.1700408, near
// x = -0.7524) is below its value: gelu_tanh_rn(0.3f) = 0.1854. With
// gelu_tanh_rn non-decreasing on [0, inf), a row whose largest input reaches
// this has its max |GELU| at that input. (Both facts hold for every float;
// a gpu test checks them with `dcvit_gelu_tanh_rn_table` of ln_mlp_q.cu.)
constexpr float kGeluPosDominates = 0.3f;

// gelu_tanh_rn(x) (bit for bit the one above) and its derivative, in the
// plain version's order of operations (`_dgelu_tanh_f32`), from one tanhf.
DEV void gelu_dgelu_tanh_rn(float x, float& g, float& dg) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(x, cube)));
  g = __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, t));
  const float dinner =
      __fmul_rn(0.7978845608028654f, __fadd_rn(1.f, __fmul_rn(__fmul_rn(0.134145f, x), x)));
  const float left = __fmul_rn(0.5f, __fadd_rn(1.f, t));
  const float right =
      __fmul_rn(__fmul_rn(__fmul_rn(0.5f, x), __fsub_rn(1.f, __fmul_rn(t, t))), dinner);
  dg = __fadd_rn(left, right);
}

// LayerNorm of one bf16 row by one warp, f32, two-pass mean and variance,
// eps 1e-6: y = ((x - mean) * rstd) * scale + bias for the lane's columns
// 2 (lane + 32 i) and 2 (lane + 32 i) + 1.
template <int D>
DEV void ln_row(const __nv_bfloat16* xrow, const float* scale, const float* bias, int lane,
                float2 (&y)[D / 64], float& mean, float& rstd) {
  const uint32_t* xr = reinterpret_cast<const uint32_t*>(xrow);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    y[i] = unpack_bf16(xr[lane + 32 * i]);
    sum += y[i].x + y[i].y;
  }
  mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    y[i].x = __fsub_rn(y[i].x, mean);
    y[i].y = __fsub_rn(y[i].y, mean);
    sq += y[i].x * y[i].x + y[i].y * y[i].y;
  }
  rstd = rsqrtf(warp_sum(sq) / D + 1e-6f);
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const int col = 2 * (lane + 32 * i);
    y[i].x = __fadd_rn(__fmul_rn(__fmul_rn(y[i].x, rstd), scale[col]), bias[col]);
    y[i].y = __fadd_rn(__fmul_rn(__fmul_rn(y[i].y, rstd), scale[col + 1]), bias[col + 1]);
  }
}

// Quantise a warp's row held as D / 64 pairs per lane (ln_row's layout) into
// the lane's int8 code pairs; returns the row's scale.
template <int NP>
DEV float quant_pairs(const float2 (&v)[NP], char2 (&q)[NP]) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) amax = fmaxf(amax, fmaxf(fabsf(v[i].x), fabsf(v[i].y)));
  const float s = row_scale(warp_max(amax));
#pragma unroll
  for (int i = 0; i < NP; ++i) q[i] = make_char2(quant_s8(v[i].x, s), quant_s8(v[i].y, s));
  return s;
}

// The same, the codes stored at `dst` (lane's pairs at byte offsets
// 2 (lane + 32 i)).
template <int NP>
DEV float quant_row(const float2 (&v)[NP], int8_t* dst, int lane) {
  char2 q[NP];
  const float s = quant_pairs(v, q);
#pragma unroll
  for (int i = 0; i < NP; ++i) *reinterpret_cast<char2*>(dst + 2 * (lane + 32 * i)) = q[i];
  return s;
}

}  // namespace dcvit
