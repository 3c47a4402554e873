// Shared device helpers for the hand-written Hopper kernels of this package.
//
// The kernels use the warp-level tensor-core path that every sm_80+ card
// has: bf16 `mma.sync.m16n8k16` with f32 accumulators, operands staged in
// shared memory by `cp.async` and read into fragments by `ldmatrix`.
// Shared-memory tiles keep a row stride of (width + 8) bf16 values, so the
// eight row addresses of one `ldmatrix` 8x8 matrix fall in eight different
// 16-byte bank groups (no bank conflicts) while every row stays 16-byte
// aligned for `cp.async`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DEV __device__ __forceinline__

namespace dcvit {

// Row stride in bf16 elements of a shared-memory tile `width` values wide.
__host__ __device__ constexpr int padded(int width) { return width + 8; }

DEV uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1 (weights and activations
// are each read once per block).
DEV void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
// The same copy, or 16 zero bytes when `valid` is false (rows past the end
// of a ragged tile); `gmem` must still be a mapped address.
DEV void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
DEV void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
DEV void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a rows x cols bf16 tile (cols % 8 == 0) from global memory with row
// stride `gstride` into shared memory with row stride padded(cols), spread
// over `nthreads` threads in 16-byte pieces.
DEV void load_tile_async(__nv_bfloat16* smem, const __nv_bfloat16* gmem, int rows, int cols,
                         long long gstride, int tid, int nthreads) {
  const int chunks_per_row = cols / 8;
  const int total = rows * chunks_per_row;
  const int sstride = padded(cols);
  for (int i = tid; i < total; i += nthreads) {
    const int r = i / chunks_per_row;
    const int c = (i - r * chunks_per_row) * 8;
    cp_async16(smem + r * sstride + c, gmem + r * gstride + c);
  }
}

// load_tile_async for a 64-row tile whose rows at or past `rows_valid` are
// zero-filled instead of read.
DEV void load_rows_zfill(__nv_bfloat16* smem, const __nv_bfloat16* gmem, int cols,
                         long long gstride, long long rows_valid, int tid, int nthreads) {
  const int chunks_per_row = cols / 8;
  const int total = 64 * chunks_per_row;
  const int sstride = padded(cols);
  for (int i = tid; i < total; i += nthreads) {
    const int r = i / chunks_per_row;
    const int c = (i - r * chunks_per_row) * 8;
    const bool valid = r < rows_valid;
    cp_async16_zfill(smem + r * sstride + c, valid ? gmem + r * gstride + c : gmem, valid);
  }
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
DEV void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
DEV void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a(16x16, row) * b(16x8, col), bf16 in, f32 accumulate.
DEV void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows x 16 k) of a row-major shared tile at (row0, k0).
DEV void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride, int row0, int k0,
                     int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
}

// The same A fragment from a shared tile stored [k][m] (m contiguous): the
// transposed operand of a weight gradient A^T B.
DEV void load_a_frag_km(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride, int m0, int k0,
                        int lane) {
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * stride + m0 +
                           ((lane >> 3) & 1) * 8);
}

// B fragments of two adjacent n-tiles (16 n x 16 k) from a shared tile
// stored [n][k] (k contiguous): b[0], b[1] feed n-tile n0, b[2], b[3] n0 + 8.
DEV void load_b_frag_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int stride, int n0, int k0,
                        int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The same fragments from a shared tile stored [k][n] (n contiguous).
DEV void load_b_frag_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int stride, int n0, int k0,
                        int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * stride + n0 +
                           (lane >> 4) * 8);
}

DEV uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

DEV float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

DEV float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }

// A fragments of a 16-row x 64-column f32 accumulator (as mma leaves it) for
// the next product, where those 64 columns are the reduction axis: four
// k-steps of 16, rounded to bf16.
DEV void acc_to_a_frags(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j >> 1][(j & 1) * 2] = pack_bf16(c[j][0], c[j][1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

// Sum over all 32 lanes of a warp.
DEV float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the eight row groups g = lane / 4 of a warp (lanes that share
// lane % 4 hold the same accumulator columns).
DEV float sum_over_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Sum over the four lanes of a quad (one accumulator row).
DEV float sum_over_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace dcvit
