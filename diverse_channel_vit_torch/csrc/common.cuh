// Shared device helpers for the hand-written Hopper kernels of this package.
//
// Every package kernel runs its products on `wgmma` (wgmma_core.cuh). The
// benchmark script's S3 (int8_ln_mlp.cu) keeps the warp-level tensor-core
// path that every sm_80+ card has: operands staged in shared memory by
// `cp.async` and read into fragments by `ldmatrix` (both here), then
// `mma.sync` (int8.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DEV __device__ __forceinline__

namespace dcvit {

DEV uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1 (weights and activations
// are each read once per block).
DEV void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
DEV void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
DEV void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
DEV void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

DEV uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

DEV float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

DEV float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }

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
