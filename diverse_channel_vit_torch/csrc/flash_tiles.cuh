// The `mma.sync` attention tile loop of the benchmark scripts' kernels only:
// S2's forward (qkv_flash.cu) runs `flash_fwd_tile`, and S1 (bench_attn_bwd.cu)
// takes this file's tile constants for loops of its own. Every kernel of the
// package runs on flash_wgmma.cuh: B1 and B2 (attend_project*.cu), B5 and B6
// (flash_packed*.cu).
//
// The loop runs in one block of four warps; each warp owns 16 rows of a
// 64-row tile (rows warp * 16 + g and warp * 16 + g + 8, g = lane / 4), so a
// row's softmax statistics and accumulators stay in the registers of one
// quad of lanes. K and V stream through a double-buffered cp.async ring in
// tiles of 64 rows. Every product is bf16 `mma.sync.m16n8k16` with f32
// accumulation; P is rounded to bf16 before its product, as the TPU kernels
// round it.
//
// Operands are head slices of (B, N, *) tensors: a pointer to the slice's
// first row and a row stride in elements.
#pragma once

#include "common.cuh"

namespace dcvit {

constexpr int kFRows = 64;      // rows (queries or keys) per tile
constexpr int kFThreads = 128;  // four warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of flash_fwd_tile: Q (64 rows) and two stages of K and V.
template <int DH>
__host__ __device__ constexpr int flash_fwd_smem_elems() {
  return 5 * kFRows * padded(DH);
}

// O = softmax(Q K^T * scale, keys >= n_valid masked) V for one 64-query tile
// and one head, the keys streamed in 64-key tiles with an online softmax
// (running max and sum in f32, in the log2 domain); key tiles wholly at or
// past n_valid are skipped. `q` points at the tile's first query row, `k`
// and `v` at key row 0. `smem` holds flash_fwd_smem_elems<DH>() values. On
// return `o` holds this thread's two rows already divided by their row sums
// (f32, not yet rounded) and `lse_a` / `lse_b` their natural-log log-sum-exp
// of the scaled, masked scores; every thread has passed a final
// __syncthreads, so `smem` may be refilled at once.
template <int DH>
DEV void flash_fwd_tile(const __nv_bfloat16* __restrict__ q, long long sq,
                        const __nv_bfloat16* __restrict__ k, long long sk,
                        const __nv_bfloat16* __restrict__ v, long long sv, int n_valid,
                        float scale_log2, __nv_bfloat16* smem, float (&o)[DH / 8][4],
                        float& lse_a, float& lse_b) {
  static_assert(DH % 16 == 0, "head width must be a multiple of 16");
  constexpr int SDH = padded(DH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = sQ + kFRows * SDH;
  __nv_bfloat16* sV = sK + 2 * kFRows * SDH;
  const int n_tiles = (n_valid + kFRows - 1) / kFRows;

  load_tile_async(sQ, q, kFRows, DH, sq, tid, kFThreads);
  load_tile_async(sK, k, kFRows, DH, sk, tid, kFThreads);
  load_tile_async(sV, v, kFRows, DH, sv, tid, kFThreads);
  cp_async_commit();

#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t qf[DH / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const long long r = (long long)(t + 1) * kFRows;
      load_tile_async(sK + (buf ^ 1) * kFRows * SDH, k + r * sk, kFRows, DH, sk, tid, kFThreads);
      load_tile_async(sV + (buf ^ 1) * kFRows * SDH, v + r * sv, kFRows, DH, sv, tid, kFThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) load_a_frag(qf[kk], sQ, SDH, warp * 16, kk * 16, lane);
    }
    const __nv_bfloat16* k_t = sK + buf * kFRows * SDH;
    const __nv_bfloat16* v_t = sV + buf * kFRows * SDH;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kFRows / 8][4];
#pragma unroll
    for (int j = 0; j < kFRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kFRows / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, k_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale into the log2 domain; mask keys at or past n_valid
    const int kv0 = t * kFRows;
    const bool ragged = kv0 + kFRows > n_valid;
#pragma unroll
    for (int j = 0; j < kFRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + t4 * 2 + (e & 1);
        s[j][e] = (ragged && col >= n_valid) ? -1e30f : s[j][e] * scale_log2;
      }

    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kFRows / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
    }

    // P = exp2(S - m), f32 row sums, bf16 A fragments for P V
    uint32_t pf[kFRows / 16][4];
#pragma unroll
    for (int j = 0; j < kFRows / 8; ++j) {
      const float p0 = exp2f(s[j][0] - mx_a), p1 = exp2f(s[j][1] - mx_a);
      const float p2 = exp2f(s[j][2] - mx_b), p3 = exp2f(s[j][3] - mx_b);
      l_a += p0 + p1;
      l_b += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < kFRows / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_kn(bfr, v_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(o[2 * np], pf[kk], bfr[0], bfr[1]);
        mma_bf16(o[2 * np + 1], pf[kk], bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    o[j][0] *= inv_a;
    o[j][1] *= inv_a;
    o[j][2] *= inv_b;
    o[j][3] *= inv_b;
  }
  // m is in the log2 domain
  lse_a = (m_a + log2f(l_a)) * 0.6931471805599453f;
  lse_b = (m_b + log2f(l_b)) * 0.6931471805599453f;
}

}  // namespace dcvit
