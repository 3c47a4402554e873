// Tile loops of masked multi-head attention on `mma.sync`, shared by the
// flash_packed kernels B5 and B6 (flash_packed.cu, flash_packed_bwd.cu) and
// the benchmark scripts' S1 and S2 (bench_attn_bwd.cu, qkv_flash.cu) only.
// The attend_project kernels B1 and B2 run on flash_wgmma.cuh.
//
// Each loop runs in one block of four warps; each warp owns 16 rows of a
// 64-row tile (rows warp * 16 + g and warp * 16 + g + 8, g = lane / 4), so a
// row's softmax statistics and accumulators stay in the registers of one
// quad of lanes. The operand the loop walks over streams through a
// double-buffered cp.async ring in tiles of 64 rows. Every product is bf16
// `mma.sync.m16n8k16` with f32 accumulation; P and dS are rounded to bf16
// before their products, as the TPU kernels round them.
//
// Operands are head slices of (B, N, *) tensors: a pointer to the slice's
// first row and a row stride in elements, so q, k and v may be the thirds of
// one packed qkv tensor or tensors of their own.
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

// Shared memory of flash_bwd_kv_tile, in bytes: K, V, two stages of Q and
// dO, two stages of 64 lse and 64 di values.
template <int DH>
__host__ __device__ constexpr int flash_bwd_kv_smem_bytes() {
  return 2 * 6 * kFRows * padded(DH) + 4 * 2 * 2 * kFRows;
}

// dK and dV of one 64-key tile for one head, looping over all n / 64 query
// tiles: S^T = K Q^T, P^T = exp(S^T * scale - lse[query]) (keys at or past
// n_valid exactly 0), dV += bf16(P^T) dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - di[query]) * scale, dK += bf16(dS^T) Q. `k` and `v`
// point at the tile's first key row (the tile starts below n_valid), `q` and
// `dO` at query row 0, `lrow` / `drow` at the head's lse / di row (n f32
// each). On return dk and dv hold this thread's two key rows (f32) and
// every thread has passed a final __syncthreads.
template <int DH>
DEV void flash_bwd_kv_tile(const __nv_bfloat16* __restrict__ q, long long sq,
                           const __nv_bfloat16* __restrict__ k, long long sk,
                           const __nv_bfloat16* __restrict__ v, long long sv,
                           const __nv_bfloat16* __restrict__ dO, long long sdo,
                           const float* __restrict__ lrow, const float* __restrict__ drow, int n,
                           int k0, int n_valid, float scale_log2,
                           float sm_scale, unsigned char* smem, float (&dk)[DH / 8][4],
                           float (&dv)[DH / 8][4]) {
  constexpr int SDH = padded(DH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kFRows * SDH;
  __nv_bfloat16* sQ = sV + kFRows * SDH;       // two stages
  __nv_bfloat16* sDO = sQ + 2 * kFRows * SDH;  // two stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * kFRows * SDH);  // [2][64] lse
  float* sD = sL + 2 * kFRows;                                   // [2][64] di

  auto load_q_tile = [&](int qt, int buf) {
    const long long q0 = (long long)qt * kFRows;
    load_tile_async(sQ + buf * kFRows * SDH, q + q0 * sq, kFRows, DH, sq, tid, kFThreads);
    load_tile_async(sDO + buf * kFRows * SDH, dO + q0 * sdo, kFRows, DH, sdo, tid, kFThreads);
    if (tid < 16) cp_async16(sL + buf * kFRows + tid * 4, lrow + q0 + tid * 4);
    else if (tid < 32) cp_async16(sD + buf * kFRows + (tid - 16) * 4, drow + q0 + (tid - 16) * 4);
    cp_async_commit();
  };

  load_tile_async(sK, k, kFRows, DH, sk, tid, kFThreads);
  load_tile_async(sV, v, kFRows, DH, sv, tid, kFThreads);
  load_q_tile(0, 0);

#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const bool valid_a = key_a < n_valid, valid_b = key_b < n_valid;

  const int nq = n / kFRows;
  for (int qt = 0; qt < nq; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < nq) {
      load_q_tile(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* q_t = sQ + buf * kFRows * SDH;
    const __nv_bfloat16* do_t = sDO + buf * kFRows * SDH;
    const float* l_t = sL + buf * kFRows;
    const float* d_t = sD + buf * kFRows;

    // S^T = K Q^T: this warp's 16 keys x 64 queries
    float st[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sK, SDH, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, q_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(st[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(st[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    // P^T = exp(S^T * scale - lse[query]); padded keys exactly 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        const bool valid = e < 2 ? valid_a : valid_b;
        st[j][e] = valid ? exp2f(st[j][e] * scale_log2 - l_t[qc] * kLog2e) : 0.f;
      }
    // dV += P^T dO (P rounded to bf16)
    {
      uint32_t pf[4][4];
      acc_to_a_frags(pf, st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bfr[4];
          load_b_frag_kn(bfr, do_t, SDH, np * 16, kk * 16, lane);
          mma_bf16(dv[2 * np], pf[kk], bfr[0], bfr[1]);
          mma_bf16(dv[2 * np + 1], pf[kk], bfr[2], bfr[3]);
        }
    }
    // dP^T = V dO^T
    float dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sV, SDH, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, do_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(dpt[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(dpt[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    // dS^T = P^T (dP^T - di[query]) * scale; dK += dS^T Q (dS rounded to bf16)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        st[j][e] = st[j][e] * (dpt[j][e] - d_t[qc]) * sm_scale;
      }
    {
      uint32_t dsf[4][4];
      acc_to_a_frags(dsf, st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bfr[4];
          load_b_frag_kn(bfr, q_t, SDH, np * 16, kk * 16, lane);
          mma_bf16(dk[2 * np], dsf[kk], bfr[0], bfr[1]);
          mma_bf16(dk[2 * np + 1], dsf[kk], bfr[2], bfr[3]);
        }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }
}

// Shared memory of flash_bwd_q_tile, in bytes: Q, dO and two stages of K
// and V.
template <int DH>
__host__ __device__ constexpr int flash_bwd_q_smem_bytes() {
  return 2 * 6 * kFRows * padded(DH);
}

// dQ of one 64-query tile for one head, looping over the key tiles below
// n_valid: S = Q K^T and dP = dO V^T recomputed, P = exp(S * scale - lse)
// (keys at or past n_valid 0), dS = P (dP - di) * scale, dQ += bf16(dS) K.
// `q` and `dO` point at the tile's first row, `k` and `v` at key row 0,
// `lse_rows` / `di_rows` at the tile's first row of the head's lse / di. On
// return dq holds this thread's two rows (f32).
template <int DH>
DEV void flash_bwd_q_tile(const __nv_bfloat16* __restrict__ q, long long sq,
                          const __nv_bfloat16* __restrict__ k, long long sk,
                          const __nv_bfloat16* __restrict__ v, long long sv,
                          const __nv_bfloat16* __restrict__ dO, long long sdo,
                          const float* __restrict__ lse_rows, const float* __restrict__ di_rows,
                          int n_valid, float scale_log2, float sm_scale,
                          unsigned char* smem, float (&dq)[DH / 8][4]) {
  constexpr int SDH = padded(DH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = warp * 16 + g, row_b = row_a + 8;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sDO = sQ + kFRows * SDH;
  __nv_bfloat16* sK = sDO + kFRows * SDH;  // two stages
  __nv_bfloat16* sV = sK + 2 * kFRows * SDH;

  load_tile_async(sQ, q, kFRows, DH, sq, tid, kFThreads);
  load_tile_async(sDO, dO, kFRows, DH, sdo, tid, kFThreads);
  load_tile_async(sK, k, kFRows, DH, sk, tid, kFThreads);
  load_tile_async(sV, v, kFRows, DH, sv, tid, kFThreads);
  cp_async_commit();

  const float l2_a = lse_rows[row_a] * kLog2e, l2_b = lse_rows[row_b] * kLog2e;
  const float di_a = di_rows[row_a], di_b = di_rows[row_b];

#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  uint32_t qf[DH / 16][4], dof[DH / 16][4];

  const int n_tiles = (n_valid + kFRows - 1) / kFRows;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      const long long r = (long long)(kt + 1) * kFRows;
      load_tile_async(sK + (buf ^ 1) * kFRows * SDH, k + r * sk, kFRows, DH, sk, tid, kFThreads);
      load_tile_async(sV + (buf ^ 1) * kFRows * SDH, v + r * sv, kFRows, DH, sv, tid, kFThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        load_a_frag(qf[kk], sQ, SDH, warp * 16, kk * 16, lane);
        load_a_frag(dof[kk], sDO, SDH, warp * 16, kk * 16, lane);
      }
    }
    const __nv_bfloat16* k_t = sK + buf * kFRows * SDH;
    const __nv_bfloat16* v_t = sV + buf * kFRows * SDH;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, k_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
        load_b_frag_nk(bfr, v_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], dof[kk], bfr[0], bfr[1]);
        mma_bf16(dp[2 * np + 1], dof[kk], bfr[2], bfr[3]);
      }
    // dS = P (dP - di) * scale, P = exp(S * scale - lse); padded keys 0
    const int kv0 = kt * kFRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + t4 * 2 + (e & 1);
        const float p = key < n_valid ? exp2f(s[j][e] * scale_log2 - (e < 2 ? l2_a : l2_b)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? di_a : di_b)) * sm_scale;
      }
    // dQ += dS K (dS rounded to bf16)
    uint32_t dsf[4][4];
    acc_to_a_frags(dsf, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_kn(bfr, k_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(dq[2 * np], dsf[kk], bfr[0], bfr[1]);
        mma_bf16(dq[2 * np + 1], dsf[kk], bfr[2], bfr[3]);
      }
    __syncthreads();
  }
}

}  // namespace dcvit
