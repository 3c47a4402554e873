// bench_attn backward: masked multi-head attention backward from q, k, v, o
// and do alone, the softmax statistics recomputed (no log-sum-exp input).
//
// Replaces the TPU kernel `_bwd_kernel` (scripts/bench_attn.py:94), reached
// through `_bwd_call` (:203, call :206), the benchmark of two schedules of
// the attention backward ("pair_staged" and "pair_batched").
//
// Arithmetic, as the TPU kernel's, per head: P = softmax(q k^T * scale) over
// the keys below n_valid (the others masked to -1e30), di = rowsum(o * do),
// dP = do v^T, dS = P (dP - di) * scale, dq = bf16(dS) k, dk = sum over ALL
// N query rows (padded ones too) of bf16(dS)^T q, dv = the same sum of
// bf16(P)^T do; dk and dv accumulate in f32 and are rounded once.
//
// What bounds it on an H100: operations. The TPU kernel's `CostEstimate`
// (:232) counts 10 * B * N^2 * D FLOP; over the real keys that is
// 10 * B * N * n_valid * D = 641 GFLOP at the benchmark's defaults (B = 64,
// N = 1664, n_valid = 1569, D = 384), 0.65 ms at 989 TFLOP/s, against 491 MB
// of compulsory traffic (five inputs read once, three outputs written once),
// 0.15 ms at 3.35 TB/s.
//
// Design, and what differs from the TPU kernel:
// - The TPU held one image's whole K and V in VMEM and took exact row maxima
//   over them in one pass per query block, accumulating dk and dv in f32
//   VMEM scratch across a sequential query-block axis (:197-200). Here one
//   head's K+V at N = 1664 (416 KB) does not fit a block's 227 KB of shared
//   memory, and blocks run in no order, so the work runs in three kernels,
//   with no float atomics:
//   (a) `stats_kernel`, one block per (64-query tile, head group, image):
//       streams the K tiles and keeps an online row max and sum in f32 (log2
//       domain), then writes each row's log2-sum-exp; it also writes
//       di = rowsum(o_h * do_h). This pass is what this kernel has and the
//       package's flash_packed backward (B6, which reads the forward's lse)
//       does not;
//   (b) `kv_kernel`, one block per (64-key tile, head group, image), loops
//       over every query tile: P^T = exp2(S^T * scale * log2e - lse2), then
//       dv += bf16(P^T) dO and dk += bf16(dS^T) Q in registers, written once;
//   (c) `q_kernel`, one block per (64-query tile, head group, image), loops
//       over the valid key tiles: dq = bf16(dS) K.
//   P from the row statistics equals exp(s - max) / sum up to f32 rounding.
// - `variant` is HP, the heads one block carries: "pair_staged" = 1 (four
//   warps, one head, 64-column tiles), "pair_batched" = 2 (eight warps, the
//   four of each head sharing 128-column tiles of a head pair, so each tile
//   load serves both heads). Each warp runs the same per-head instructions
//   in both, so the two variants agree bit for bit.
// - Keys at or past n_valid get P = 0 exactly, so their dk and dv rows come
//   out exactly 0 (key tiles wholly past n_valid are written as zeros).
// The tile loops follow flash_tiles.cuh's (bf16 `mma.sync.m16n8k16`, f32
// accumulation, cp.async double buffering), written here for HP heads.
#include "flash_tiles.cuh"

namespace dcvit {

// Shared-memory tiles of HP heads of 64 columns: row stride padded(HP * DH).
template <int DH, int HP>
struct Heads {
  static constexpr int W = HP * DH;            // tile columns
  static constexpr int SW = padded(W);         // tile row stride
  static constexpr int kThreads = kFThreads * HP;
  static constexpr int tile = kFRows * SW;     // elements of one 64-row tile
};

// S = Q K^T of this warp's 16 rows x 64 keys, Q as A fragments, the key
// tile at column `hc` of a [64][SW] shared tile.
template <int DH, int SW>
DEV void scores_qk(float (&s)[8][4], const uint32_t (&qf)[DH / 16][4],
                   const __nv_bfloat16* k_t, int hc, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bfr[4];
      load_b_frag_nk(bfr, k_t, SW, np * 16, hc + kk * 16, lane);
      mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
      mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
    }
}

// (a) Row statistics and di. Grid (N / 64, H / HP, B), 128 HP threads.
// lse2[b, h, r] = max_r + log2(sum_r) of the scaled, masked scores in the
// log2 domain; di[b, h, r] = sum over the head's columns of o * do.
template <int DH, int HP>
__global__ void __launch_bounds__(Heads<DH, HP>::kThreads)
    stats_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
                 float* __restrict__ lse2, float* __restrict__ di, int n, int n_valid,
                 float scale_log2) {
  using L = Heads<DH, HP>;
  constexpr int W = L::W, SW = L::SW, NT = L::kThreads;
  const int heads = gridDim.y * HP;
  const int d = heads * DH;
  const int q0 = blockIdx.x * kFRows, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = warp >> 2, wr = warp & 3;  // head within the group, row group
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y * HP + hg, hc = hg * DH;
  const long long img = (long long)b * n, col0 = (long long)blockIdx.y * W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + L::tile;  // two stages
  const __nv_bfloat16* kbase = k + img * d + col0;
  const int n_tiles = (n_valid + kFRows - 1) / kFRows;

  load_tile_async(sQ, q + (img + q0) * d + col0, kFRows, W, d, tid, NT);
  load_tile_async(sK, kbase, kFRows, W, d, tid, NT);
  cp_async_commit();

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t qf[DH / 16][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async(sK + (buf ^ 1) * L::tile, kbase + (long long)(t + 1) * kFRows * d, kFRows,
                      W, d, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        load_a_frag(qf[kk], sQ, SW, wr * 16, hc + kk * 16, lane);
    }
    float s[8][4];
    scores_qk<DH, SW>(s, qf, sK + buf * L::tile, hc, lane);
    const int kv0 = t * kFRows;
    const bool ragged = kv0 + kFRows > n_valid;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + t4 * 2 + (e & 1);
        s[j][e] = (ragged && col >= n_valid) ? -1e30f : __fmul_rn(s[j][e], scale_log2);
      }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    l_a = __fmul_rn(l_a, exp2f(__fsub_rn(m_a, mx_a)));
    l_b = __fmul_rn(l_b, exp2f(__fsub_rn(m_b, mx_b)));
    m_a = mx_a;
    m_b = mx_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l_a = __fadd_rn(l_a, __fadd_rn(exp2f(__fsub_rn(s[j][0], mx_a)),
                                     exp2f(__fsub_rn(s[j][1], mx_a))));
      l_b = __fadd_rn(l_b, __fadd_rn(exp2f(__fsub_rn(s[j][2], mx_b)),
                                     exp2f(__fsub_rn(s[j][3], mx_b))));
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, off));
    l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, off));
  }
  const long long stat = ((long long)b * heads + h) * n + q0;
  if (t4 == 0) {
    lse2[stat + wr * 16 + g] = __fadd_rn(m_a, log2f(l_a));
    lse2[stat + wr * 16 + g + 8] = __fadd_rn(m_b, log2f(l_b));
  }
  // di of the warp's 16 rows of head h, one row per pass, a bf16 pair per lane
  static_assert(DH == 64, "one bf16 pair per lane and head");
  for (int r = wr * 16; r < wr * 16 + 16; ++r) {
    const long long off = (img + q0 + r) * d + h * DH + lane * 2;
    const float2 ov = unpack_bf16(*reinterpret_cast<const uint32_t*>(o + off));
    const float2 dv = unpack_bf16(*reinterpret_cast<const uint32_t*>(dO + off));
    const float sum = warp_sum(__fadd_rn(__fmul_rn(ov.x, dv.x), __fmul_rn(ov.y, dv.y)));
    if (lane == 0) di[stat + r] = sum;
  }
}

// (b) dk and dv. Grid (N / 64, H / HP, B), 128 HP threads.
template <int DH, int HP>
__global__ void __launch_bounds__(Heads<DH, HP>::kThreads)
    kv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
              const float* __restrict__ lse2, const float* __restrict__ di,
              __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out, int n,
              int n_valid, float scale_log2, float sm_scale) {
  using L = Heads<DH, HP>;
  constexpr int W = L::W, SW = L::SW, NT = L::kThreads;
  const int heads = gridDim.y * HP;
  const int d = heads * DH;
  const int k0 = blockIdx.x * kFRows, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y * HP + hg, hc = hg * DH;
  const long long img = (long long)b * n, col0 = (long long)blockIdx.y * W;

  if (k0 >= n_valid) {  // wholly padded key tile: exact zeros
    for (int i = tid; i < kFRows * W / 2; i += NT) {
      const int r = i / (W / 2), c = (i - r * (W / 2)) * 2;
      const long long off = (img + k0 + r) * d + col0 + c;
      *reinterpret_cast<uint32_t*>(dk_out + off) = 0u;
      *reinterpret_cast<uint32_t*>(dv_out + off) = 0u;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + L::tile;
  __nv_bfloat16* sQ = sV + L::tile;        // two stages
  __nv_bfloat16* sDO = sQ + 2 * L::tile;   // two stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * L::tile);  // [2][HP][64] lse2
  float* sD = sL + 2 * HP * kFRows;                          // [2][HP][64] di
  const long long stat0 = ((long long)b * heads + blockIdx.y * HP) * n;

  auto load_q_tile = [&](int qt, int buf) {
    const long long q0 = (long long)qt * kFRows;
    load_tile_async(sQ + buf * L::tile, q + (img + q0) * d + col0, kFRows, W, d, tid, NT);
    load_tile_async(sDO + buf * L::tile, dO + (img + q0) * d + col0, kFRows, W, d, tid, NT);
    // 16 pieces of 4 floats per head and array
    if (tid < 32 * HP) {
      const int hh = tid / 32, i = tid & 31;
      const long long src = stat0 + (long long)hh * n + q0 + (i & 15) * 4;
      float* dst = (i < 16 ? sL : sD) + (buf * HP + hh) * kFRows + (i & 15) * 4;
      cp_async16(dst, (i < 16 ? lse2 : di) + src);
    }
    cp_async_commit();
  };

  load_tile_async(sK, k + (img + k0) * d + col0, kFRows, W, d, tid, NT);
  load_tile_async(sV, v + (img + k0) * d + col0, kFRows, W, d, tid, NT);
  load_q_tile(0, 0);

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key_a = k0 + wr * 16 + g, key_b = key_a + 8;
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
    const __nv_bfloat16* q_t = sQ + buf * L::tile;
    const __nv_bfloat16* do_t = sDO + buf * L::tile;
    const float* l_t = sL + (buf * HP + hg) * kFRows;
    const float* d_t = sD + (buf * HP + hg) * kFRows;

    // S^T = K Q^T: this warp's 16 keys x 64 queries
    float st[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sK, SW, wr * 16, hc + kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, q_t, SW, np * 16, hc + kk * 16, lane);
        mma_bf16(st[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(st[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    // P^T = exp2(S^T * scale * log2e - lse2[query]); padded keys exactly 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        const bool valid = e < 2 ? valid_a : valid_b;
        st[j][e] = valid ? exp2f(__fsub_rn(__fmul_rn(st[j][e], scale_log2), l_t[qc])) : 0.f;
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
          load_b_frag_kn(bfr, do_t, SW, hc + np * 16, kk * 16, lane);
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
      load_a_frag(a, sV, SW, wr * 16, hc + kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, do_t, SW, np * 16, hc + kk * 16, lane);
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
        st[j][e] = __fmul_rn(__fmul_rn(st[j][e], __fsub_rn(dpt[j][e], d_t[qc])), sm_scale);
      }
    {
      uint32_t dsf[4][4];
      acc_to_a_frags(dsf, st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bfr[4];
          load_b_frag_kn(bfr, q_t, SW, hc + np * 16, kk * 16, lane);
          mma_bf16(dk[2 * np], dsf[kk], bfr[0], bfr[1]);
          mma_bf16(dk[2 * np + 1], dsf[kk], bfr[2], bfr[3]);
        }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  const long long ra = (img + key_a) * d + h * DH, rb = (img + key_b) * d + h * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dk_out + ra + col) = pack_bf16(dk[j][0], dk[j][1]);
    *reinterpret_cast<uint32_t*>(dk_out + rb + col) = pack_bf16(dk[j][2], dk[j][3]);
    *reinterpret_cast<uint32_t*>(dv_out + ra + col) = pack_bf16(dv[j][0], dv[j][1]);
    *reinterpret_cast<uint32_t*>(dv_out + rb + col) = pack_bf16(dv[j][2], dv[j][3]);
  }
}

// (c) dq. Grid (N / 64, H / HP, B), 128 HP threads.
template <int DH, int HP>
__global__ void __launch_bounds__(Heads<DH, HP>::kThreads)
    q_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
             const float* __restrict__ lse2, const float* __restrict__ di,
             __nv_bfloat16* __restrict__ dq_out, int n, int n_valid, float scale_log2,
             float sm_scale) {
  using L = Heads<DH, HP>;
  constexpr int W = L::W, SW = L::SW, NT = L::kThreads;
  const int heads = gridDim.y * HP;
  const int d = heads * DH;
  const int q0 = blockIdx.x * kFRows, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y * HP + hg, hc = hg * DH;
  const int row_a = wr * 16 + g, row_b = row_a + 8;
  const long long img = (long long)b * n, col0 = (long long)blockIdx.y * W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + L::tile;
  __nv_bfloat16* sK = sDO + L::tile;      // two stages
  __nv_bfloat16* sV = sK + 2 * L::tile;   // two stages
  const __nv_bfloat16* kbase = k + img * d + col0;
  const __nv_bfloat16* vbase = v + img * d + col0;

  load_tile_async(sQ, q + (img + q0) * d + col0, kFRows, W, d, tid, NT);
  load_tile_async(sDO, dO + (img + q0) * d + col0, kFRows, W, d, tid, NT);
  load_tile_async(sK, kbase, kFRows, W, d, tid, NT);
  load_tile_async(sV, vbase, kFRows, W, d, tid, NT);
  cp_async_commit();

  const long long stat = ((long long)b * heads + h) * n + q0;
  const float l2_a = lse2[stat + row_a], l2_b = lse2[stat + row_b];
  const float di_a = di[stat + row_a], di_b = di[stat + row_b];

  float dq[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  uint32_t qf[DH / 16][4], dof[DH / 16][4];

  const int n_tiles = (n_valid + kFRows - 1) / kFRows;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      const long long r = (long long)(kt + 1) * kFRows * d;
      load_tile_async(sK + (buf ^ 1) * L::tile, kbase + r, kFRows, W, d, tid, NT);
      load_tile_async(sV + (buf ^ 1) * L::tile, vbase + r, kFRows, W, d, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        load_a_frag(qf[kk], sQ, SW, wr * 16, hc + kk * 16, lane);
        load_a_frag(dof[kk], sDO, SW, wr * 16, hc + kk * 16, lane);
      }
    }
    const __nv_bfloat16* k_t = sK + buf * L::tile;
    const __nv_bfloat16* v_t = sV + buf * L::tile;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
    scores_qk<DH, SW>(s, qf, k_t, hc, lane);
    scores_qk<DH, SW>(dp, dof, v_t, hc, lane);
    // dS = P (dP - di) * scale, P = exp2(S * scale * log2e - lse2); padded keys 0
    const int kv0 = kt * kFRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + t4 * 2 + (e & 1);
        const float p = key < n_valid
                            ? exp2f(__fsub_rn(__fmul_rn(s[j][e], scale_log2), e < 2 ? l2_a : l2_b))
                            : 0.f;
        s[j][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][e], e < 2 ? di_a : di_b)), sm_scale);
      }
    // dQ += dS K (dS rounded to bf16)
    uint32_t dsf[4][4];
    acc_to_a_frags(dsf, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_kn(bfr, k_t, SW, hc + np * 16, kk * 16, lane);
        mma_bf16(dq[2 * np], dsf[kk], bfr[0], bfr[1]);
        mma_bf16(dq[2 * np + 1], dsf[kk], bfr[2], bfr[3]);
      }
    __syncthreads();
  }

  __nv_bfloat16* drow = dq_out + (img + q0) * d + h * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(drow + (long long)row_a * d + col) = pack_bf16(dq[j][0], dq[j][1]);
    *reinterpret_cast<uint32_t*>(drow + (long long)row_b * d + col) = pack_bf16(dq[j][2], dq[j][3]);
  }
}

template <int HP>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* o, const __nv_bfloat16* dout, __nv_bfloat16* dq,
           __nv_bfloat16* dk, __nv_bfloat16* dv, float* lse2, float* di, int batch, int n,
           int heads, int n_valid, float sm_scale, cudaStream_t st) {
  using L = Heads<64, HP>;
  const dim3 grid(n / kFRows, heads / HP, batch);
  const float scale_log2 = sm_scale * kLog2e;
  cudaError_t err;

  auto stats = stats_kernel<64, HP>;
  const int stats_smem = (int)sizeof(__nv_bfloat16) * 3 * L::tile;
  if ((err = cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  stats_smem)) != cudaSuccess)
    return (int)err;
  stats<<<grid, L::kThreads, stats_smem, st>>>(q, k, o, dout, lse2, di, n, n_valid, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto kv = kv_kernel<64, HP>;
  const int kv_smem = (int)sizeof(__nv_bfloat16) * 6 * L::tile + 4 * 2 * 2 * HP * kFRows;
  if ((err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem)) !=
      cudaSuccess)
    return (int)err;
  kv<<<grid, L::kThreads, kv_smem, st>>>(q, k, v, dout, lse2, di, dk, dv, n, n_valid, scale_log2,
                                         sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto qk = q_kernel<64, HP>;
  const int q_smem = (int)sizeof(__nv_bfloat16) * 6 * L::tile;
  if ((err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem)) !=
      cudaSuccess)
    return (int)err;
  qk<<<grid, L::kThreads, q_smem, st>>>(q, k, v, dout, lse2, di, dq, n, n_valid, scale_log2,
                                        sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). q, k, v, o, dout, dq, dk, dv:
// (B, N, H * head_dim) bf16 contiguous; lse2 and di: (B, H, N) f32
// contiguous scratch. heads_per_block is the variant: 1 ("pair_staged") or 2
// ("pair_batched", H even). Returns a cudaError_t: the first failed launch's,
// or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int dcvit_bench_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, void* dq, void* dk, void* dv, void* lse2,
                                    void* di, int batch, int n, int heads, int head_dim,
                                    int n_valid, float sm_scale, int heads_per_block,
                                    void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  if (head_dim != 64 || n < kFRows || n % kFRows != 0 || n_valid < 1 || n_valid > n ||
      batch < 1 || batch > 65535 || heads < 1 || (heads_per_block != 1 && heads_per_block != 2) ||
      heads % heads_per_block != 0)
    return (int)cudaErrorInvalidValue;
  auto run = heads_per_block == 1 ? launch<1> : launch<2>;
  return run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const bf16*>(o),
             static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
             static_cast<bf16*>(dv), static_cast<float*>(lse2), static_cast<float*>(di), batch, n,
             heads, n_valid, sm_scale, static_cast<cudaStream_t>(stream));
}
