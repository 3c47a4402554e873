// attend_project backward: given dxo, the gradients of the packed qkv
// ([dq | dk | dv]), of the output projection (dWp, dbp) and of the qkv bias,
// for the forward in attend_project.cu.
//
// Replaces the TPU kernel `_ap_bwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:713), reached through
// `_ap_bwd_impl` (:869) and `_apa_vjp_bwd` (:948).
//
// What bounds it on an H100: operations, of two kinds. Per image and layer
// at the DiChaViT-S flagship (1569 real rows and keys, D = 384, 6 heads of
// 64) the function needs 10 * rows * keys * D + 4 * rows * D^2 = 10.4 GFLOP
// of bf16 products (6.6e11 at B = 64: 0.67 ms at 989 TFLOP/s) against about
// 11 MB of compulsory traffic; and, with P recomputed in each of its two
// attention passes, 2 x 6 x 1569^2 exponentials per image (1.9e9 at B = 64:
// about 0.48 ms at the special-function units' ~3.9 T exp2/s).
//
// Design (flash_wgmma.cuh on wgmma_core.cuh), and what differs from the TPU
// kernel:
// - The TPU ran grid (b, q-block) with the whole K/V row resident in VMEM and
//   accumulated dk, dv, dWp, dbp and the bias sums in VMEM scratch across a
//   sequential q axis. Here K+V of one head (400 KB at N = 1600) does not fit
//   a block's shared memory, and blocks run in no order. So the work splits
//   FlashAttention-2 style into passes, every product a `wgmma` on tiles
//   brought in by TMA, every reduction in a fixed order and none through
//   atomics (two calls on the same inputs agree bit for bit):
//   (a) `ap_bwd_pre_kernel`, per 128 rows: do = dxo Wp (rounded to bf16, as
//       the TPU rounded it) in chunks of two heads, di = rowsum(o_h * do_h)
//       per head in f32, and the per-64-row column sums of dxo (dbp);
//   (b) `ap_bwd_kv_kernel`, one block per (64 keys, head, image), K and V
//       resident, the (Q, dO, lse, di) tiles of 64 queries streamed through
//       a four-stage ring: S^T = K Q^T and dP^T = V dO^T from shared memory,
//       P^T = exp2(S^T scale log2e - lse log2e) (lse from the forward
//       kernel), dS^T = P^T (dP^T - di) * scale, then dV += P^T dO and
//       dK += dS^T Q with P^T and dS^T packed to bf16 as the register A
//       operands. dk and dv stay in f32 registers and are written once, with
//       their column sums (the k and v bias gradients);
//   (c) `ap_bwd_q_kernel`, one block per (64 queries, head, image), Q and
//       dO resident, the (K, V) tiles of 64 keys below `n_valid` streamed:
//       S = Q K^T and dP = dO V^T recomputed, dQ += dS K with dS from
//       registers, issued with the next tile's S and dP; and the column sums
//       of the rounded dq (the q bias gradient, as the TPU summed its
//       rounded dq). Recomputing S and dP in a second pass costs 40% more
//       products than one pass that adds dq across key blocks, but needs no
//       ordering across blocks;
//   (d) `ap_wgrad_kernel`: dWp = dxo^T o over every row, split-row partials
//       on 128 x 128 output tiles, both operands MN-major (wgmma's transposed
//       layout, straight from the row-major tensors);
//   (e) the per-block bias partials and dWp partials summed in a fixed order
//       (reduce.cuh).
//   (b) and (c) run three blocks of one warpgroup on each SM, so one block's
//   exponentials run while another's products do. (Blocks of 128 rows, two
//   consumer warpgroups taking turns issuing their products, were slower on
//   an H100; free-running warpgroups in such blocks, slower still.)
// - Keys at or past `n_valid` get P = 0 exactly, so their dk and dv rows come
//   out exactly 0: dW_qkv = y^T [dq | dk | dv] sums over all N rows, and a
//   stray value in a padded key row would reach a weight gradient that no
//   output check sees. Key tiles wholly past `n_valid` are written as zeros.
// - P and dS are rounded to bf16 before their products, as on the TPU; all
//   accumulators are f32. Rows past the end (the ragged last 128-row block
//   of (a)) load as zeros and are skipped or clipped by the stores.
#include "flash_wgmma.cuh"
#include "reduce.cuh"

namespace dcvit {

constexpr int kBRows = 64;  // rows per tile of the bias partials
// (a) and (d): blocks of two consumer warpgroups (128 rows or output rows)
// and one producer warp
constexpr int kGemmRows = 2 * fw::kWgRows;
constexpr int kGemmThreads = 2 * 128 + 32;

// (a): a stage holds dxo rows [128][64 of D_out] (K-major) and Wp rows [64
// of D_out] x 128 columns of D (two MN-major [64][64] boxes)
constexpr int kPreStages = 4;
constexpr int kPreStageBytes = 4 * wg::kBoxBytes;
constexpr int kPreSmem = kPreStages * kPreStageBytes + 2 * kPreStages * 8 + wg::kAlign;
// (d): a stage holds 64 rows of dxo (two [64][64] boxes, 128 columns of
// D_out) and of o (two, 128 columns of D), both MN-major
constexpr int kWgStages = 4;
constexpr int kWgStageBytes = 4 * wg::kBoxBytes;
constexpr int kWgSmem = kWgStages * kWgStageBytes + 2 * kWgStages * 8 + wg::kAlign;

// The ring's barriers, initialised by thread 0 before the roles split.
DEV void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], wg::kConsumers);
    }
    wg::bar_init_fence();
  }
  __syncthreads();
}

// (a) do = dxo Wp (rounded to bf16), di = rowsum(o_h do_h) per head (f32),
// and the dbp partials (column sums of dxo per 64-row tile). Grid
// (ceil(B N / 128)); the block walks D in chunks of 128 columns (two heads),
// each a K loop over D_out.
__global__ void __launch_bounds__(kGemmThreads, 1)
    ap_bwd_pre_kernel(const __grid_constant__ CUtensorMap dxo128,
                      const __grid_constant__ CUtensorMap wp64, const __nv_bfloat16* __restrict__ o,
                      __nv_bfloat16* __restrict__ do_out, float* __restrict__ di,
                      float* __restrict__ bias_part, int rows, int n, int heads, int d_out,
                      int bias_stride) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPreStages * kPreStageBytes);
  uint64_t* empty = full + kPreStages;
  const int wgi = wg::warpgroup(), t = threadIdx.x & 127;
  const int d = heads * fw::kHd, r0 = blockIdx.x * kGemmRows;
  const int n_kc = d_out / wg::kBox, n_chunks = (d + 2 * wg::kBox - 1) / (2 * wg::kBox);
  init_ring(full, empty, kPreStages);

  if (wgi == wg::kConsumers) {
    if (t == 0) {
      int it = 0;
      for (int c = 0; c < n_chunks; ++c)
        for (int kc = 0; kc < n_kc; ++kc, ++it) {
          const int s = it % kPreStages;
          wg::bar_wait(&empty[s], ((it / kPreStages) & 1) ^ 1);
          wg::bar_expect_tx(&full[s], kPreStageBytes);
          uint8_t* st = ring + s * kPreStageBytes;
          wg::tma_load(st, &dxo128, &full[s], kc * wg::kBox, r0);
          wg::tma_load(st + 2 * wg::kBoxBytes, &wp64, &full[s], 2 * wg::kBox * c, kc * wg::kBox);
          wg::tma_load(st + 3 * wg::kBoxBytes, &wp64, &full[s], 2 * wg::kBox * c + wg::kBox,
                       kc * wg::kBox);
        }
    }
  } else {
    const uint32_t ring_s = smem_addr(ring);
    const int rw = r0 + fw::kWgRows * wgi;  // this warpgroup's first row
    const int row_a = rw + wg::acc_row(t, 0), row_b = row_a + 8;
    int it = 0;
    for (int c = 0; c < n_chunks; ++c) {
      float acc[64];  // do: 64 rows x 128 columns (heads 2c and 2c + 1)
      for (int kc = 0; kc < n_kc; ++kc, ++it) {
        const int s = it % kPreStages;
        wg::bar_wait(&full[s], (it / kPreStages) & 1);
        const uint32_t st = wg::opaque(ring_s) + s * kPreStageBytes;
        wg::mma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          wg::mma_m64n128<0, 1>(acc, wg::desc_k(st + wgi * fw::kHalfBox, k4),
                                wg::desc_mn(st + 2 * wg::kBoxBytes, k4, wg::kBoxBytes),
                                kc + k4 > 0);
        wg::mma_commit();
        if (c == 0 && t < wg::kBox && rw < rows) {
          // dbp partial: this warpgroup's 64 rows of dxo column 64 kc + t
          const uint8_t* box = ring + s * kPreStageBytes + wgi * fw::kHalfBox;
          float sum = 0.f;
          for (int r = 0; r < fw::kWgRows; ++r)
            sum += bf(*reinterpret_cast<const __nv_bfloat16*>(box + wg::swz(r, t)));
          bias_part[(long long)(rw / kBRows) * bias_stride + kc * wg::kBox + t] = sum;
        }
        wg::mma_wait<0>();
        if (t == 0) wg::bar_arrive(&empty[s]);
      }
      wg::acc_fence(acc);
      // round do to bf16; di = sum over each head's columns of o * do (f32)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 2 * c + hh;
        float di_a = 0.f, di_b = 0.f;
#pragma unroll
        for (int i = 32 * hh; i < 32 * hh + 32; i += 2) {
          const bool rb = (i >> 1) & 1;
          const int row = rb ? row_b : row_a;
          const int col = 2 * wg::kBox * c + wg::acc_col(t, i);
          if (h < heads && row < rows) {
            const long long g = (long long)row * d + col;
            const uint32_t v = pack_bf16(acc[i], acc[i + 1]);
            *reinterpret_cast<uint32_t*>(do_out + g) = v;
            const float2 f = unpack_bf16(v);
            const float2 ov = unpack_bf16(*reinterpret_cast<const uint32_t*>(o + g));
            (rb ? di_b : di_a) += f.x * ov.x + f.y * ov.y;
          }
        }
        di_a = sum_over_quad(di_a);
        di_b = sum_over_quad(di_b);
        if (h < heads && (t & 3) == 0) {
          if (row_a < rows) di[((long long)(row_a / n) * heads + h) * n + row_a % n] = di_a;
          if (row_b < rows) di[((long long)(row_b / n) * heads + h) * n + row_b % n] = di_b;
        }
      }
    }
  }
}

// (b) and (c): blocks of one warpgroup (128 threads), three an SM. Thread 0
// issues the TMA loads: a stage is refilled as soon as the warpgroup has
// finished with it. (A producer warp beside the warpgroup, 160 threads and
// two blocks an SM within the 168 registers a thread that (b) needs, was
// slower on an H100.) (b): K and V of the block's 64 keys resident; a stage
// holds the (Q, dO) boxes of 64 queries and their 64 lse and 64 di values.
// (c): Q and dO of the block's 64 queries resident; a stage holds the (K, V)
// boxes of 64 keys.
constexpr int kFlashThreads = 128;
constexpr int kKvStages = 3;
constexpr int kKvStageBytes = 17 * 1024;
constexpr int kKvSmem = 2 * wg::kBoxBytes + kKvStages * kKvStageBytes + 4 * 2 * 64 * 4 +
                        (kKvStages + 1) * 8 + wg::kAlign;
constexpr int kQStages = 3;
constexpr int kQStageBytes = 2 * wg::kBoxBytes;
constexpr int kQSmem = 2 * wg::kBoxBytes + kQStages * kQStageBytes + 4 * 64 * 4 +
                       (kQStages + 1) * 8 + wg::kAlign;

// The stages' full barriers and one more for the resident boxes, initialised
// by thread 0 before any load.
DEV void init_bars(uint64_t* full, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s <= stages; ++s) wg::bar_init(&full[s], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
}

// (b) dk, dv and their column sums. Grid (N / 64, heads, B).
__global__ void __launch_bounds__(kFlashThreads, 3)
    ap_bwd_kv_kernel(const __grid_constant__ CUtensorMap qkv64,
                     const __grid_constant__ CUtensorMap do64,
                     const __grid_constant__ CUtensorMap dqkv64, const float* __restrict__ lse,
                     const float* __restrict__ di, __nv_bfloat16* __restrict__ dqkv,
                     float* __restrict__ bias_part, int n, int n_valid, float scale_log2,
                     float sm_scale, int d_out, int bias_stride) {
  const int heads = gridDim.y, d = heads * fw::kHd;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * fw::kWgRows, hc = h * fw::kHd;
  float* part = bias_part + ((long long)b * (n / kBRows) + blockIdx.x) * bias_stride + d_out;
  const int tid = threadIdx.x;

  if (k0 >= n_valid) {  // wholly padded keys: exact zeros
    const long long row3 = 3LL * d;
    __nv_bfloat16* dbase = dqkv + ((long long)b * n + k0) * row3 + hc;
    for (int i = tid; i < fw::kWgRows * (fw::kHd / 2); i += kFlashThreads) {
      const long long off = (long long)(i / (fw::kHd / 2)) * row3 + (i % (fw::kHd / 2)) * 2;
      *reinterpret_cast<uint32_t*>(dbase + off + d) = 0u;
      *reinterpret_cast<uint32_t*>(dbase + off + 2 * d) = 0u;
    }
    for (int c = tid; c < fw::kHd; c += kFlashThreads) {
      part[d + hc + c] = 0.f;
      part[2 * d + hc + c] = 0.f;
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = wg::align(smem_raw);
  uint8_t* sV = sK + wg::kBoxBytes;
  uint8_t* ring = sV + wg::kBoxBytes;
  float* red = reinterpret_cast<float*>(ring + kKvStages * kKvStageBytes);  // [4 warps][2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * 2 * fw::kHd);
  uint64_t* kvbar = full + kKvStages;
  const int t = tid;
  const int nq = n / fw::kWgRows;
  init_bars(full, kKvStages);

  const float* lrow = lse + ((long long)b * heads + h) * n;
  const float* drow = di + ((long long)b * heads + h) * n;
  auto load_q = [&](int qt) {
    const int s = qt % kKvStages;
    wg::bar_expect_tx(&full[s], 2 * wg::kBoxBytes + 2 * 256);
    uint8_t* st = ring + s * kKvStageBytes;
    fw::tma_load3(st, &qkv64, &full[s], hc, qt * fw::kWgRows, b);
    fw::tma_load3(st + wg::kBoxBytes, &do64, &full[s], hc, qt * fw::kWgRows, b);
    fw::bulk_load(st + 2 * wg::kBoxBytes, lrow + qt * fw::kWgRows, 256, &full[s]);
    fw::bulk_load(st + 2 * wg::kBoxBytes + 256, drow + qt * fw::kWgRows, 256, &full[s]);
  };
  if (t == 0) {
    wg::bar_expect_tx(kvbar, 2 * wg::kBoxBytes);
    fw::tma_load3(sK, &qkv64, kvbar, d + hc, k0, b);
    fw::tma_load3(sV, &qkv64, kvbar, 2 * d + hc, k0, b);
    for (int qt = 0; qt < kKvStages && qt < nq; ++qt) load_q(qt);
  }
  float dk[32], dv[32];
  wg::acc_zero(dk);
  wg::acc_zero(dv);
  const int key_a = k0 + wg::acc_row(t, 0);
  const bool valid_a = key_a < n_valid, valid_b = key_a + 8 < n_valid;
  const uint32_t ring_s = smem_addr(ring), k_s = smem_addr(sK), v_s = smem_addr(sV);
  wg::bar_wait(kvbar, 0);
  // Two product groups a query tile, each waited in the same tile: issuing
  // a tile's dV and dK with the next tile's S^T and dP^T would hold dk, dv,
  // both score tiles and both packed operands live at once, past the 168
  // registers a thread that three blocks an SM allow.
  for (int qt = 0; qt < nq; ++qt) {
    const int s = qt % kKvStages;
    wg::bar_wait(&full[s], (qt / kKvStages) & 1);
    const uint32_t st = wg::opaque(ring_s) + s * kKvStageBytes;
    const float* l_t = reinterpret_cast<const float*>(ring + s * kKvStageBytes + 2 * wg::kBoxBytes);
    const float* d_t = l_t + fw::kWgRows;
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float sc[32], dp[32];
    wg::mma_fence();
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
      wg::mma_m64n64<0, 0>(sc, wg::desc_k(wg::opaque(k_s), k4), wg::desc_k(st, k4), k4 > 0);
    wg::mma_commit();
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
      wg::mma_m64n64<0, 0>(dp, wg::desc_k(wg::opaque(v_s), k4),
                           wg::desc_k(st + wg::kBoxBytes, k4), k4 > 0);
    wg::mma_commit();
    // P^T = exp2(S^T scale log2e - lse log2e); padded keys exactly 0
    wg::mma_wait<1>();
    wg::acc_fence(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(l_t + wg::acc_col(t, 4 * j));
      const float la = l2.x * fw::kLog2e, lb = l2.y * fw::kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = (e & 2) ? valid_b : valid_a;
        const int i = 4 * j + e;
        sc[i] = valid ? fw::ex2(sc[i] * scale_log2 - ((e & 1) ? lb : la)) : 0.f;
      }
    }
    // dS^T = P^T (dP^T - di) * scale
    wg::mma_wait<0>();
    wg::acc_fence(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(d_t + wg::acc_col(t, 4 * j));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dp[i] = sc[i] * (dp[i] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
      }
    }
    uint32_t pp[4][4], dsp[4][4];
    fw::pack_a(pp, sc);
    fw::pack_a(dsp, dp);
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers
    wg::mma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      fw::mma_rs_m64n64<1>(dv, pp[ks], wg::desc_mn(st + wg::kBoxBytes, ks, wg::kBoxBytes), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      fw::mma_rs_m64n64<1>(dk, dsp[ks], wg::desc_mn(st, ks, wg::kBoxBytes), 1);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(dv);
    wg::acc_fence(dk);
    fw::frag_fence(pp);
    fw::frag_fence(dsp);
    wg::sync_named(1, 128);  // every warp is done with the stage
    if (t == 0 && qt + kKvStages < nq) load_q(qt + kKvStages);
  }

  // dk and dv (bf16) into the K and V boxes, then out by TMA
  fw::store_tile(sK, dk, t);
  fw::store_tile(sV, dv, t);
  wg::fence_async_smem();
  wg::sync_named(1, 128);
  if (t == 0) {
    fw::tma_store3(&dqkv64, sK, d + hc, k0, b);
    fw::tma_store3(&dqkv64, sV, 2 * d + hc, k0, b);
    wg::tma_store_commit();
  }
  // column sums of the f32 accumulators, as the TPU summed its f32
  // scratch: over the thread's two rows, the warp's eight row groups, then
  // the four warps in order
  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sk = sum_over_rows(dk[4 * j + e] + dk[4 * j + 2 + e]);
      const float sv = sum_over_rows(dv[4 * j + e] + dv[4 * j + 2 + e]);
      if (lane < 4) {
        red[(warp * 2) * fw::kHd + 8 * j + 2 * lane + e] = sk;
        red[(warp * 2 + 1) * fw::kHd + 8 * j + 2 * lane + e] = sv;
      }
    }
  wg::sync_named(1, 128);
  {
    const int which = t >> 6, c = t & 63;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += red[(w * 2 + which) * fw::kHd + c];
    part[(1 + which) * d + hc + c] = sum;
  }
  if (t == 0) wg::tma_store_wait();
}

// (c)'s products S = Q K^T and dP = dO V^T: 64 queries x 64 keys, the Q and
// dO boxes at `qa` and `doa`, the (K, V) stage at `st`.
DEV void ap_q_scores(float (&sc)[32], float (&dp)[32], uint32_t qa, uint32_t doa, uint32_t st) {
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4)
    wg::mma_m64n64<0, 0>(sc, wg::desc_k(qa, k4), wg::desc_k(st, k4), k4 > 0);
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4)
    wg::mma_m64n64<0, 0>(dp, wg::desc_k(doa, k4), wg::desc_k(st + wg::kBoxBytes, k4), k4 > 0);
}

// (c)'s dS = P (dP - di) * scale into sc, P = exp2(S scale log2e - lse
// log2e), keys kv0 + column at or past n_valid 0; the thread's rows' lse
// (times log2e) and di in l2_* and di_*.
DEV void ap_q_ds(float (&sc)[32], const float (&dp)[32], int kv0, int n_valid, float scale_log2,
                 float sm_scale, float l2_a, float l2_b, float di_a, float di_b, int t) {
  const bool ragged = kv0 + fw::kWgRows > n_valid;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool rb = (i >> 1) & 1;
    const bool valid = !ragged || kv0 + wg::acc_col(t, i) < n_valid;
    const float p = valid ? fw::ex2(sc[i] * scale_log2 - (rb ? l2_b : l2_a)) : 0.f;
    sc[i] = p * (dp[i] - (rb ? di_b : di_a)) * sm_scale;
  }
}

// (c) dq and its column sums. Grid (N / 64, heads, B).
__global__ void __launch_bounds__(kFlashThreads, 3)
    ap_bwd_q_kernel(const __grid_constant__ CUtensorMap qkv64,
                    const __grid_constant__ CUtensorMap do64,
                    const __grid_constant__ CUtensorMap dqkv64, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ bias_part, int n,
                    int n_valid, float scale_log2, float sm_scale, int d_out, int bias_stride) {
  const int heads = gridDim.y;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * fw::kWgRows, hc = h * fw::kHd;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = wg::align(smem_raw);
  uint8_t* sDO = sQ + wg::kBoxBytes;
  uint8_t* ring = sDO + wg::kBoxBytes;
  float* red = reinterpret_cast<float*>(ring + kQStages * kQStageBytes);  // [4 warps][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * fw::kHd);
  uint64_t* qbar = full + kQStages;
  const int t = threadIdx.x;
  const int d = heads * fw::kHd;
  const int n_kt = (n_valid + fw::kWgRows - 1) / fw::kWgRows;
  init_bars(full, kQStages);

  auto load_k = [&](int kt) {
    const int s = kt % kQStages;
    wg::bar_expect_tx(&full[s], kQStageBytes);
    uint8_t* st = ring + s * kQStageBytes;
    fw::tma_load3(st, &qkv64, &full[s], d + hc, kt * fw::kWgRows, b);
    fw::tma_load3(st + wg::kBoxBytes, &qkv64, &full[s], 2 * d + hc, kt * fw::kWgRows, b);
  };
  if (t == 0) {
    wg::bar_expect_tx(qbar, 2 * wg::kBoxBytes);
    fw::tma_load3(sQ, &qkv64, qbar, hc, q0, b);
    fw::tma_load3(sDO, &do64, qbar, hc, q0, b);
    for (int kt = 0; kt < kQStages && kt < n_kt; ++kt) load_k(kt);
  }
  const int row_a = q0 + wg::acc_row(t, 0), row_b = row_a + 8;
  const long long stat = ((long long)b * heads + h) * n;
  const float l2_a = lse[stat + row_a] * fw::kLog2e, l2_b = lse[stat + row_b] * fw::kLog2e;
  const float di_a = di[stat + row_a], di_b = di[stat + row_b];
  float dq[32];
  wg::acc_zero(dq);
  const uint32_t ring_s = smem_addr(ring), q_s = smem_addr(sQ), do_s = smem_addr(sDO);
  wg::bar_wait(qbar, 0);
  // Key tile kt > 0 issues S_kt and dP_kt together with dQ += dS_{kt-1}
  // K_{kt-1}, and computes dS_kt while that product runs. Tile 0 is peeled
  // off, so that the loop body issues the same products and waits every
  // time (ptxas serialises the products of a loop whose groups and waits
  // depend on a branch).
  uint32_t dsp[4][4];  // dS of the previous tile, bf16
  float sc[32], dp[32];
  int s = 0;
  wg::bar_wait(&full[0], 0);
  uint32_t st = wg::opaque(ring_s);
  wg::mma_fence();
  ap_q_scores(sc, dp, wg::opaque(q_s), wg::opaque(do_s), st);
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::acc_fence(sc);
  wg::acc_fence(dp);
  ap_q_ds(sc, dp, 0, n_valid, scale_log2, sm_scale, l2_a, l2_b, di_a, di_b, t);
  fw::pack_a(dsp, sc);
  for (int kt = 1; kt < n_kt; ++kt) {
    const uint32_t k_prev = st;
    s = kt % kQStages;
    wg::bar_wait(&full[s], (kt / kQStages) & 1);
    st = wg::opaque(ring_s) + s * kQStageBytes;
    wg::mma_fence();
    ap_q_scores(sc, dp, wg::opaque(q_s), wg::opaque(do_s), st);
    wg::mma_commit();
    // dQ += dS K of the previous tile, a pipeline stage of its own
    wg::mma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      fw::mma_rs_m64n64<1>(dq, dsp[ks], wg::desc_mn(k_prev, ks, wg::kBoxBytes), 1);
    wg::mma_commit();
    wg::mma_wait<1>();
    wg::acc_fence(sc);
    wg::acc_fence(dp);
    ap_q_ds(sc, dp, kt * fw::kWgRows, n_valid, scale_log2, sm_scale, l2_a, l2_b, di_a, di_b, t);
    wg::mma_wait<0>();  // the previous tile's product has ended: its stage is free
    wg::acc_fence(dq);
    fw::frag_fence(dsp);
    wg::sync_named(1, 128);  // every warp is done with the previous tile's stage
    if (t == 0 && kt - 1 + kQStages < n_kt) load_k(kt - 1 + kQStages);
    fw::pack_a(dsp, sc);
  }
  // the last tile's dQ
  wg::mma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    fw::mma_rs_m64n64<1>(dq, dsp[ks], wg::desc_mn(st, ks, wg::kBoxBytes), 1);
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::acc_fence(dq);
  fw::frag_fence(dsp);

  // dq rounded to bf16 into the Q box, out by TMA; column sums of the
  // rounded values
  float cs[16];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const uint32_t v = pack_bf16(dq[i], dq[i + 1]);
    *reinterpret_cast<uint32_t*>(sQ + wg::swz(wg::acc_row(t, i), wg::acc_col(t, i))) = v;
    const float2 f = unpack_bf16(v);
    const int j = ((i >> 2) << 1);  // column pair (i / 4), element (i & 1)
    if ((i >> 1) & 1) {
      cs[j] += f.x;
      cs[j + 1] += f.y;
    } else {
      cs[j] = f.x;
      cs[j + 1] = f.y;
    }
  }
  wg::fence_async_smem();
  wg::sync_named(1, 128);
  if (t == 0) {
    fw::tma_store3(&dqkv64, sQ, hc, q0, b);
    wg::tma_store_commit();
  }
  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float v = sum_over_rows(cs[j]);
    if (lane < 4) red[warp * fw::kHd + 8 * (j >> 1) + 2 * lane + (j & 1)] = v;
  }
  wg::sync_named(1, 128);
  if (t < fw::kHd) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += red[w * fw::kHd + t];
    bias_part[((long long)b * (n / kBRows) + blockIdx.x) * bias_stride + d_out + hc + t] = sum;
  }
  if (t == 0) wg::tma_store_wait();
}

// (d) dWp = dxo^T o over every row: block (128 x 128 output tile, split z)
// writes part[z] = the sum over the rows of split z, in order; rows past the
// end load as zeros. Grid (ceil(D_out / 128) ceil(D / 128), splits).
__global__ void __launch_bounds__(kGemmThreads, 1)
    ap_wgrad_kernel(const __grid_constant__ CUtensorMap dxo64, const __grid_constant__ CUtensorMap o64,
                    float* __restrict__ part, int rows, int d_out, int d, int rows_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int wgi = wg::warpgroup(), t = threadIdx.x & 127;
  const int tiles_n = (d + 2 * wg::kBox - 1) / (2 * wg::kBox);
  const int i1 = (blockIdx.x / tiles_n) * 2 * wg::kBox, i2 = (blockIdx.x % tiles_n) * 2 * wg::kBox;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = r_begin + rows_per_split < rows ? r_begin + rows_per_split : rows;
  const int n_steps = r_end > r_begin ? (r_end - r_begin + wg::kBox - 1) / wg::kBox : 0;
  init_ring(full, empty, kWgStages);

  if (wgi == wg::kConsumers) {
    if (t == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kWgStages, r = r_begin + i * wg::kBox;
        wg::bar_wait(&empty[s], ((i / kWgStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kWgStageBytes);
        uint8_t* st = ring + s * kWgStageBytes;
        for (int b = 0; b < 2; ++b) {
          wg::tma_load(st + b * wg::kBoxBytes, &dxo64, &full[s], i1 + b * wg::kBox, r);
          wg::tma_load(st + (2 + b) * wg::kBoxBytes, &o64, &full[s], i2 + b * wg::kBox, r);
        }
      }
    }
  } else {
    float acc[64];  // dWp rows [i1 + 64 wgi, + 64) x columns [i2, i2 + 128)
    wg::acc_zero(acc);
    const uint32_t ring_s = smem_addr(ring);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kWgStages;
      wg::bar_wait(&full[s], (i / kWgStages) & 1);
      const uint32_t st = wg::opaque(ring_s) + s * kWgStageBytes;
      wg::mma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wg::mma_m64n128<1, 1>(acc, wg::desc_mn(st + wgi * wg::kBoxBytes, k4, wg::kBoxBytes),
                              wg::desc_mn(st + 2 * wg::kBoxBytes, k4, wg::kBoxBytes), 1);
      wg::mma_commit();
      wg::mma_wait<0>();
      if (t == 0) wg::bar_arrive(&empty[s]);
    }
    wg::acc_fence(acc);
    float* out = part + (long long)blockIdx.y * d_out * d;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = i1 + fw::kWgRows * wgi + wg::acc_row(t, i), c = i2 + wg::acc_col(t, i);
      if (r < d_out && c < d)
        *reinterpret_cast<float2*>(out + (long long)r * d + c) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: qkv and dqkv (B, N, 3D)
// packed [q | k | v], o and do_buf (B, N, D), dxo (B, N, D_out), all bf16;
// wp (D_out, D) bf16 in nn.Linear layout; lse and di (B, H, N) f32; dwp
// (D_out, D) f32; bias_out (D_out + 3D) f32 = [dbp | dbq | dbk | dbv];
// bias_part (B * N / 64, D_out + 3D) f32 and wgrad_part (splits, D_out, D)
// f32 scratch. All contiguous. Returns a cudaError_t: the first failed
// launch's (or TMA descriptor's), or cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int dcvit_attend_project_bwd(const void* qkv, const void* o, const void* lse,
                                        const void* wp, const void* dxo, void* dqkv, void* dwp,
                                        void* bias_out, void* do_buf, void* di, void* bias_part,
                                        void* wgrad_part, int batch, int n, int heads,
                                        int head_dim, int d_out, int n_valid, float sm_scale,
                                        int splits, void* stream) {
  using namespace dcvit;
  if (head_dim != fw::kHd || n % kBRows != 0 || d_out % 64 != 0 || n_valid < 1 || n_valid > n ||
      batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || splits < 1 ||
      (long long)batch * n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = heads * fw::kHd, tiles = n / kBRows, stride = d_out + 3 * d;
  const float scale_log2 = sm_scale * fw::kLog2e;
  cudaError_t err;

  const int rows = batch * n;
  CUtensorMap qkv64, do64, dqkv64, dxo128, dxo64, wp64, o64;
  if ((err = tensor_map(&dxo128, dxo, rows, d_out, kGemmRows)) != cudaSuccess ||
      (err = tensor_map(&dxo64, dxo, rows, d_out, wg::kBox)) != cudaSuccess ||
      (err = tensor_map(&wp64, wp, d_out, d, wg::kBox)) != cudaSuccess ||
      (err = tensor_map(&o64, o, rows, d, wg::kBox)) != cudaSuccess ||
      (err = tensor_map3(&qkv64, qkv, batch, n, 3 * d, fw::kWgRows)) != cudaSuccess ||
      (err = tensor_map3(&do64, do_buf, batch, n, d, fw::kWgRows)) != cudaSuccess ||
      (err = tensor_map3(&dqkv64, dqkv, batch, n, 3 * d, fw::kWgRows)) != cudaSuccess)
    return (int)err;
  const struct {
    const void* fn;
    int smem;
  } attrs[] = {{(const void*)ap_bwd_pre_kernel, kPreSmem},
               {(const void*)ap_wgrad_kernel, kWgSmem}};
  for (const auto& a : attrs)
    if ((err = cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    a.smem)) != cudaSuccess)
      return (int)err;

  ap_bwd_pre_kernel<<<(rows + kGemmRows - 1) / kGemmRows, kGemmThreads, kPreSmem, st>>>(
      dxo128, wp64, static_cast<const bf16*>(o), static_cast<bf16*>(do_buf),
      static_cast<float*>(di), static_cast<float*>(bias_part), rows, n, heads, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const struct {
    const void* fn;
    int smem;
  } flash[] = {{(const void*)ap_bwd_kv_kernel, kKvSmem}, {(const void*)ap_bwd_q_kernel, kQSmem}};
  for (const auto& a : flash)
    if ((err = cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    a.smem)) != cudaSuccess)
      return (int)err;
  const dim3 grid(tiles, heads, batch);
  ap_bwd_kv_kernel<<<grid, kFlashThreads, kKvSmem, st>>>(
      qkv64, do64, dqkv64, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<bf16*>(dqkv), static_cast<float*>(bias_part), n, n_valid, scale_log2, sm_scale,
      d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ap_bwd_q_kernel<<<grid, kFlashThreads, kQSmem, st>>>(
      qkv64, do64, dqkv64, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<float*>(bias_part), n, n_valid, scale_log2, sm_scale, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dWp = dxo^T o over all B * N rows, then the fixed-order sums
  const int per = (rows + splits - 1) / splits;
  const int rows_per_split = (per + wg::kBox - 1) / wg::kBox * wg::kBox;
  const int wg_tiles = ((d_out + 127) / 128) * ((d + 127) / 128);
  ap_wgrad_kernel<<<dim3(wg_tiles, splits), kGemmThreads, kWgSmem, st>>>(
      dxo64, o64, static_cast<float*>(wgrad_part), rows, d_out, d, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = launch_reduce(static_cast<const float*>(wgrad_part), static_cast<float*>(dwp), splits,
                      (long long)d_out * d, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(static_cast<const float*>(bias_part), static_cast<float*>(bias_out),
                            batch * tiles, stride, st);
}
