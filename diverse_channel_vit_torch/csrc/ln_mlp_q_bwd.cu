// int8 ln_mlp backward: given do, the gradients of x, of fc1 and fc2 (weights
// and biases) and of the LayerNorm scale and bias, for the forward in
// ln_mlp_q.cu (`model.quantization = int8`).
//
// Replaces the TPU kernel `_ln_mlp_q_bwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:525), reached through
// `_ln_mlp_q_bwd_impl` (:596) and `_ln_mlp_vjp_bwd` (:337).
//
// Arithmetic, as the TPU kernel's (all f32 unless stated):
// - the int8 fc1 recompute, identical to the forward's: y = LayerNorm(x),
//   yq / ys its per-row codes and scale, h_pre = (float(yq W1q^T) * ys) * s1c
//   + b1, h = GELU_tanh(h_pre) rounded to bf16 (only dW2 reads it);
// - dW2 = do^T h and db2 = sum do, bf16 products with f32 accumulation;
// - dh = (float(doq W2r^T) * dos) * s2r: do quantised per row, W2r the
//   per-hidden-unit int8 copy of W2, stored (HID, D);
// - dh_pre = dh * GELU'(h_pre); db1 = sum of the f32 dh_pre;
//   dW1 = dh_pre^T y with both rounded to bf16;
// - dy = (float(dhq W1r^T) * dhs) * s1r: dh_pre quantised per row from its
//   f32 values, W1r the per-input-unit int8 copy of W1, stored (D, HID);
// - the LayerNorm backward: ds = sum dy * xhat, db = sum dy,
//   dx = rstd (dy scale - mean(dy scale) - xhat mean(dy scale xhat)) (+ do).
// The rounding steps are int8.cuh's exact helpers (tanhf, IEEE division),
// as in B7: the recompute's codes are the forward's, bit for bit.
//
// What bounds it on an H100. The products: 6 M D HID int8 operations and
// 4 M D HID bf16 FLOP of weight gradients, 0.42 ms at the dense peaks for
// B = 64, N = 1600 (1569 real rows), D = 384, HID = 1536. Beside them an
// epilogue on the FP32 pipes that the bound does not count: a GELU and its
// derivative with tanhf and a quantisation by IEEE division per hidden
// element (chip_smoke.py counts their instructions from the SASS and prints
// an estimate of their issue time), and the f32 dh_pre scratch below (1.26 GB of traffic
// a call, about 0.4 ms at 3.35 TB/s).
//
// Design (wgmma_core.cuh), and what differs from the TPU kernel. The TPU
// recomputed fc1 per row block and summed every weight and bias gradient in
// VMEM over one sequential sweep. Here, as in B4 (ln_mlp_bwd.cu), the
// backward is a row pass and three GEMMs, every partial summed in a fixed
// order (reduce.cuh) without atomics, so two calls agree bit for bit:
//   (a) `q_rows_kernel`, one warp a row (`ln_row`, `quant_row`, the
//       forward's instructions): y in bf16 (for dW1), yq and ys (the
//       forward's codes), doq and dos, the LayerNorm's mean and rstd;
//   (b) `q_dual_kernel`, per (128 rows, 128 hidden units): h_pre = yq W1q^T
//       and dh = doq W2r^T (K = 384, int8 `wgmma`, every operand K-major) in
//       two s32 accumulators; in the epilogue h and dh_pre from one tanhf,
//       h and dh_pre in bf16 (the weight gradients' operands) and dh_pre in
//       f32, each stored by TMA; db1's column partials of the f32 dh_pre;
//       and each row's max|dh_pre| over the tile;
//   (c) `q_dy_kernel`, per 64 rows: the row scale dhs from the twelve
//       maxima (max is order-free, so it is exact); each k-step the two
//       consumer warpgroups quantise an f32 dh_pre tile (32 rows each) into
//       a swizzled int8 A box, then dy += dhq W1r^T (K = HID, each
//       warpgroup 192 columns, 96 s32 registers); the epilogue runs B4's
//       LayerNorm backward on the dequantised dy: dx (+ do), and the column
//       partials of do (db2), dy * xhat (ds) and dy (db);
//   (d) B4's `wgrad_kernel` (ln_mlp_wgrad.cuh) on the same bf16 operands:
//       dW2 = do^T h and dW1 = dh_pre^T y in one launch, then the splits
//       summed in order.
// Why the f32 scratch: dh_pre's row scale needs the whole row (HID units)
// before any product of (c). Recomputing h_pre and dh in (c) instead would
// need 64 + 96 accumulator registers beside dy's 96, past the 168 a thread
// that ptxas allots the consumers (wgmma_core.cuh).
// On an H100 it runs at about 5x its bound; the dual GEMM (tanhf and three
// stores a value) and the dy GEMM (the f32 read, quantisation and the LN
// backward after its products) each at about 2.2x theirs (PERF.md).
// With `codes` set, (c) also writes dhq (M, HID), the codes of the dy GEMM,
// for counting code differences.
#include "int8.cuh"
#include "ln_mlp_wgrad.cuh"

namespace dcvit {

// (b): a stage per 128-byte k-step: yq and doq [128 rows][128 B], W1q and
// W2r [128 hidden][128 B]; all three k-steps of K = 384 load at once
constexpr int kQDualSteps = kLBD / 128;
constexpr int kQDualStageBytes = 4 * 2 * wg::kBoxBytes;
constexpr int kQDualSmem =
    kQDualSteps * kQDualStageBytes + 8 * kLBTile * 4 + kQDualSteps * 8 + wg::kAlign;
// (c): a ring of f32 dh_pre tiles [64 rows][128 hidden] (four [64][32]
// boxes) and one of W1r tiles [384 d][128 hidden] (two [192][128 B] boxes);
// the producer runs kQDyLead f32 tiles ahead of the W1r tiles; the
// quantised A boxes [64][128 B] are used in turn
constexpr int kQDyRows = 64;
constexpr int kQDyFStages = 3;
constexpr int kQDyFBytes = 4 * wg::kBoxBytes;
constexpr int kQDyWStages = 2;
constexpr int kQDyWBytes = 6 * wg::kBoxBytes;
constexpr int kQDyQBufs = 3;
constexpr int kQDyLead = 2;
constexpr int kQDySmem = kQDyFStages * kQDyFBytes + kQDyWStages * kQDyWBytes +
                         kQDyQBufs * wg::kBoxBytes + 4 * (2 * kQDyRows * 2 + kQDyRows) +
                         2 * (kQDyFStages + kQDyWStages) * 8 + wg::kAlign;

// ---- (a) LayerNorm and row quantisation -------------------------------------------------

__global__ void __launch_bounds__(256)
    q_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ dout,
                  __nv_bfloat16* __restrict__ y_buf, int8_t* __restrict__ yq,
                  int8_t* __restrict__ doq, float* __restrict__ stats, long long m) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= m) return;
  float2 v[kLBD / 64];
  float mean, rstd;
  ln_row<kLBD>(x + r * kLBD, ln_scale, ln_bias, lane, v, mean, rstd);
  uint32_t* yrow = reinterpret_cast<uint32_t*>(y_buf + r * kLBD);
#pragma unroll
  for (int i = 0; i < kLBD / 64; ++i) yrow[lane + 32 * i] = pack_bf16(v[i].x, v[i].y);
  const float ys = quant_row(v, yq + r * kLBD, lane);
  const uint32_t* drow = reinterpret_cast<const uint32_t*>(dout + r * kLBD);
#pragma unroll
  for (int i = 0; i < kLBD / 64; ++i) v[i] = unpack_bf16(drow[lane + 32 * i]);
  const float dos = quant_row(v, doq + r * kLBD, lane);
  if (lane == 0) *reinterpret_cast<float4*>(stats + 4 * r) = make_float4(ys, dos, mean, rstd);
}

// ---- (b) h and dh_pre ---------------------------------------------------------------------

__global__ void __launch_bounds__(wg::kThreads, 1)
    q_dual_kernel(const __grid_constant__ CUtensorMap yq_map,
                  const __grid_constant__ CUtensorMap doq_map,
                  const __grid_constant__ CUtensorMap w1q_map,
                  const __grid_constant__ CUtensorMap w2r_map,
                  const __grid_constant__ CUtensorMap h_map,
                  const __grid_constant__ CUtensorMap dhp_map,
                  const __grid_constant__ CUtensorMap dhpf_map, const float* __restrict__ stats,
                  const float* __restrict__ s1c, const __nv_bfloat16* __restrict__ b1,
                  const float* __restrict__ s2r, float* __restrict__ db1_part,
                  float* __restrict__ rmax_part, long long m, int hid) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  float* sCol = reinterpret_cast<float*>(ring + kQDualSteps * kQDualStageBytes);  // [8 warps][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(sCol + 8 * kLBTile);
  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const int h0 = blockIdx.x * kLBTile;
  const long long m0 = (long long)blockIdx.y * kLBTile;
  constexpr int kPart = 2 * wg::kBoxBytes;  // one 16 KB operand of a stage
  if (tid == 0) {
    for (int s = 0; s < kQDualSteps; ++s) wg::bar_init(&full[s], 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (wgi == wg::kConsumers) {
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int ks = 0; ks < kQDualSteps; ++ks) {
        wg::bar_expect_tx(&full[ks], kQDualStageBytes);
        uint8_t* st = ring + ks * kQDualStageBytes;
        wg::tma_load(st, &yq_map, &full[ks], 128 * ks, (int)m0);
        wg::tma_load(st + kPart, &doq_map, &full[ks], 128 * ks, (int)m0);
        wg::tma_load(st + 2 * kPart, &w1q_map, &full[ks], 128 * ks, h0);
        wg::tma_load(st + 3 * kPart, &w2r_map, &full[ks], 128 * ks, h0);
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    int ha[64], da[64];  // h_pre and dh sums: 64 rows x 128 hidden
    const uint32_t ring_s = smem_addr(ring);
#pragma unroll
    for (int ks = 0; ks < kQDualSteps; ++ks) {
      wg::bar_wait(&full[ks], 0);
      const uint32_t st = wg::opaque(ring_s) + ks * kQDualStageBytes;
      wg::mma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        wg::mma_s8_m64n128(ha, wg::desc_k(st + wgi * wg::kBoxBytes, k4),
                           wg::desc_k(st + 2 * kPart, k4), ks + k4 > 0);
        wg::mma_s8_m64n128(da, wg::desc_k(st + kPart + wgi * wg::kBoxBytes, k4),
                           wg::desc_k(st + 3 * kPart, k4), ks + k4 > 0);
      }
      wg::mma_commit();
    }
    wg::mma_wait<0>();
    wg::acc_fence(ha);
    wg::acc_fence(da);
    wg::sync_named(3, 256);  // both warpgroups' products are done: every stage is free

    // epilogue, staged in stage wgi: h and dh_pre in bf16 (two [64][64]
    // boxes each), dh_pre in f32 (four [64][32] boxes)
    uint8_t* stH = ring + wgi * kQDualStageBytes;
    uint8_t* stD = stH + kPart;
    uint8_t* stF = stD + kPart;
    const int warp = t >> 5, lane = t & 31;
    const long long ra = m0 + 64 * wgi + wg::acc_row(t, 0), rb = ra + 8;  // this thread's rows
    const bool va = ra < m, vb = rb < m;
    // ys and dos of each row (rows past the end: their codes load as zeros)
    const float4 sa = va ? *reinterpret_cast<const float4*>(stats + 4 * ra)
                         : make_float4(1.f, 1.f, 0.f, 0.f);
    const float4 sb = vb ? *reinterpret_cast<const float4*>(stats + 4 * rb)
                         : make_float4(1.f, 1.f, 0.f, 0.f);
    float cs[32];  // db1: this thread's two rows, per column it holds
    float rmax_a = 0.f, rmax_b = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int col = wg::acc_col(t, i), row = wg::acc_row(t, i), hc = h0 + col;
      const bool lower = (i >> 1) & 1;
      const float ys = lower ? sb.x : sa.x, dos = lower ? sb.y : sa.y;
      const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + hc));
      float g0, g1, dg0, dg1;
      gelu_dgelu_tanh_rn(__fadd_rn(dequant(ha[i], ys, s1c[hc]), bb.x), g0, dg0);
      gelu_dgelu_tanh_rn(__fadd_rn(dequant(ha[i + 1], ys, s1c[hc + 1]), bb.y), g1, dg1);
      const float dp0 = __fmul_rn(dequant(da[i], dos, s2r[hc]), dg0);
      const float dp1 = __fmul_rn(dequant(da[i + 1], dos, s2r[hc + 1]), dg1);
      uint8_t* box = stH + (col >> 6) * wg::kBoxBytes;
      wg::st_pair(box, row, col & 63, g0, g1);
      wg::st_pair(box + kPart, row, col & 63, dp0, dp1);
      *reinterpret_cast<float2*>(stF + (col >> 5) * wg::kBoxBytes + wg::swz_b(row, 4 * (col & 31))) =
          make_float2(dp0, dp1);
      const float a = fmaxf(fabsf(dp0), fabsf(dp1));
      const int j = ((i >> 2) << 1);
      if (lower) {
        rmax_b = fmaxf(rmax_b, a);
        cs[j] += dp0;
        cs[j + 1] += dp1;
      } else {
        rmax_a = fmaxf(rmax_a, a);
        cs[j] = dp0;
        cs[j + 1] = dp1;
      }
    }
    wg::fence_async_smem();
    wg::sync_named(1 + wgi, 128);
    if (t == 0) {
      const int r0 = (int)m0 + 64 * wgi;
      for (int b = 0; b < 2; ++b) {
        wg::tma_store(&h_map, stH + b * wg::kBoxBytes, h0 + b * wg::kBox, r0);
        wg::tma_store(&dhp_map, stD + b * wg::kBoxBytes, h0 + b * wg::kBox, r0);
      }
      for (int b = 0; b < 4; ++b) wg::tma_store(&dhpf_map, stF + b * wg::kBoxBytes, h0 + 32 * b, r0);
      wg::tma_store_commit();
    }
    // each row's max|dh_pre| over this tile's 128 units, for (c)'s row scales
    rmax_a = quad_max(rmax_a);
    rmax_b = quad_max(rmax_b);
    if ((t & 3) == 0) {
      if (va) rmax_part[blockIdx.x * m + ra] = rmax_a;
      if (vb) rmax_part[blockIdx.x * m + rb] = rmax_b;
    }
    // db1 partial: sum over the lanes that share columns, then over the
    // eight warps in order (rows past the end hold dh = 0, so dh_pre = 0)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float v = sum_over_rows(cs[j]);
      if (lane < 4) sCol[(4 * wgi + warp) * kLBTile + 8 * (j >> 1) + 2 * lane + (j & 1)] = v;
    }
    wg::sync_named(3, 256);
    if (tid < kLBTile) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) tot += sCol[w * kLBTile + tid];
      db1_part[(long long)blockIdx.y * hid + h0 + tid] = tot;
    }
    if (t == 0) wg::tma_store_wait();
  }
}

// ---- (c) dy and the LayerNorm backward ----------------------------------------------------

__global__ void __launch_bounds__(wg::kThreads, 1)
    q_dy_kernel(const __grid_constant__ CUtensorMap dhpf_map,
                const __grid_constant__ CUtensorMap w1r_map,
                const __grid_constant__ CUtensorMap dx_map, const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ dout, const float* __restrict__ ln_scale,
                const float* __restrict__ s1r, const float* __restrict__ stats,
                const float* __restrict__ rmax_part, float* __restrict__ ln_part,
                int8_t* __restrict__ codes, long long m, int hid, int residual) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ringF = wg::align(smem_raw);
  uint8_t* ringW = ringF + kQDyFStages * kQDyFBytes;
  uint8_t* sQ = ringW + kQDyWStages * kQDyWBytes;
  float* sRow = reinterpret_cast<float*>(sQ + kQDyQBufs * wg::kBoxBytes);  // [2][64][2]
  float* sDhs = sRow + 2 * kQDyRows * 2;                                   // dh_pre's row scales
  uint64_t* fullF = reinterpret_cast<uint64_t*>(sDhs + kQDyRows);
  uint64_t* emptyF = fullF + kQDyFStages;
  uint64_t* fullW = emptyF + kQDyFStages;
  uint64_t* emptyW = fullW + kQDyWStages;
  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const long long m0 = (long long)blockIdx.x * kQDyRows;
  const int n_steps = hid / 128;
  constexpr int kHalf = kLBD / 2;  // dy columns per warpgroup
  if (tid == 0) {
    for (int s = 0; s < kQDyFStages; ++s) {
      wg::bar_init(&fullF[s], 1);
      wg::bar_init(&emptyF[s], 1);  // after both warpgroups quantised the tile
    }
    for (int s = 0; s < kQDyWStages; ++s) {
      wg::bar_init(&fullW[s], 1);
      wg::bar_init(&emptyW[s], wg::kConsumers);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (wgi == wg::kConsumers) {
    // producer: f32 dh_pre rows [m0, + 64) x hidden [128 i, + 128), and
    // kQDyLead steps behind it W1r rows [0, 384) x the same hidden units
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int i = 0; i < n_steps + kQDyLead; ++i) {
        if (i < n_steps) {
          const int s = i % kQDyFStages;
          wg::bar_wait(&emptyF[s], ((i / kQDyFStages) & 1) ^ 1);
          wg::bar_expect_tx(&fullF[s], kQDyFBytes);
          for (int b = 0; b < 4; ++b)
            wg::tma_load(ringF + s * kQDyFBytes + b * wg::kBoxBytes, &dhpf_map, &fullF[s],
                         128 * i + 32 * b, (int)m0);
        }
        const int j = i - kQDyLead;
        if (j >= 0) {
          const int s = j % kQDyWStages;
          wg::bar_wait(&emptyW[s], ((j / kQDyWStages) & 1) ^ 1);
          wg::bar_expect_tx(&fullW[s], kQDyWBytes);
          for (int b = 0; b < 2; ++b)
            wg::tma_load(ringW + s * kQDyWBytes + 3 * b * wg::kBoxBytes, &w1r_map, &fullW[s],
                         128 * j, kHalf * b);
        }
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    // dh_pre's row scales from (b)'s per-tile maxima
    if (tid < kQDyRows) {
      float mx = 0.f;
      if (m0 + tid < m)
        for (int j = 0; j < n_steps; ++j) mx = fmaxf(mx, rmax_part[j * m + m0 + tid]);
      sDhs[tid] = row_scale(mx);
    }
    wg::sync_named(3, 256);

    // this thread quantises row qr of each f32 tile, 16-unit chunks (t % 4)
    // and (t % 4) + 4
    const int qr = 32 * wgi + (t >> 2);
    const float qs = sDhs[qr];
    const bool qvalid = m0 + qr < m;
    int acc[96];  // dy: 64 rows x columns [192 wgi, 192 wgi + 192)
    const uint32_t q_s = smem_addr(sQ), w_s = smem_addr(ringW);
    for (int ks = 0; ks < n_steps; ++ks) {
      const int sf = ks % kQDyFStages, sw = ks % kQDyWStages;
      uint8_t* box = sQ + (ks % kQDyQBufs) * wg::kBoxBytes;
      wg::bar_wait(&fullF[sf], (ks / kQDyFStages) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (t & 3) + 4 * h;  // units [16 q, 16 q + 16): f32 box q / 2
        const uint8_t* fbox = ringF + sf * kQDyFBytes + (q >> 1) * wg::kBoxBytes;
        uint32_t packed[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v =
              *reinterpret_cast<const float4*>(fbox + wg::swz_b(qr, 16 * (4 * (q & 1) + u)));
          packed[u] = (uint32_t)(uint8_t)quant_s8(v.x, qs) |
                      (uint32_t)(uint8_t)quant_s8(v.y, qs) << 8 |
                      (uint32_t)(uint8_t)quant_s8(v.z, qs) << 16 |
                      (uint32_t)(uint8_t)quant_s8(v.w, qs) << 24;
        }
        const uint4 codes16 = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        *reinterpret_cast<uint4*>(box + wg::swz_b(qr, 16 * q)) = codes16;
        if (codes != nullptr && qvalid)
          *reinterpret_cast<uint4*>(codes + (m0 + qr) * hid + 128 * ks + 16 * q) = codes16;
      }
      wg::fence_async_smem();
      wg::sync_named(3, 256);  // the dhq box is whole, the f32 tile read
      if (tid == 0) wg::bar_arrive(&emptyF[sf]);
      wg::bar_wait(&fullW[sw], (ks / kQDyWStages) & 1);
      const uint32_t qa = wg::opaque(q_s) + (ks % kQDyQBufs) * wg::kBoxBytes;
      const uint32_t wa = wg::opaque(w_s) + sw * kQDyWBytes + 3 * wgi * wg::kBoxBytes;
      wg::mma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wg::mma_s8_m64n192(acc, wg::desc_k(qa, k4), wg::desc_k(wa, k4), ks + k4 > 0);
      wg::mma_commit();
      wg::mma_wait<1>();
      if (ks > 0 && t == 0) wg::bar_arrive(&emptyW[(ks - 1) % kQDyWStages]);
    }
    wg::mma_wait<0>();
    wg::acc_fence(acc);
    wg::sync_named(3, 256);  // both warpgroups are past the rings: they are free

    const int warp = t >> 5, lane = t & 31;
    const int ra = wg::acc_row(t, 0), rb = ra + 8;
    const bool va = m0 + ra < m, vb = m0 + rb < m;
    const float mean_a = va ? stats[4 * (m0 + ra) + 2] : 0.f;
    const float rstd_a = va ? stats[4 * (m0 + ra) + 3] : 0.f;
    const float mean_b = vb ? stats[4 * (m0 + rb) + 2] : 0.f;
    const float rstd_b = vb ? stats[4 * (m0 + rb) + 3] : 0.f;
    const float dhs_a = sDhs[ra], dhs_b = sDhs[rb];
    float dy[96];
#pragma unroll
    for (int i = 0; i < 96; ++i)
      dy[i] = dequant(acc[i], (i >> 1) & 1 ? dhs_b : dhs_a, s1r[kHalf * wgi + wg::acc_col(t, i)]);
    auto pair = [&](const __nv_bfloat16* p, bool valid, int row, int col) {
      return valid ? unpack_bf16(*reinterpret_cast<const uint32_t*>(p + (m0 + row) * kLBD + col))
                   : make_float2(0.f, 0.f);
    };
    // column sums [4 warps][db2, ds, db][192] of this warpgroup, in the f32 ring
    float* sCol = reinterpret_cast<float*>(ringF) + wgi * 4 * 3 * kHalf;

    // pass 1: row sums of dxhat and dxhat * xhat; column sums of do, dy * xhat, dy
    float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
    for (int i = 0; i < 96; i += 4) {
      const int col = kHalf * wgi + wg::acc_col(t, i);
      const float sc0 = ln_scale[col], sc1 = ln_scale[col + 1];
      const float2 xa = pair(x, va, ra, col), xb = pair(x, vb, rb, col);
      const float2 oa = pair(dout, va, ra, col), ob = pair(dout, vb, rb, col);
      const float xa0 = (xa.x - mean_a) * rstd_a, xa1 = (xa.y - mean_a) * rstd_a;
      const float xb0 = (xb.x - mean_b) * rstd_b, xb1 = (xb.y - mean_b) * rstd_b;
      const float da0 = dy[i] * sc0, da1 = dy[i + 1] * sc1;
      const float db0 = dy[i + 2] * sc0, db1 = dy[i + 3] * sc1;
      s1a += da0 + da1;
      s2a += da0 * xa0 + da1 * xa1;
      s1b += db0 + db1;
      s2b += db0 * xb0 + db1 * xb1;
      const float c[6] = {oa.x + ob.x, oa.y + ob.y,
                          dy[i] * xa0 + dy[i + 2] * xb0, dy[i + 1] * xa1 + dy[i + 3] * xb1,
                          dy[i] + dy[i + 2], dy[i + 1] + dy[i + 3]};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float v = sum_over_rows(c[q]);
        if (lane < 4) sCol[(warp * 3 + (q >> 1)) * kHalf + (col - kHalf * wgi) + (q & 1)] = v;
      }
    }
    s1a = sum_over_quad(s1a);
    s2a = sum_over_quad(s2a);
    s1b = sum_over_quad(s1b);
    s2b = sum_over_quad(s2b);
    if ((lane & 3) == 0) {
      float* mine = sRow + wgi * kQDyRows * 2;
      mine[2 * ra] = s1a;
      mine[2 * ra + 1] = s2a;
      mine[2 * rb] = s1b;
      mine[2 * rb + 1] = s2b;
    }
    wg::sync_named(3, 256);
    const float m1a = (sRow[2 * ra] + sRow[2 * (kQDyRows + ra)]) / kLBD;
    const float m2a = (sRow[2 * ra + 1] + sRow[2 * (kQDyRows + ra) + 1]) / kLBD;
    const float m1b = (sRow[2 * rb] + sRow[2 * (kQDyRows + rb)]) / kLBD;
    const float m2b = (sRow[2 * rb + 1] + sRow[2 * (kQDyRows + rb) + 1]) / kLBD;

    // pass 2: dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) (+ do),
    // into three swizzled boxes of the W1r ring
    uint8_t* stX = ringW + wgi * 3 * wg::kBoxBytes;
#pragma unroll
    for (int i = 0; i < 96; i += 4) {
      const int lc = wg::acc_col(t, i), col = kHalf * wgi + lc;
      const float sc0 = ln_scale[col], sc1 = ln_scale[col + 1];
      const float2 xa = pair(x, va, ra, col), xb = pair(x, vb, rb, col);
      float a0 = rstd_a * (dy[i] * sc0 - m1a - (xa.x - mean_a) * rstd_a * m2a);
      float a1 = rstd_a * (dy[i + 1] * sc1 - m1a - (xa.y - mean_a) * rstd_a * m2a);
      float b0 = rstd_b * (dy[i + 2] * sc0 - m1b - (xb.x - mean_b) * rstd_b * m2b);
      float b1 = rstd_b * (dy[i + 3] * sc1 - m1b - (xb.y - mean_b) * rstd_b * m2b);
      if (residual) {
        const float2 oa = pair(dout, va, ra, col), ob = pair(dout, vb, rb, col);
        a0 += oa.x;
        a1 += oa.y;
        b0 += ob.x;
        b1 += ob.y;
      }
      uint8_t* box = stX + (lc >> 6) * wg::kBoxBytes;
      wg::st_pair(box, ra, lc & 63, a0, a1);
      wg::st_pair(box, rb, lc & 63, b0, b1);
    }
    wg::fence_async_smem();
    wg::sync_named(1 + wgi, 128);
    if (t == 0) {
      for (int b = 0; b < 3; ++b)
        wg::tma_store(&dx_map, stX + b * wg::kBoxBytes, kHalf * wgi + b * wg::kBox, (int)m0);
      wg::tma_store_commit();
    }
    // per-block partials [db2 | ds | db], the four warps summed in order
    float* part = ln_part + (long long)blockIdx.x * 3 * kLBD;
    for (int c = t; c < kHalf; c += 128) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) tot += sCol[(w * 3 + q) * kHalf + c];
        part[q * kLBD + kHalf * wgi + c] = tot;
      }
    }
    if (t == 0) wg::tma_store_wait();
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: x, do and dx (M, D) bf16;
// ln_scale, ln_bias (D,) f32; w1q (HID, D) int8 with s1c (HID,) f32; b1
// (HID,) bf16; w1r (D, HID) int8 with s1r (D,) f32; w2r (HID, D) int8 with
// s2r (HID,) f32 (HID a multiple of 384); dw (D * HID + HID * D) f32 =
// [dW2 (D, HID) | dW1 (HID, D)]; bias_out (HID + 3D) f32 = [db1 | db2 | ds |
// db]; scratch: y_buf (M, D) bf16, yq_buf and doq_buf (M, D) int8, stats
// (M, 4) f32, h_buf and dhp_buf (M, HID) bf16, dhpf_buf (M, HID) f32,
// db1_part (ceil(M / 128), HID) f32, rmax_part (HID / 128, M) f32, ln_part
// (ceil(M / 64), 3D) f32, wgrad_part (splits, 2, D, HID) f32; codes (M, HID)
// int8 or null. All contiguous. Returns a cudaError_t: the first failed
// launch's (or TMA descriptor's), or cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int dcvit_ln_mlp_q_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1q, const void* s1c, const void* b1,
                                  const void* w1r, const void* s1r, const void* w2r,
                                  const void* s2r, const void* dout, void* dx, void* dw,
                                  void* bias_out, void* y_buf, void* yq_buf, void* doq_buf,
                                  void* stats, void* h_buf, void* dhp_buf, void* dhpf_buf,
                                  void* db1_part, void* rmax_part, void* ln_part,
                                  void* wgrad_part, void* codes, long long m, int d, int hid,
                                  int residual, int splits, void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  if (d != kLBD || hid % kWgN != 0 || hid % kLBTile != 0 || m < 1 || splits < 1 ||
      (m + kLBTile - 1) / kLBTile > 65535 || m > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles128 = (m + kLBTile - 1) / kLBTile;
  const long long tiles64 = (m + kQDyRows - 1) / kQDyRows;
  cudaError_t err;

  q_rows_kernel<<<(unsigned)((m + 7) / 8), 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(dout),
      static_cast<bf16*>(y_buf), static_cast<int8_t*>(yq_buf), static_cast<int8_t*>(doq_buf),
      static_cast<float*>(stats), m);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const CUtensorMapDataType s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            b16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap yq128, doq128, w1q128, w2r128, h64, dhp64, dhpf64, w1r192, dx64, do64, y64;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    long long rows;
    int cols, box_rows;
    CUtensorMapDataType type;
  } maps[] = {
      {&yq128, yq_buf, m, kLBD, kLBTile, s8},   {&doq128, doq_buf, m, kLBD, kLBTile, s8},
      {&w1q128, w1q, hid, kLBD, kLBTile, s8},   {&w2r128, w2r, hid, kLBD, kLBTile, s8},
      {&h64, h_buf, m, hid, wg::kBox, b16},     {&dhp64, dhp_buf, m, hid, wg::kBox, b16},
      {&dhpf64, dhpf_buf, m, hid, wg::kBox, f32}, {&w1r192, w1r, kLBD, hid, kLBD / 2, s8},
      {&dx64, dx, m, kLBD, wg::kBox, b16},      {&do64, dout, m, kLBD, wg::kBox, b16},
      {&y64, y_buf, m, kLBD, wg::kBox, b16},
  };
  for (const auto& mp : maps)
    if ((err = tensor_map(mp.map, mp.ptr, mp.rows, mp.cols, mp.box_rows, mp.type)) !=
        cudaSuccess)
      return (int)err;
  const struct {
    const void* fn;
    int smem;
  } attrs[] = {{(const void*)q_dual_kernel, kQDualSmem}, {(const void*)q_dy_kernel, kQDySmem}};
  for (const auto& a : attrs)
    if ((err = cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    a.smem)) != cudaSuccess)
      return (int)err;

  q_dual_kernel<<<dim3(hid / kLBTile, (unsigned)tiles128), wg::kThreads, kQDualSmem, st>>>(
      yq128, doq128, w1q128, w2r128, h64, dhp64, dhpf64, static_cast<const float*>(stats),
      static_cast<const float*>(s1c), static_cast<const bf16*>(b1),
      static_cast<const float*>(s2r), static_cast<float*>(db1_part),
      static_cast<float*>(rmax_part), m, hid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  q_dy_kernel<<<(unsigned)tiles64, wg::kThreads, kQDySmem, st>>>(
      dhpf64, w1r192, dx64, static_cast<const bf16*>(x), static_cast<const bf16*>(dout),
      static_cast<const float*>(ln_scale), static_cast<const float*>(s1r),
      static_cast<const float*>(stats), static_cast<const float*>(rmax_part),
      static_cast<float*>(ln_part), static_cast<int8_t*>(codes), m, hid, residual);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = launch_ln_mlp_wgrad(do64, h64, dhp64, y64, static_cast<float*>(wgrad_part),
                                 static_cast<float*>(dw), m, hid, splits, st)) != cudaSuccess)
    return (int)err;
  float* bias = static_cast<float*>(bias_out);
  // the bias partials: few columns, hundreds of blocks' rows
  if ((err = launch_reduce<32>(static_cast<const float*>(db1_part), bias, (int)tiles128, hid,
                               st)) != cudaSuccess)
    return (int)err;
  return (int)launch_reduce<32>(static_cast<const float*>(ln_part), bias + hid, (int)tiles64,
                                3 * kLBD, st);
}
