// ln_mlp backward: given do, the gradients of x, of fc1 and fc2 (weights and
// biases) and of the LayerNorm scale and bias, for the forward in ln_mlp.cu.
//
// Replaces the TPU kernel `_ln_mlp_bwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:167), reached through
// `_ln_mlp_bwd_impl` (:259) and `_ln_mlp_vjp_bwd` (:337).
//
// What bounds it on an H100: operations. Per image and layer at the
// DiChaViT-S flagship (1569 real rows, D = 384, hidden 1536) it needs
// 10 * rows * D * hidden = 9.3 GFLOP of bf16 products against about 4 MB of
// compulsory traffic (x, do and dx, the weights and their f32 gradients).
// This design adds the scratch y, h and dh_pre (B * N * (384 + 2 * 1536) bf16,
// 0.70 GB at B = 64 and N = 1600), written once and read by the later GEMMs:
// about 0.5 ms of traffic at 3.35 TB/s, spread over GEMMs that run at the
// tensor cores' rate, so the products stay the bound.
//
// Design (wgmma_core.cuh), and what differs from the TPU kernel:
// - The TPU recomputed LN / fc1 / GELU per row block and summed all six
//   weight and bias gradients in f32 VMEM scratch over one sequential sweep
//   of the grid. On Hopper a block's f32 partial of dW1 + dW2 is 4.7 MB, far
//   beyond its shared memory, and blocks run in no order. So the backward is
//   four GEMMs, each on the wgmma + TMA core at full tile sizes with its
//   element-wise work fused into its epilogue, all on the caller's stream:
//   (a) `ln_rows_kernel`: LayerNorm in f32 (two-pass, eps 1e-6) -> y (bf16)
//       and each row's mean and rstd (f32);
//   (b) `dual_kernel`, per (128 rows, 128 hidden): h_pre = y W1^T and
//       dh = do W2 (K = 384) in two accumulators, then h = GELU_tanh(h_pre +
//       b1) and dh_pre = dh * GELU'(h_pre + b1) from one tanh (the SFU's,
//       wgmma_core.cuh), both rounded to bf16 (the TPU's cast points) and
//       stored by TMA, and db1's per-block column sums of the f32 dh_pre. (A
//       persistent version that streamed the next tile's stages during this
//       tile's epilogue, storing from registers, was slower on an H100);
//   (c) `dy_kernel`, per 64 rows: dy = dh_pre W1 (K = 1536), the two
//       consumer warpgroups splitting the 384 columns (96 accumulator
//       registers each) and exchanging their row sums through shared memory
//       for the LayerNorm backward in the epilogue. (128-row blocks of four
//       consumer warpgroups read half as much of W1 per row, but leave no
//       room for a producer warp at 128 registers a thread, and with inline
//       refills were slower on an H100): dx (+ do with the fused
//       residual) and the per-block column sums of do (db2), dy * xhat (ds)
//       and dy (db);
//   (d) `wgrad_kernel` (ln_mlp_wgrad.cuh, shared with the int8 backward):
//       dW2 = do^T h and dW1 = dh_pre^T y as split-row GEMMs in one launch,
//       on 128 x 192 output tiles, both operands MN-major (wgmma's
//       transposed layout, straight from the row-major scratch);
//   (e) every partial summed in a fixed order (reduce.cuh). No atomics: two
//       calls on the same inputs agree bit for bit.
#include "ln_mlp_wgrad.cuh"

namespace dcvit {

// (b): per stage y, do (K-major [128 rows][64]), W1 (K-major [128 hidden][64]),
// W2 (MN-major, two [64 d][64 hidden] boxes)
constexpr int kDualStages = 3;
constexpr int kDualStageBytes = 4 * 2 * wg::kBoxBytes;
constexpr int kDualSmem = kDualStages * kDualStageBytes + 8 * kLBTile * 4 +
                          2 * kDualStages * 8 + wg::kAlign;
// (c): per stage dh_pre (K-major [64 rows][64]) and W1 (MN-major, six
// [64 hidden][64 d] boxes)
constexpr int kLBDyRows = 64;  // rows per dy block
constexpr int kDyStages = 4;
constexpr int kDyStageBytes = 7 * wg::kBoxBytes;
constexpr int kDySmem = kDyStages * kDyStageBytes + 2 * kLBDyRows * 2 * 4 + 2 * kDyStages * 8 +
                        wg::kAlign;

// ---- (a) LayerNorm rows --------------------------------------------------------------

__global__ void __launch_bounds__(256)
    ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ stats, long long m) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= m) return;
  const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x + r * kLBD);
  uint32_t* yrow = reinterpret_cast<uint32_t*>(y + r * kLBD);
  float2 v[kLBD / 64];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kLBD / 64; ++i) {
    v[i] = unpack_bf16(xrow[lane + 32 * i]);
    sum += v[i].x + v[i].y;
  }
  const float mean = warp_sum(sum) / kLBD;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kLBD / 64; ++i) {
    const float a = v[i].x - mean, c = v[i].y - mean;
    sq += a * a + c * c;
  }
  const float rstd = rsqrtf(warp_sum(sq) / kLBD + 1e-6f);
#pragma unroll
  for (int i = 0; i < kLBD / 64; ++i) {
    const int col = 2 * (lane + 32 * i);
    yrow[lane + 32 * i] = pack_bf16((v[i].x - mean) * rstd * ln_scale[col] + ln_bias[col],
                                    (v[i].y - mean) * rstd * ln_scale[col + 1] + ln_bias[col + 1]);
  }
  if (lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = rstd;
  }
}

// ---- (b) h and dh_pre ---------------------------------------------------------------

__global__ void __launch_bounds__(wg::kThreads, 1)
    dual_kernel(const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap w2_map,
                const __grid_constant__ CUtensorMap h_map,
                const __grid_constant__ CUtensorMap dhp_map,
                const __nv_bfloat16* __restrict__ b1, float* __restrict__ db1_part, int hid) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  float* sCol = reinterpret_cast<float*>(ring + kDualStages * kDualStageBytes);  // [8 warps][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(sCol + 8 * kLBTile);
  uint64_t* empty = full + kDualStages;
  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const int h0 = blockIdx.x * kLBTile;
  const int m0 = blockIdx.y * kLBTile;
  constexpr int kSteps = kLBD / wg::kBox;
  constexpr int kPart = 2 * wg::kBoxBytes;  // one 16 KB operand of a stage
  init_ring(full, empty, kDualStages);

  if (wgi == wg::kConsumers) {
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int ks = 0; ks < kSteps; ++ks) {
        const int s = ks % kDualStages;
        wg::bar_wait(&empty[s], ((ks / kDualStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kDualStageBytes);
        uint8_t* st = ring + s * kDualStageBytes;
        wg::tma_load(st, &y_map, &full[s], ks * wg::kBox, m0);
        wg::tma_load(st + kPart, &do_map, &full[s], ks * wg::kBox, m0);
        wg::tma_load(st + 2 * kPart, &w1_map, &full[s], ks * wg::kBox, h0);
        wg::tma_load(st + 3 * kPart, &w2_map, &full[s], h0, ks * wg::kBox);
        wg::tma_load(st + 3 * kPart + wg::kBoxBytes, &w2_map, &full[s], h0 + wg::kBox,
                     ks * wg::kBox);
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    float ha[64], da[64];  // h_pre and dh: 64 rows x 128 hidden
    const uint32_t ring_s = smem_addr(ring);
    for (int ks = 0; ks < kSteps; ++ks) {
      const int s = ks % kDualStages;
      wg::bar_wait(&full[s], (ks / kDualStages) & 1);
      const uint32_t st = wg::opaque(ring_s) + s * kDualStageBytes;
      wg::mma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        wg::mma_m64n128<0, 0>(ha, wg::desc_k(st + wgi * wg::kBoxBytes, k4),
                              wg::desc_k(st + 2 * kPart, k4), ks + k4 > 0);
        wg::mma_m64n128<0, 1>(da, wg::desc_k(st + kPart + wgi * wg::kBoxBytes, k4),
                              wg::desc_mn(st + 3 * kPart, k4, wg::kBoxBytes), ks + k4 > 0);
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      if (t == 0) wg::bar_arrive(&empty[s]);
    }
    wg::acc_fence(ha);
    wg::acc_fence(da);
    wg::sync_named(3, 256);  // both warpgroups are past the ring: stage 0 is free

    // epilogue: h and dh_pre into two swizzled [64][128] tiles of stage 0
    uint8_t* stH = ring + wgi * 2 * kPart;
    uint8_t* stD = stH + kPart;
    const int warp = t >> 5, lane = t & 31;
    float cs[32];  // db1: this thread's two rows, per column it holds
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int col = wg::acc_col(t, i), row = wg::acc_row(t, i);
      const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + h0 + col));
      float hv0, g0, hv1, g1;
      wg::gelu_and_grad(ha[i] + bb.x, hv0, g0);
      wg::gelu_and_grad(ha[i + 1] + bb.y, hv1, g1);
      const float dp0 = da[i] * g0, dp1 = da[i + 1] * g1;
      uint8_t* box = (col >> 6) ? wg::kBoxBytes + stH : stH;
      wg::st_pair(box, row, col & 63, hv0, hv1);
      wg::st_pair(box + kPart, row, col & 63, dp0, dp1);
      const int j = ((i >> 2) << 1);
      if ((i >> 1) & 1) {
        cs[j] += dp0;
        cs[j + 1] += dp1;
      } else {
        cs[j] = dp0;
        cs[j + 1] = dp1;
      }
    }
    wg::fence_async_smem();
    wg::sync_named(1 + wgi, 128);
    if (t == 0) {
      for (int b = 0; b < 2; ++b) {
        wg::tma_store(&h_map, stH + b * wg::kBoxBytes, h0 + b * wg::kBox, m0 + 64 * wgi);
        wg::tma_store(&dhp_map, stD + b * wg::kBoxBytes, h0 + b * wg::kBox, m0 + 64 * wgi);
      }
      wg::tma_store_commit();
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

// ---- (c) dy and the LayerNorm backward ----------------------------------------------

__global__ void __launch_bounds__(wg::kThreads, 1)
    dy_kernel(const __grid_constant__ CUtensorMap dhp_map, const __grid_constant__ CUtensorMap w1_map,
              const __grid_constant__ CUtensorMap dx_map, const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ dout, const float* __restrict__ ln_scale,
              const float* __restrict__ stats, float* __restrict__ ln_part, long long m, int hid,
              int residual) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  float* sRow = reinterpret_cast<float*>(ring + kDyStages * kDyStageBytes);  // [2][64][2]
  uint64_t* full = reinterpret_cast<uint64_t*>(sRow + 2 * kLBDyRows * 2);
  uint64_t* empty = full + kDyStages;
  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const long long m0 = (long long)blockIdx.x * kLBDyRows;
  const int n_steps = hid / wg::kBox;
  constexpr int kHalf = kLBD / 2;  // dy columns per warpgroup
  init_ring(full, empty, kDyStages);

  if (wgi == wg::kConsumers) {
    // producer: stage = dh_pre rows [m0, m0 + 64) x hidden [64 ks, + 64)
    // (K-major) and W1 rows [64 ks, + 64) x all 384 columns (six MN-major boxes)
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int ks = 0; ks < n_steps; ++ks) {
        const int s = ks % kDyStages;
        wg::bar_wait(&empty[s], ((ks / kDyStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kDyStageBytes);
        uint8_t* st = ring + s * kDyStageBytes;
        wg::tma_load(st, &dhp_map, &full[s], ks * wg::kBox, (int)m0);
        for (int j = 0; j < kLBD / wg::kBox; ++j)
          wg::tma_load(st + (1 + j) * wg::kBoxBytes, &w1_map, &full[s], j * wg::kBox,
                       ks * wg::kBox);
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    float acc[96];  // dy: 64 rows x columns [192 wgi, 192 wgi + 192)
    const uint32_t ring_s = smem_addr(ring);
    for (int ks = 0; ks < n_steps; ++ks) {
      const int s = ks % kDyStages;
      wg::bar_wait(&full[s], (ks / kDyStages) & 1);
      const uint32_t st = wg::opaque(ring_s) + s * kDyStageBytes;
      wg::mma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wg::mma_m64n192<0, 1>(
            acc, wg::desc_k(st, k4),
            wg::desc_mn(st + (1 + 3 * wgi) * wg::kBoxBytes, k4, wg::kBoxBytes), ks + k4 > 0);
      wg::mma_commit();
      wg::mma_wait<1>();
      if (ks > 0 && t == 0) wg::bar_arrive(&empty[(ks - 1) % kDyStages]);
    }
    wg::mma_wait<0>();
    wg::acc_fence(acc);
    wg::sync_named(3, 256);  // both warpgroups are past the ring: stages 0 and 1 are free

    const int warp = t >> 5, lane = t & 31;
    const int ra = wg::acc_row(t, 0), rb = ra + 8;
    const bool va = m0 + ra < m, vb = m0 + rb < m;
    const float mean_a = va ? stats[2 * (m0 + ra)] : 0.f;
    const float rstd_a = va ? stats[2 * (m0 + ra) + 1] : 0.f;
    const float mean_b = vb ? stats[2 * (m0 + rb)] : 0.f;
    const float rstd_b = vb ? stats[2 * (m0 + rb) + 1] : 0.f;
    auto pair = [&](const __nv_bfloat16* p, bool valid, int row, int col) {
      return valid ? unpack_bf16(*reinterpret_cast<const uint32_t*>(p + (m0 + row) * kLBD + col))
                   : make_float2(0.f, 0.f);
    };
    // column sums [4 warps][db2, ds, db][192] of this warpgroup, in stage 1
    float* sCol = reinterpret_cast<float*>(ring + kDyStageBytes) + wgi * 4 * 3 * kHalf;

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
      const float da0 = acc[i] * sc0, da1 = acc[i + 1] * sc1;
      const float db0 = acc[i + 2] * sc0, db1 = acc[i + 3] * sc1;
      s1a += da0 + da1;
      s2a += da0 * xa0 + da1 * xa1;
      s1b += db0 + db1;
      s2b += db0 * xb0 + db1 * xb1;
      const float c[6] = {oa.x + ob.x, oa.y + ob.y,
                          acc[i] * xa0 + acc[i + 2] * xb0, acc[i + 1] * xa1 + acc[i + 3] * xb1,
                          acc[i] + acc[i + 2], acc[i + 1] + acc[i + 3]};
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
      float* mine = sRow + wgi * kLBDyRows * 2;
      mine[2 * ra] = s1a;
      mine[2 * ra + 1] = s2a;
      mine[2 * rb] = s1b;
      mine[2 * rb + 1] = s2b;
    }
    wg::sync_named(3, 256);
    const float m1a = (sRow[2 * ra] + sRow[2 * (kLBDyRows + ra)]) / kLBD;
    const float m2a = (sRow[2 * ra + 1] + sRow[2 * (kLBDyRows + ra) + 1]) / kLBD;
    const float m1b = (sRow[2 * rb] + sRow[2 * (kLBDyRows + rb)]) / kLBD;
    const float m2b = (sRow[2 * rb + 1] + sRow[2 * (kLBDyRows + rb) + 1]) / kLBD;

    // pass 2: dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) (+ do),
    // into three swizzled boxes of stage 0
    uint8_t* stX = ring + wgi * 3 * wg::kBoxBytes;
#pragma unroll
    for (int i = 0; i < 96; i += 4) {
      const int lc = wg::acc_col(t, i), col = kHalf * wgi + lc;
      const float sc0 = ln_scale[col], sc1 = ln_scale[col + 1];
      const float2 xa = pair(x, va, ra, col), xb = pair(x, vb, rb, col);
      float a0 = rstd_a * (acc[i] * sc0 - m1a - (xa.x - mean_a) * rstd_a * m2a);
      float a1 = rstd_a * (acc[i + 1] * sc1 - m1a - (xa.y - mean_a) * rstd_a * m2a);
      float b0 = rstd_b * (acc[i + 2] * sc0 - m1b - (xb.x - mean_b) * rstd_b * m2b);
      float b1 = rstd_b * (acc[i + 3] * sc1 - m1b - (xb.y - mean_b) * rstd_b * m2b);
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
// ln_scale, ln_bias (D,) f32; w1 (HID, D), b1 (HID,), w2 (D, HID) bf16 in
// nn.Linear layout (HID a multiple of 384); dw (D * HID + HID * D) f32 =
// [dW2 (D, HID) | dW1 (HID, D)]; bias_out (HID + 3D)
// f32 = [db1 | db2 | ds | db]; scratch: y_buf (M, D) bf16, stats (M, 2) f32,
// h_buf and dhp_buf (M, HID) bf16, db1_part (ceil(M / 128), HID) f32,
// ln_part (ceil(M / 64), 3D) f32, wgrad_part (splits, 2, D, HID) f32. All
// contiguous. Returns a cudaError_t: the first failed launch's (or TMA
// descriptor's), or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int dcvit_ln_mlp_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* dout,
                                void* dx, void* dw, void* bias_out, void* y_buf,
                                void* stats, void* h_buf, void* dhp_buf, void* db1_part,
                                void* ln_part, void* wgrad_part, long long m, int d, int hid,
                                int residual, int splits, void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  if (d != kLBD || hid % kWgN != 0 || hid % kLBTile != 0 || m < 1 || splits < 1 ||
      (m + kLBTile - 1) / kLBTile > 65535 || m > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles128 = (m + kLBTile - 1) / kLBTile;
  const long long tiles64 = (m + kLBDyRows - 1) / kLBDyRows;
  cudaError_t err;

  ln_rows_kernel<<<(unsigned)((m + 7) / 8), 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<bf16*>(y_buf), static_cast<float*>(stats),
      m);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  CUtensorMap y128, do128, w1_k128, w2_mn, h64, dhp64, w1_mn, dx64, do64, y64;

  const struct {
    CUtensorMap* map;
    const void* ptr;
    long long rows;
    int cols, box_rows;
  } maps[] = {
      {&y128, y_buf, m, kLBD, kLBTile},   {&do128, dout, m, kLBD, kLBTile},
      {&w1_k128, w1, hid, kLBD, kLBTile}, {&w2_mn, w2, kLBD, hid, wg::kBox},
      {&h64, h_buf, m, hid, wg::kBox},    {&dhp64, dhp_buf, m, hid, wg::kBox},
      {&w1_mn, w1, hid, kLBD, wg::kBox},  {&dx64, dx, m, kLBD, wg::kBox},
      {&do64, dout, m, kLBD, wg::kBox},   {&y64, y_buf, m, kLBD, wg::kBox},
  };
  for (const auto& mp : maps)
    if ((err = tensor_map(mp.map, mp.ptr, mp.rows, mp.cols, mp.box_rows)) != cudaSuccess)
      return (int)err;
  const struct {
    const void* fn;
    int smem;
  } attrs[] = {{(const void*)dual_kernel, kDualSmem},
               {(const void*)dy_kernel, kDySmem}};
  for (const auto& a : attrs)
    if ((err = cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    a.smem)) != cudaSuccess)
      return (int)err;

  dual_kernel<<<dim3(hid / kLBTile, (unsigned)tiles128), wg::kThreads, kDualSmem, st>>>(
      y128, do128, w1_k128, w2_mn, h64, dhp64, static_cast<const bf16*>(b1),
      static_cast<float*>(db1_part), hid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dy_kernel<<<(unsigned)tiles64, wg::kThreads, kDySmem, st>>>(
      dhp64, w1_mn, dx64, static_cast<const bf16*>(x), static_cast<const bf16*>(dout),
      static_cast<const float*>(ln_scale), static_cast<const float*>(stats),
      static_cast<float*>(ln_part), m, hid, residual);
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
