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
//
// Design, and what differs from the TPU kernel:
// - The TPU recomputed LN / fc1 / GELU per row block and summed all six
//   weight and bias gradients in f32 VMEM scratch over one sequential sweep
//   of the grid. On Hopper a block's f32 partial of dW1 + dW2 is 4.7 MB, far
//   beyond its shared memory, and blocks run in no order. Of the two sound
//   splits (persistent blocks with private partials, or blocks split by
//   hidden chunk with partial dy sums) neither keeps the hidden activation on
//   chip without per-block weight partials of megabytes. This first version
//   takes the decomposition that needs neither: one row-parallel pass that
//   writes the bf16 operands of the weight gradients once, then the
//   weight-gradient products as split-row GEMMs (wgrad.cuh):
//   (a) `ln_mlp_bwd_rows_kernel`, one block per 64 rows (8 warps): LayerNorm
//       in f32 (two-pass, eps 1e-6) -> y (bf16, kept in shared memory and
//       written to `y_buf`); then per hidden chunk of 32, h_pre = y W1_c^T +
//       b1_c and dh = do W2_c in registers, h = GELU_tanh(h_pre) and dh_pre =
//       dh * GELU'(h_pre) rounded to bf16 (the TPU's cast points) and written
//       to `h_buf` / `dhp_buf`, db1's column sums of the f32 dh_pre, and
//       dy += dh_pre_c W1_c with the 64 x D f32 accumulator held in registers
//       across all chunks (as the forward holds its output). Then the
//       LayerNorm backward in f32 (row sums over D across two warps), dx
//       (+ do with the fused residual), and the column sums of dy * xhat (ds),
//       dy (db) and do (db2) as per-block partials;
//   (b) dW2 = do^T h and dW1 = dh_pre^T y by the split-row GEMM;
//   (c) every partial summed in a fixed order (no atomics).
//   The hidden activation goes to device memory twice over (h and dh_pre,
//   B * N * 1536 bf16 each, 315 MB at B = 64): keeping it on chip is later
//   work.
// - All products are bf16 `mma.sync.m16n8k16` with f32 accumulation.
#include "wgrad.cuh"

namespace dcvit {

constexpr int kLBRows = 64;      // rows per block
constexpr int kLBThreads = 256;  // eight warps: 4 row groups x 2 column halves
constexpr int kLBChunk = 32;     // hidden columns per chunk

template <int D>
__host__ __device__ constexpr int lb_smem_bytes() {
  // sY, sW1 (two stages), sW2 (two stages), sDH, sDO in bf16; row stats and
  // the db1 chunk sums in f32
  return 2 * (2 * kLBRows * padded(D) + 2 * kLBChunk * padded(D) + 2 * D * padded(kLBChunk) +
              kLBRows * padded(kLBChunk)) +
         4 * (2 * kLBRows + 4 * kLBChunk);
}

DEV float dgelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  const float t = tanhf(inner);
  const float dinner = 0.7978845608028654f * (1.f + 3.f * 0.044715f * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * dinner;
}

template <int D>
__global__ void __launch_bounds__(kLBThreads, 1)
    ln_mlp_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                           const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                           const __nv_bfloat16* __restrict__ w2,
                           const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dx,
                           __nv_bfloat16* __restrict__ y_buf, __nv_bfloat16* __restrict__ h_buf,
                           __nv_bfloat16* __restrict__ dhp_buf, float* __restrict__ bias_part,
                           long long m, int hid, int residual) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  constexpr int SD = padded(D), SH = padded(kLBChunk);
  constexpr int WN = D / 2;          // dy columns per warp
  constexpr int HN = kLBChunk / 2;   // hidden columns per warp in a chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const long long m0 = (long long)blockIdx.x * kLBRows;
  const long long rows_here = m - m0;  // >= 1; rows at or past it are padding
  const int stride = hid + 3 * D;
  float* part = bias_part + (long long)blockIdx.x * stride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sW1 = sY + kLBRows * SD;
  __nv_bfloat16* sW2 = sW1 + 2 * kLBChunk * SD;
  __nv_bfloat16* sDH = sW2 + 2 * D * SH;
  __nv_bfloat16* sDO = sDH + kLBRows * SH;
  float* sStat = reinterpret_cast<float*>(sDO + kLBRows * SD);  // [64][mean, rstd]
  float* sRed1 = sStat + 2 * kLBRows;                           // [4 row groups][32]

  // chunk 0's weights and the do tile load while the LayerNorm runs
  load_tile_async(sW1, w1, kLBChunk, D, D, tid, kLBThreads);
  load_tile_async(sW2, w2, D, kLBChunk, hid, tid, kLBThreads);
  load_rows_zfill(sDO, dout + m0 * D, D, D, rows_here, tid, kLBThreads);
  cp_async_commit();

  for (int r = warp; r < kLBRows; r += kLBThreads / 32) {
    uint32_t* yrow = reinterpret_cast<uint32_t*>(sY + r * SD);
    if (r >= rows_here) {
#pragma unroll
      for (int i = 0; i < D / 64; ++i) yrow[lane + 32 * i] = 0u;
      if (lane == 0) sStat[2 * r] = sStat[2 * r + 1] = 0.f;
      continue;
    }
    const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x + (m0 + r) * D);
    uint32_t* yglob = reinterpret_cast<uint32_t*>(y_buf + (m0 + r) * D);
    float2 v[D / 64];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      v[i] = unpack_bf16(xrow[lane + 32 * i]);
      sum += v[i].x + v[i].y;
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const float a = v[i].x - mean, c = v[i].y - mean;
      sq += a * a + c * c;
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + 1e-6f);
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const int col = 2 * (lane + 32 * i);
      const uint32_t yv =
          pack_bf16((v[i].x - mean) * rstd * ln_scale[col] + ln_bias[col],
                    (v[i].y - mean) * rstd * ln_scale[col + 1] + ln_bias[col + 1]);
      yrow[lane + 32 * i] = yv;
      yglob[lane + 32 * i] = yv;
    }
    if (lane == 0) {
      sStat[2 * r] = mean;
      sStat[2 * r + 1] = rstd;
    }
  }

  float acc[WN / 8][4];  // dy: rows [16 rg, 16 rg + 16) x columns [WN cg, WN cg + WN)
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_chunks = hid / kLBChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      load_tile_async(sW1 + (buf ^ 1) * kLBChunk * SD, w1 + (long long)(c + 1) * kLBChunk * D,
                      kLBChunk, D, D, tid, kLBThreads);
      load_tile_async(sW2 + (buf ^ 1) * D * SH, w2 + (c + 1) * kLBChunk, D, kLBChunk, hid, tid,
                      kLBThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c's weights (and, at c == 0, y, the stats and do) are visible
    const __nv_bfloat16* w1t = sW1 + buf * kLBChunk * SD;
    const __nv_bfloat16* w2t = sW2 + buf * D * SH;

    // h_pre = y W1_c^T and dh = do W2_c: rows [16 rg, +16) x hidden [HN cg, +HN)
    float hacc[HN / 8][4], dhacc[HN / 8][4];
#pragma unroll
    for (int j = 0; j < HN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[j][e] = dhacc[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bfr[4];
      load_a_frag(a, sY, SD, rg * 16, kk * 16, lane);
      load_b_frag_nk(bfr, w1t, SD, cg * HN, kk * 16, lane);
      mma_bf16(hacc[0], a, bfr[0], bfr[1]);
      mma_bf16(hacc[1], a, bfr[2], bfr[3]);
      load_a_frag(a, sDO, SD, rg * 16, kk * 16, lane);
      load_b_frag_kn(bfr, w2t, SH, cg * HN, kk * 16, lane);
      mma_bf16(dhacc[0], a, bfr[0], bfr[1]);
      mma_bf16(dhacc[1], a, bfr[2], bfr[3]);
    }
#pragma unroll
    for (int j = 0; j < HN / 8; ++j) {
      const int lc = cg * HN + j * 8 + t4 * 2;  // column within the chunk
      const int hc = c * kLBChunk + lc;
      const float bb0 = bf(b1[hc]), bb1 = bf(b1[hc + 1]);
      float cs0 = 0.f, cs1 = 0.f;  // db1: column sums of the f32 dh_pre
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rg * 16 + g + half * 8;
        const float hp0 = hacc[j][2 * half] + bb0, hp1 = hacc[j][2 * half + 1] + bb1;
        const float dp0 = dhacc[j][2 * half] * dgelu_tanh(hp0);
        const float dp1 = dhacc[j][2 * half + 1] * dgelu_tanh(hp1);
        cs0 += dp0;
        cs1 += dp1;
        const uint32_t dv = pack_bf16(dp0, dp1);
        *reinterpret_cast<uint32_t*>(sDH + r * SH + lc) = dv;
        if (r < rows_here) {
          const long long gi = (m0 + r) * hid + hc;
          *reinterpret_cast<uint32_t*>(h_buf + gi) = pack_bf16(gelu_tanh(hp0), gelu_tanh(hp1));
          *reinterpret_cast<uint32_t*>(dhp_buf + gi) = dv;
        }
      }
      cs0 = sum_over_rows(cs0);
      cs1 = sum_over_rows(cs1);
      if (g == 0) {
        sRed1[rg * kLBChunk + lc] = cs0;
        sRed1[rg * kLBChunk + lc + 1] = cs1;
      }
    }
    __syncthreads();  // the 64 x 32 dh_pre tile and the chunk's column sums are written
    if (tid < kLBChunk)
      part[c * kLBChunk + tid] = sRed1[tid] + sRed1[kLBChunk + tid] +
                                 sRed1[2 * kLBChunk + tid] + sRed1[3 * kLBChunk + tid];

    // dy += dh_pre_c W1_c: rows [16 rg, +16) x columns [WN cg, +WN)
#pragma unroll
    for (int kk = 0; kk < kLBChunk / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sDH, SH, rg * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < WN / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_kn(bfr, w1t, SD, cg * WN + np * 16, kk * 16, lane);
        mma_bf16(acc[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // `buf`, sDH and sRed1 are free for the next chunk
  }

  // LayerNorm backward. The weight stages are free now: they hold the row
  // sums [2 column halves][64 rows][2] and the column sums [4 row groups][2][D].
  float* sRow = reinterpret_cast<float*>(sW1);
  float* sCol = sRow + 2 * kLBRows * 2;
  const int ra = rg * 16 + g, rb = ra + 8;
  const bool va = ra < rows_here, vb = rb < rows_here;
  const float mean_a = sStat[2 * ra], rstd_a = sStat[2 * ra + 1];
  const float mean_b = sStat[2 * rb], rstd_b = sStat[2 * rb + 1];
  const uint32_t* xa_row = reinterpret_cast<const uint32_t*>(x + (m0 + ra) * D);
  const uint32_t* xb_row = reinterpret_cast<const uint32_t*>(x + (m0 + rb) * D);
  auto xhat_pair = [&](const uint32_t* row, bool valid, float mean, float rstd, int col) {
    if (!valid) return make_float2(0.f, 0.f);
    const float2 xv = unpack_bf16(row[col / 2]);
    return make_float2((xv.x - mean) * rstd, (xv.y - mean) * rstd);
  };

  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = cg * WN + j * 8 + t4 * 2;
    const float sc0 = ln_scale[col], sc1 = ln_scale[col + 1];
    const float2 xa = xhat_pair(xa_row, va, mean_a, rstd_a, col);
    const float2 xb = xhat_pair(xb_row, vb, mean_b, rstd_b, col);
    const float da0 = acc[j][0] * sc0, da1 = acc[j][1] * sc1;
    const float db0 = acc[j][2] * sc0, db1 = acc[j][3] * sc1;
    s1a += da0 + da1;
    s2a += da0 * xa.x + da1 * xa.y;
    s1b += db0 + db1;
    s2b += db0 * xb.x + db1 * xb.y;
    // ds = sum dy * xhat, db = sum dy over this warp's 16 rows
    const float ds0 = sum_over_rows(acc[j][0] * xa.x + acc[j][2] * xb.x);
    const float ds1 = sum_over_rows(acc[j][1] * xa.y + acc[j][3] * xb.y);
    const float dbs0 = sum_over_rows(acc[j][0] + acc[j][2]);
    const float dbs1 = sum_over_rows(acc[j][1] + acc[j][3]);
    if (g == 0) {
      sCol[(rg * 2) * D + col] = ds0;
      sCol[(rg * 2) * D + col + 1] = ds1;
      sCol[(rg * 2 + 1) * D + col] = dbs0;
      sCol[(rg * 2 + 1) * D + col + 1] = dbs1;
    }
  }
  s1a = sum_over_quad(s1a);
  s2a = sum_over_quad(s2a);
  s1b = sum_over_quad(s1b);
  s2b = sum_over_quad(s2b);
  if (t4 == 0) {
    sRow[(cg * kLBRows + ra) * 2] = s1a;
    sRow[(cg * kLBRows + ra) * 2 + 1] = s2a;
    sRow[(cg * kLBRows + rb) * 2] = s1b;
    sRow[(cg * kLBRows + rb) * 2 + 1] = s2b;
  }
  __syncthreads();
  const float m1a = (sRow[ra * 2] + sRow[(kLBRows + ra) * 2]) / D;
  const float m2a = (sRow[ra * 2 + 1] + sRow[(kLBRows + ra) * 2 + 1]) / D;
  const float m1b = (sRow[rb * 2] + sRow[(kLBRows + rb) * 2]) / D;
  const float m2b = (sRow[rb * 2 + 1] + sRow[(kLBRows + rb) * 2 + 1]) / D;

  // dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) (+ do)
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = cg * WN + j * 8 + t4 * 2;
    const float sc0 = ln_scale[col], sc1 = ln_scale[col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool valid = half ? vb : va;
      if (!valid) continue;
      const int r = half ? rb : ra;
      const float2 xh = half ? xhat_pair(xb_row, vb, mean_b, rstd_b, col)
                             : xhat_pair(xa_row, va, mean_a, rstd_a, col);
      const float rstd = half ? rstd_b : rstd_a;
      const float mu1 = half ? m1b : m1a, mu2 = half ? m2b : m2a;
      float v0 = rstd * (acc[j][2 * half] * sc0 - mu1 - xh.x * mu2);
      float v1 = rstd * (acc[j][2 * half + 1] * sc1 - mu1 - xh.y * mu2);
      if (residual) {
        const float2 dov = unpack_bf16(*reinterpret_cast<const uint32_t*>(sDO + r * SD + col));
        v0 += dov.x;
        v1 += dov.y;
      }
      *reinterpret_cast<uint32_t*>(dx + (m0 + r) * D + col) = pack_bf16(v0, v1);
    }
  }

  // per-block partials of db2 (column sums of do), ds and db, in a fixed order
  for (int col = tid; col < D; col += kLBThreads) {
    float s = 0.f;
    for (int r = 0; r < kLBRows; ++r) s += bf(sDO[r * SD + col]);
    part[hid + col] = s;
    float ds = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      ds += sCol[(w * 2) * D + col];
      db += sCol[(w * 2 + 1) * D + col];
    }
    part[hid + D + col] = ds;
    part[hid + 2 * D + col] = db;
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: x, do and dx (M, D) bf16;
// ln_scale, ln_bias (D,) f32; w1 (HID, D), b1 (HID,), w2 (D, HID) bf16 in
// nn.Linear layout; dw1 (HID, D) and dw2 (D, HID) f32; bias_out (HID + 3D)
// f32 = [db1 | db2 | ds | db]; scratch: y_buf (M, D), h_buf and dhp_buf
// (M, HID) bf16, bias_part (ceil(M / 64), HID + 3D) f32, wgrad_part (splits,
// D, HID) f32. All contiguous. Returns a cudaError_t: the first failed
// launch's, or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int dcvit_ln_mlp_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* dout,
                                void* dx, void* dw1, void* dw2, void* bias_out, void* y_buf,
                                void* h_buf, void* dhp_buf, void* bias_part, void* wgrad_part,
                                long long m, int d, int hid, int residual, int splits,
                                void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  if (d != 384 || hid % 64 != 0 || m < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (m + kLBRows - 1) / kLBRows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = lb_smem_bytes<384>();
  auto kernel = ln_mlp_bwd_rows_kernel<384>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kLBThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dx), static_cast<bf16*>(y_buf), static_cast<bf16*>(h_buf),
      static_cast<bf16*>(dhp_buf), static_cast<float*>(bias_part), m, hid, residual);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  float* wpart = static_cast<float*>(wgrad_part);
  // dW2 (D, HID) = do^T h; dW1 (HID, D) = dh_pre^T y; one scratch, used in turn
  err = launch_wgrad(static_cast<const bf16*>(dout), d, static_cast<const bf16*>(h_buf), hid,
                     wpart, m, d, hid, splits, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce(wpart, static_cast<float*>(dw2), splits, (long long)d * hid, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_wgrad(static_cast<const bf16*>(dhp_buf), hid, static_cast<const bf16*>(y_buf), d,
                     wpart, m, hid, d, splits, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce(wpart, static_cast<float*>(dw1), splits, (long long)hid * d, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(static_cast<const float*>(bias_part), static_cast<float*>(bias_out),
                            (int)blocks, hid + 3 * d, st);
}
