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
//
// What bounds it on an H100: operations. Per image and layer at the
// DiChaViT-S flagship (1569 real rows, D = 384, hidden 1536) it needs
// 6 rows D hidden = 5.6 G int8 operations (2.8 us at the int8 peak) and
// 4 rows D hidden = 3.7 GFLOP of bf16 weight-gradient products (3.7 us at
// the bf16 peak).
//
// Design. As in the forward, the per-row scale of dh_pre needs max|dh_pre|
// over all 1536 hidden units of a row before any product of the dy GEMM can
// start, and it must come from the f32 dh_pre (a bf16-rounded one gives
// other codes). B4's decomposition (ln_mlp_bwd.cu) is kept: one row-parallel
// kernel writes the bf16 operands of the weight gradients, then split-row
// weight-gradient GEMMs (wgrad.cuh) with fixed-order sums. Its row kernel
// (64 rows per block, eight warps, hidden chunks of 32) runs two passes:
// - pass 1: per chunk, h_pre (int8 GEMM over D) and dh (int8 GEMM over D),
//   dh_pre; writes h and dh_pre in bf16 to `h_buf` / `dhp_buf`, db1's
//   column sums of the f32 dh_pre, and keeps the running max|dh_pre| of
//   each row;
// - pass 2: per chunk, the same two GEMMs and dh_pre again, bit-identical
//   (exact int32 sums, the same f32 instructions); dh_pre quantised with the
//   now-known row scale into a 64 x 32 int8 tile; dy += dhq_c W1r_c^T in
//   int32 registers across all chunks.
// Then the LayerNorm backward on the dequantised dy, as in B4. The recompute
// costs two more int8 GEMMs per row (int8 runs at twice the bf16 rate).
// W1q, W2r and W1r stream through double-buffered cp.async rings (0.6 MB in
// all, resident in L2). With `codes` set the kernel also writes dhq
// (M, HID), the codes of the dy GEMM, for counting code differences.
#include "int8.cuh"
#include "wgrad.cuh"

namespace dcvit {

template <int D>
struct QBwdLayout {
  static constexpr int SY = padded_s8(D), SC = padded_s8(kQChunk);
  static constexpr int doq = kQRows * SY;                 // yq [64][SY], then doq
  static constexpr int w1 = doq + kQRows * SY;            // W1q [2][kQChunk][SY]
  static constexpr int w2 = w1 + 2 * kQChunk * SY;        // W2r [2][kQChunk][SY]
  static constexpr int w1r = w2 + 2 * kQChunk * SY;       // W1r [2][D][SC]
  static constexpr int dhq = w1r + 2 * D * SC;            // [64][SC]
  // f32: ys, dos, mean, rstd [64] each, rmax [2][64], db1 chunk sums [4][32]
  static constexpr int stats = dhq + kQRows * SC;
  static constexpr int bytes = stats + 4 * (6 * kQRows + 4 * kQChunk);
  // the LayerNorm backward reuses the W1r stages: row sums [2][64][2] and
  // column sums [4][2][D] in f32
  static_assert(4 * (2 * kQRows * 2 + 4 * 2 * D) <= 2 * D * SC, "LN scratch");
};

template <int D>
__global__ void __launch_bounds__(kQThreads, 1)
    ln_mlp_q_bwd_rows_kernel(
        const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
        const float* __restrict__ ln_bias, const int8_t* __restrict__ w1q,
        const float* __restrict__ s1c, const __nv_bfloat16* __restrict__ b1,
        const int8_t* __restrict__ w1r, const float* __restrict__ s1r,
        const int8_t* __restrict__ w2r, const float* __restrict__ s2r,
        const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dx,
        __nv_bfloat16* __restrict__ y_buf, __nv_bfloat16* __restrict__ h_buf,
        __nv_bfloat16* __restrict__ dhp_buf, float* __restrict__ bias_part,
        int8_t* __restrict__ codes, long long m, int hid, int residual) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  using L = QBwdLayout<D>;
  constexpr int SY = L::SY, SC = L::SC;
  constexpr int WN = D / 2;          // dy columns per warp
  constexpr int HN = kQChunk / 2;    // hidden columns per warp in a chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int ra = rg * 16 + g, rb = ra + 8;
  const long long m0 = (long long)blockIdx.x * kQRows;
  const long long rows_here = m - m0;  // >= 1; rows at or past it are padding
  const bool va = ra < rows_here, vb = rb < rows_here;
  const int stride = hid + 3 * D;
  float* part = bias_part + (long long)blockIdx.x * stride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sY = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sDO = sY + L::doq;
  int8_t* sW1 = sY + L::w1;
  int8_t* sW2 = sY + L::w2;
  int8_t* sW1r = sY + L::w1r;
  int8_t* sDHq = sY + L::dhq;
  float* sYs = reinterpret_cast<float*>(smem_raw + L::stats);
  float* sDOs = sYs + kQRows;
  float* sMean = sDOs + kQRows;
  float* sRstd = sMean + kQRows;
  float* sMax = sRstd + kQRows;      // [2 column halves][64 rows]
  float* sRed1 = sMax + 2 * kQRows;  // [4 row groups][kQChunk]

  const int n_chunks = hid / kQChunk;
  // step s < n_chunks is pass 1 over chunk s, step n_chunks + c pass 2 over chunk c
  auto load_step = [&](int s, int buf) {
    const int c = s % n_chunks;
    load_s8_async(sW1 + buf * kQChunk * SY, w1q + (long long)c * kQChunk * D, kQChunk, D, D, SY,
                  tid, kQThreads);
    load_s8_async(sW2 + buf * kQChunk * SY, w2r + (long long)c * kQChunk * D, kQChunk, D, D, SY,
                  tid, kQThreads);
    if (s >= n_chunks)
      load_s8_async(sW1r + buf * D * SC, w1r + c * kQChunk, D, kQChunk, hid, SC, tid, kQThreads);
    cp_async_commit();
  };
  load_step(0, 0);  // chunk 0's weights load while the LayerNorm runs

  for (int r = warp; r < kQRows; r += kQThreads / 32) {
    int8_t* yrow = sY + r * SY;
    int8_t* dorow = sDO + r * SY;
    if (r >= rows_here) {
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        *reinterpret_cast<char2*>(yrow + 2 * (lane + 32 * i)) = make_char2(0, 0);
        *reinterpret_cast<char2*>(dorow + 2 * (lane + 32 * i)) = make_char2(0, 0);
      }
      if (lane == 0) sYs[r] = sDOs[r] = 1.f, sMean[r] = sRstd[r] = 0.f;
      continue;
    }
    float2 v[D / 64];
    float mean, rstd;
    ln_row<D>(x + (m0 + r) * D, ln_scale, ln_bias, lane, v, mean, rstd);
    uint32_t* yglob = reinterpret_cast<uint32_t*>(y_buf + (m0 + r) * D);
#pragma unroll
    for (int i = 0; i < D / 64; ++i) yglob[lane + 32 * i] = pack_bf16(v[i].x, v[i].y);
    const float ys = quant_row(v, yrow, lane);
    const uint32_t* drow = reinterpret_cast<const uint32_t*>(dout + (m0 + r) * D);
#pragma unroll
    for (int i = 0; i < D / 64; ++i) v[i] = unpack_bf16(drow[lane + 32 * i]);
    const float dos = quant_row(v, dorow, lane);
    if (lane == 0) {
      sYs[r] = ys;
      sDOs[r] = dos;
      sMean[r] = mean;
      sRstd[r] = rstd;
    }
  }

  int acc[WN / 8][4];  // dy: rows [16 rg, +16) x columns [WN cg, +WN)
  zero_acc(acc);
  float rmax_a = 0.f, rmax_b = 0.f, dhs_a = 1.f, dhs_b = 1.f;

  for (int s = 0; s < 2 * n_chunks; ++s) {
    const int buf = s & 1, c = s % n_chunks;
    const bool pass2 = s >= n_chunks;
    if (s + 1 < 2 * n_chunks) {
      load_step(s + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step s's weights (and, at s == 0, the codes and row stats) are visible
    if (s == n_chunks) {  // every warp's pass-1 row maxima are in sMax
      dhs_a = row_scale(fmaxf(sMax[ra], sMax[kQRows + ra]));
      dhs_b = row_scale(fmaxf(sMax[rb], sMax[kQRows + rb]));
    }

    // h_pre = yq W1q_c^T and dh = doq W2r_c^T: rows [16 rg, +16) x hidden [HN cg, +HN)
    int hacc[HN / 8][4], dhacc[HN / 8][4];
    zero_acc(hacc);
    zero_acc(dhacc);
    mma_s8_rows<D / 32, HN / 16>(hacc, sY, SY, rg * 16, sW1 + buf * kQChunk * SY, SY, cg * HN,
                                 lane);
    mma_s8_rows<D / 32, HN / 16>(dhacc, sDO, SY, rg * 16, sW2 + buf * kQChunk * SY, SY, cg * HN,
                                 lane);
    const float ys_a = sYs[ra], ys_b = sYs[rb], dos_a = sDOs[ra], dos_b = sDOs[rb];
#pragma unroll
    for (int j = 0; j < HN / 8; ++j) {
      const int lc = cg * HN + j * 8 + t4 * 2;  // column within the chunk
      const int hc = c * kQChunk + lc;
      const float cs[2] = {s1c[hc], s1c[hc + 1]};
      const float rs[2] = {s2r[hc], s2r[hc + 1]};
      const float bb[2] = {bf(b1[hc]), bf(b1[hc + 1])};
      float hp[4], dp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lower = e >= 2;
        hp[e] = __fadd_rn(dequant(hacc[j][e], lower ? ys_b : ys_a, cs[e & 1]), bb[e & 1]);
        dp[e] = __fmul_rn(dequant(dhacc[j][e], lower ? dos_b : dos_a, rs[e & 1]),
                          dgelu_tanh_rn(hp[e]));
      }
      if (!pass2) {
        rmax_a = fmaxf(rmax_a, fmaxf(fabsf(dp[0]), fabsf(dp[1])));
        rmax_b = fmaxf(rmax_b, fmaxf(fabsf(dp[2]), fabsf(dp[3])));
        // db1: column sums of the f32 dh_pre (padding rows give 0: their do codes are 0)
        const float cs0 = sum_over_rows(dp[0] + dp[2]), cs1 = sum_over_rows(dp[1] + dp[3]);
        if (g == 0) {
          sRed1[rg * kQChunk + lc] = cs0;
          sRed1[rg * kQChunk + lc + 1] = cs1;
        }
        if (va) {
          const long long gi = (m0 + ra) * hid + hc;
          *reinterpret_cast<uint32_t*>(h_buf + gi) =
              pack_bf16(gelu_tanh_rn(hp[0]), gelu_tanh_rn(hp[1]));
          *reinterpret_cast<uint32_t*>(dhp_buf + gi) = pack_bf16(dp[0], dp[1]);
        }
        if (vb) {
          const long long gi = (m0 + rb) * hid + hc;
          *reinterpret_cast<uint32_t*>(h_buf + gi) =
              pack_bf16(gelu_tanh_rn(hp[2]), gelu_tanh_rn(hp[3]));
          *reinterpret_cast<uint32_t*>(dhp_buf + gi) = pack_bf16(dp[2], dp[3]);
        }
        continue;
      }
      const char2 qa = make_char2(quant_s8(dp[0], dhs_a), quant_s8(dp[1], dhs_a));
      const char2 qb = make_char2(quant_s8(dp[2], dhs_b), quant_s8(dp[3], dhs_b));
      *reinterpret_cast<char2*>(sDHq + ra * SC + lc) = qa;
      *reinterpret_cast<char2*>(sDHq + rb * SC + lc) = qb;
      if (codes != nullptr) {
        if (va) *reinterpret_cast<char2*>(codes + (m0 + ra) * hid + hc) = qa;
        if (vb) *reinterpret_cast<char2*>(codes + (m0 + rb) * hid + hc) = qb;
      }
    }
    if (s == n_chunks - 1) {  // this warp's row maxima over its half of every chunk
      rmax_a = quad_max(rmax_a);
      rmax_b = quad_max(rmax_b);
      if (t4 == 0) {
        sMax[cg * kQRows + ra] = rmax_a;
        sMax[cg * kQRows + rb] = rmax_b;
      }
    }
    __syncthreads();  // pass 1: the chunk's column sums; pass 2: the 64 x 32 dhq tile
    if (!pass2) {
      if (tid < kQChunk)
        part[c * kQChunk + tid] = sRed1[tid] + sRed1[kQChunk + tid] +
                                  sRed1[2 * kQChunk + tid] + sRed1[3 * kQChunk + tid];
    } else {
      // dy += dhq_c W1r_c^T: rows [16 rg, +16) x columns [WN cg, +WN), one k-step of 32
      mma_s8_rows<1, WN / 16>(acc, sDHq, SC, rg * 16, sW1r + buf * D * SC, SC, cg * WN, lane);
    }
    __syncthreads();  // `buf`, sDHq and sRed1 are free for the next step
  }

  // dy dequantised, then the LayerNorm backward. The W1r stages are free
  // now: they hold the row sums [2 column halves][64 rows][2] and the column
  // sums [4 row groups][2][D].
  float dy[WN / 8][4];
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = cg * WN + j * 8 + t4 * 2;
    const float s0 = s1r[col], s1 = s1r[col + 1];
    dy[j][0] = dequant(acc[j][0], dhs_a, s0);
    dy[j][1] = dequant(acc[j][1], dhs_a, s1);
    dy[j][2] = dequant(acc[j][2], dhs_b, s0);
    dy[j][3] = dequant(acc[j][3], dhs_b, s1);
  }
  float* sRow = reinterpret_cast<float*>(sW1r);
  float* sCol = sRow + 2 * kQRows * 2;
  const float mean_a = sMean[ra], rstd_a = sRstd[ra];
  const float mean_b = sMean[rb], rstd_b = sRstd[rb];
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
    const float da0 = dy[j][0] * sc0, da1 = dy[j][1] * sc1;
    const float db0 = dy[j][2] * sc0, db1 = dy[j][3] * sc1;
    s1a += da0 + da1;
    s2a += da0 * xa.x + da1 * xa.y;
    s1b += db0 + db1;
    s2b += db0 * xb.x + db1 * xb.y;
    // ds = sum dy * xhat, db = sum dy over this warp's 16 rows (padding rows: dy = 0)
    const float ds0 = sum_over_rows(dy[j][0] * xa.x + dy[j][2] * xb.x);
    const float ds1 = sum_over_rows(dy[j][1] * xa.y + dy[j][3] * xb.y);
    const float dbs0 = sum_over_rows(dy[j][0] + dy[j][2]);
    const float dbs1 = sum_over_rows(dy[j][1] + dy[j][3]);
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
    sRow[(cg * kQRows + ra) * 2] = s1a;
    sRow[(cg * kQRows + ra) * 2 + 1] = s2a;
    sRow[(cg * kQRows + rb) * 2] = s1b;
    sRow[(cg * kQRows + rb) * 2 + 1] = s2b;
  }
  __syncthreads();
  const float m1a = (sRow[ra * 2] + sRow[(kQRows + ra) * 2]) / D;
  const float m2a = (sRow[ra * 2 + 1] + sRow[(kQRows + ra) * 2 + 1]) / D;
  const float m1b = (sRow[rb * 2] + sRow[(kQRows + rb) * 2]) / D;
  const float m2b = (sRow[rb * 2 + 1] + sRow[(kQRows + rb) * 2 + 1]) / D;

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
      float v0 = rstd * (dy[j][2 * half] * sc0 - mu1 - xh.x * mu2);
      float v1 = rstd * (dy[j][2 * half + 1] * sc1 - mu1 - xh.y * mu2);
      if (residual) {
        const float2 dov =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(dout + (m0 + r) * D + col));
        v0 += dov.x;
        v1 += dov.y;
      }
      *reinterpret_cast<uint32_t*>(dx + (m0 + r) * D + col) = pack_bf16(v0, v1);
    }
  }

  // per-block partials of db2 (column sums of do), ds and db, in a fixed order
  for (int col = tid; col < D; col += kQThreads) {
    float s = 0.f;
    for (long long r = 0; r < kQRows && r < rows_here; ++r) s += bf(dout[(m0 + r) * D + col]);
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
// ln_scale, ln_bias (D,) f32; w1q (HID, D) int8 with s1c (HID,) f32; b1
// (HID,) bf16; w1r (D, HID) int8 with s1r (D,) f32; w2r (HID, D) int8 with
// s2r (HID,) f32; dw1 (HID, D) and dw2 (D, HID) f32; bias_out (HID + 3D) f32
// = [db1 | db2 | ds | db]; scratch: y_buf (M, D), h_buf and dhp_buf
// (M, HID) bf16, bias_part (ceil(M / 64), HID + 3D) f32, wgrad_part (splits,
// D, HID) f32; codes (M, HID) int8 or null. All contiguous. Returns a
// cudaError_t: the first failed launch's, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int dcvit_ln_mlp_q_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1q, const void* s1c, const void* b1,
                                  const void* w1r, const void* s1r, const void* w2r,
                                  const void* s2r, const void* dout, void* dx, void* dw1,
                                  void* dw2, void* bias_out, void* y_buf, void* h_buf,
                                  void* dhp_buf, void* bias_part, void* wgrad_part, void* codes,
                                  long long m, int d, int hid, int residual, int splits,
                                  void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  if (d != 384 || hid % 64 != 0 || m < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (m + kQRows - 1) / kQRows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = QBwdLayout<384>::bytes;
  auto kernel = ln_mlp_q_bwd_rows_kernel<384>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kQThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(s1c), static_cast<const bf16*>(b1),
      static_cast<const int8_t*>(w1r), static_cast<const float*>(s1r),
      static_cast<const int8_t*>(w2r), static_cast<const float*>(s2r),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx), static_cast<bf16*>(y_buf),
      static_cast<bf16*>(h_buf), static_cast<bf16*>(dhp_buf), static_cast<float*>(bias_part),
      static_cast<int8_t*>(codes), m, hid, residual);
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
