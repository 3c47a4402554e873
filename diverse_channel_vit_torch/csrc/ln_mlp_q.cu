// int8 ln_mlp forward: LayerNorm, int8 fc1, tanh-GELU, int8 fc2, bias and
// optional residual in one launch (`model.quantization = int8`).
//
// Replaces the TPU kernel `_ln_mlp_q_fwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:474), reached through
// `_ln_mlp_q_fwd_impl` (:490) and `ln_mlp(..., quantized=True)`.
//
// Arithmetic, as the TPU kernel's: y = LayerNorm(x) in f32 (eps 1e-6); y is
// quantised per row to int8 (scale max(max|y| / 127, 1e-8), codes
// round-half-even(y / s)); acc = yq W1q^T in int32; h_pre = (acc * ys) * s1c
// + b1 in f32; h = GELU_tanh(h_pre); h quantised per row the same way;
// out = (float(hq W2q^T) * hs) * s2c + b2 (+ x), rounded to bf16 once. W1q
// (HID, D) and W2q (D, HID) are per-output-unit int8 copies of the bf16
// weights, k-major as nn.Linear holds them.
//
// What bounds it on an H100: operations. Per image and layer at the
// DiChaViT-S flagship (1569 real rows, D = 384, hidden 1536) the two int8
// GEMMs are 1.85 G operations (0.93 us at the dense int8 peak) against
// about 2.4 MB of compulsory traffic (x and out in bf16, 0.6 MB of int8
// weights once).
//
// Design. The crux is the per-row scale of h: quantising h needs max|h| over
// all 1536 hidden units of a row before any of fc2's int8 products can
// start, where B3 (ln_mlp.cu) streams hidden chunks and accumulates fc2 as
// it goes. Keeping a block's f32 h in shared memory would take 192 KB for 32
// rows, leaving too little for the weight stages. This kernel instead runs
// fc1 twice over the hidden axis:
// - pass 1 streams W1q in chunks of 32 hidden units and keeps only the
//   running max|h| of each row (registers, then one shared reduction);
// - pass 2 streams W1q and W2q, recomputes h exactly as pass 1 did (int32
//   sums are exact and order-free, and the dequantisation and GELU are the
//   same instructions), quantises it with the now-known scale into a 64 x 32
//   int8 tile and accumulates fc2 in int32 registers across all chunks.
// That costs one more fc1, 1.5x the int8 work of a single pass, at twice the
// bf16 tensor-core rate. A block owns 64 rows; eight warps split each chunk's
// fc1 as 4 row groups x 2 halves of the chunk and fc2's 64 x D int32
// accumulator as 4 row groups x 2 column halves of D. Weights stream through
// a double-buffered cp.async ring; at 0.6 MB they stay in the 50 MB L2.
// With `codes` set the kernel also writes hq (M, HID), the codes fc2 read,
// so that a check can count the codes that differ from the plain version's.
#include "int8.cuh"

namespace dcvit {

template <int D>
struct QFwdLayout {
  static constexpr int SY = padded_s8(D), SC = padded_s8(kQChunk);
  static constexpr int w1 = kQRows * SY;                  // [2][kQChunk][SY]
  static constexpr int w2 = w1 + 2 * kQChunk * SY;        // [2][D][SC]
  static constexpr int hq = w2 + 2 * D * SC;              // [kQRows][SC]
  static constexpr int stats = hq + kQRows * SC;          // f32 ys[64], rmax[2][64]
  static constexpr int bytes = stats + 4 * 3 * kQRows;
};

template <int D>
__global__ void __launch_bounds__(kQThreads, 1)
    ln_mlp_q_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                        const float* __restrict__ ln_bias, const int8_t* __restrict__ w1q,
                        const float* __restrict__ s1c, const __nv_bfloat16* __restrict__ b1,
                        const int8_t* __restrict__ w2q, const float* __restrict__ s2c,
                        const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                        int8_t* __restrict__ codes, long long m, int hid, int residual) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  using L = QFwdLayout<D>;
  constexpr int SY = L::SY, SC = L::SC;
  constexpr int WN = D / 2;              // fc2 output columns per warp
  constexpr int HN = kQChunk / 2;        // fc1 hidden columns per warp in a chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int ra = rg * 16 + g, rb = ra + 8;
  const long long m0 = (long long)blockIdx.x * kQRows;
  const long long rows_here = m - m0;  // >= 1; rows at or past it are padding

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sY = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sW1 = sY + L::w1;
  int8_t* sW2 = sY + L::w2;
  int8_t* sHq = sY + L::hq;
  float* sYs = reinterpret_cast<float*>(smem_raw + L::stats);
  float* sMax = sYs + kQRows;  // [2 column halves][64 rows]

  const int n_chunks = hid / kQChunk;
  // step s < n_chunks is pass 1 over chunk s, step n_chunks + c pass 2 over chunk c
  auto load_step = [&](int s, int buf) {
    const int c = s % n_chunks;
    load_s8_async(sW1 + buf * kQChunk * SY, w1q + (long long)c * kQChunk * D, kQChunk, D, D, SY,
                  tid, kQThreads);
    if (s >= n_chunks)
      load_s8_async(sW2 + buf * D * SC, w2q + c * kQChunk, D, kQChunk, hid, SC, tid, kQThreads);
    cp_async_commit();
  };
  load_step(0, 0);  // chunk 0 of W1q loads while the LayerNorm runs

  for (int r = warp; r < kQRows; r += kQThreads / 32) {
    int8_t* yrow = sY + r * SY;
    if (r >= rows_here) {
#pragma unroll
      for (int i = 0; i < D / 64; ++i)
        *reinterpret_cast<char2*>(yrow + 2 * (lane + 32 * i)) = make_char2(0, 0);
      if (lane == 0) sYs[r] = 1.f;
      continue;
    }
    float2 y[D / 64];
    float mean, rstd;
    ln_row<D>(x + (m0 + r) * D, ln_scale, ln_bias, lane, y, mean, rstd);
    const float s = quant_row(y, yrow, lane);
    if (lane == 0) sYs[r] = s;
  }

  int acc[WN / 8][4];  // fc2: rows [16 rg, +16) x out columns [WN cg, +WN)
  zero_acc(acc);
  float rmax_a = 0.f, rmax_b = 0.f, hs_a = 1.f, hs_b = 1.f;

  for (int s = 0; s < 2 * n_chunks; ++s) {
    const int buf = s & 1, c = s % n_chunks;
    const bool pass2 = s >= n_chunks;
    if (s + 1 < 2 * n_chunks) {
      load_step(s + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step s's weights (and, at s == 0, y) are visible
    if (s == n_chunks) {  // every warp's pass-1 row maxima are in sMax
      hs_a = row_scale(fmaxf(sMax[ra], sMax[kQRows + ra]));
      hs_b = row_scale(fmaxf(sMax[rb], sMax[kQRows + rb]));
    }

    // fc1: rows [16 rg, +16) x hidden [HN cg, +HN) of the chunk
    int hacc[HN / 8][4];
    zero_acc(hacc);
    mma_s8_rows<D / 32, HN / 16>(hacc, sY, SY, rg * 16, sW1 + buf * kQChunk * SY, SY, cg * HN,
                                 lane);
    const float ys_a = sYs[ra], ys_b = sYs[rb];
#pragma unroll
    for (int j = 0; j < HN / 8; ++j) {
      const int lc = cg * HN + j * 8 + t4 * 2;  // column within the chunk
      const int hc = c * kQChunk + lc;
      const float cs0 = s1c[hc], cs1 = s1c[hc + 1];
      const float bb0 = bf(b1[hc]), bb1 = bf(b1[hc + 1]);
      float h[4];
      h[0] = gelu_tanh_rn(__fadd_rn(dequant(hacc[j][0], ys_a, cs0), bb0));
      h[1] = gelu_tanh_rn(__fadd_rn(dequant(hacc[j][1], ys_a, cs1), bb1));
      h[2] = gelu_tanh_rn(__fadd_rn(dequant(hacc[j][2], ys_b, cs0), bb0));
      h[3] = gelu_tanh_rn(__fadd_rn(dequant(hacc[j][3], ys_b, cs1), bb1));
      if (!pass2) {
        rmax_a = fmaxf(rmax_a, fmaxf(fabsf(h[0]), fabsf(h[1])));
        rmax_b = fmaxf(rmax_b, fmaxf(fabsf(h[2]), fabsf(h[3])));
        continue;
      }
      const char2 qa = make_char2(quant_s8(h[0], hs_a), quant_s8(h[1], hs_a));
      const char2 qb = make_char2(quant_s8(h[2], hs_b), quant_s8(h[3], hs_b));
      *reinterpret_cast<char2*>(sHq + ra * SC + lc) = qa;
      *reinterpret_cast<char2*>(sHq + rb * SC + lc) = qb;
      if (codes != nullptr) {
        if (ra < rows_here) *reinterpret_cast<char2*>(codes + (m0 + ra) * hid + hc) = qa;
        if (rb < rows_here) *reinterpret_cast<char2*>(codes + (m0 + rb) * hid + hc) = qb;
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
    if (pass2) {
      __syncthreads();  // the whole 64 x 32 hq tile is written
      // fc2: rows [16 rg, +16) x out columns [WN cg, +WN), one k-step of 32
      mma_s8_rows<1, WN / 16>(acc, sHq, SC, rg * 16, sW2 + buf * D * SC, SC, cg * WN, lane);
    }
    __syncthreads();  // `buf` and the hq tile are free for the next step
  }

#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = cg * WN + j * 8 + t4 * 2;
    const float cs0 = s2c[col], cs1 = s2c[col + 1];
    const float bb0 = bf(b2[col]), bb1 = bf(b2[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= rows_here) continue;
      const float hs = half ? hs_b : hs_a;
      float v0 = __fadd_rn(dequant(acc[j][2 * half], hs, cs0), bb0);
      float v1 = __fadd_rn(dequant(acc[j][2 * half + 1], hs, cs1), bb1);
      if (residual) {
        const float2 xr = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + (m0 + r) * D + col));
        v0 = __fadd_rn(v0, xr.x);
        v1 = __fadd_rn(v1, xr.y);
      }
      *reinterpret_cast<uint32_t*>(out + (m0 + r) * D + col) = pack_bf16(v0, v1);
    }
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: x and out (M, D) bf16;
// ln_scale, ln_bias (D,) f32; w1q (HID, D) int8 with s1c (HID,) f32; b1
// (HID,) bf16; w2q (D, HID) int8 with s2c (D,) f32; b2 (D,) bf16; codes
// (M, HID) int8 or null. All contiguous. Returns a cudaError_t: the launch's,
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int dcvit_ln_mlp_q_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1q, const void* s1c, const void* b1,
                                  const void* w2q, const void* s2c, const void* b2, void* out,
                                  void* codes, long long m, int d, int hid, int residual,
                                  void* stream) {
  using namespace dcvit;
  if (d != 384 || hid % kQChunk != 0 || m < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (m + kQRows - 1) / kQRows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int smem = QFwdLayout<384>::bytes;
  auto kernel = ln_mlp_q_fwd_kernel<384>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kQThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(s1c), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const int8_t*>(w2q), static_cast<const float*>(s2c),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out),
      static_cast<int8_t*>(codes), m, hid, residual);
  return (int)cudaGetLastError();
}
