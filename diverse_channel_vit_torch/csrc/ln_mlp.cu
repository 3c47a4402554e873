// ln_mlp forward: LayerNorm, fc1, tanh-GELU, fc2, bias and optional residual
// in one launch; the hidden activation never goes to device memory.
//
// Replaces the TPU kernel `_ln_mlp_fwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:152), reached through
// `_ln_mlp_fwd_impl` and `ln_mlp`.
//
// What bounds it on an H100: operations. Per image and layer at the
// DiChaViT-S flagship (1600 rows, D = 384, hidden 1536) it does about
// 3.8 GFLOP of bf16 products against about 4.8 MB of compulsory traffic
// (x and out once, W1 and W2 once), some 790 FLOP per byte, above the
// card's ~295 FLOP/byte ridge. The traffic that would make it memory-bound is
// the (rows x 1536) hidden activation, 4.9 MB per image in bf16 each way,
// which this kernel keeps on chip as the TPU kernel kept it in VMEM.
//
// Design, and what differs from the TPU kernel:
// - The TPU held W1 and W2 (2.36 MB bf16) resident in VMEM. Here a block owns
//   64 rows and streams the weights in hidden chunks of 32 through a
//   double-buffered cp.async ring: W1 rows [c, c+32) (32 x D) and W2 columns
//   [c, c+32) (D x 32). Every block re-reads the weights; at 2.36 MB they stay
//   in the 50 MB L2.
// - LayerNorm runs once per row tile, in f32 with a two-pass mean and
//   variance (eps 1e-6), and its bf16 output y stays in shared memory.
// - For each chunk: h = GELU_tanh(y W1_c^T + b1_c) in f32, rounded to bf16
//   into a 64 x 32 shared tile; then out += h W2_c^T with the f32 accumulator
//   (64 x D) held in registers across all chunks. Eight warps split it 4 (row
//   groups of 16) x 2 (column halves of D / 2).
// - The epilogue adds b2 and, with `residual`, x in f32, and rounds to bf16
//   once. All products are bf16 `mma.sync.m16n8k16` with f32 accumulation.
#include "common.cuh"

namespace dcvit {

constexpr int kLMRows = 64;       // rows per block
constexpr int kLMThreads = 256;   // eight warps
constexpr int kLMChunk = 32;      // hidden columns per chunk

template <int D>
__host__ __device__ constexpr int lm_smem_elems() {
  return kLMRows * padded(D) + 2 * kLMChunk * padded(D) + 2 * D * padded(kLMChunk) +
         kLMRows * padded(kLMChunk);
}

template <int D>
__global__ void __launch_bounds__(kLMThreads, 1)
    ln_mlp_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ w1,
                      const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                      const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                      long long m, int hid, int residual) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  constexpr int SD = padded(D), SH = padded(kLMChunk);
  constexpr int WN = D / 2;                // fc2 output columns per warp
  constexpr int HN = kLMChunk / 2;         // fc1 hidden columns per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const long long m0 = (long long)blockIdx.x * kLMRows;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sW1 = sY + kLMRows * SD;
  __nv_bfloat16* sW2 = sW1 + 2 * kLMChunk * SD;
  __nv_bfloat16* sH = sW2 + 2 * D * SH;

  // chunk 0's weights load while the LayerNorm runs
  load_tile_async(sW1, w1, kLMChunk, D, D, tid, kLMThreads);
  load_tile_async(sW2, w2, D, kLMChunk, hid, tid, kLMThreads);
  cp_async_commit();

  for (int r = warp; r < kLMRows; r += kLMThreads / 32) {
    uint32_t* yrow = reinterpret_cast<uint32_t*>(sY + r * SD);
    if (m0 + r >= m) {
#pragma unroll
      for (int i = 0; i < D / 64; ++i) yrow[lane + 32 * i] = 0u;
      continue;
    }
    const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x + (m0 + r) * D);
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
      yrow[lane + 32 * i] =
          pack_bf16((v[i].x - mean) * rstd * ln_scale[col] + ln_bias[col],
                    (v[i].y - mean) * rstd * ln_scale[col + 1] + ln_bias[col + 1]);
    }
  }

  float acc[WN / 8][4];
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_chunks = hid / kLMChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      load_tile_async(sW1 + (buf ^ 1) * kLMChunk * SD, w1 + (long long)(c + 1) * kLMChunk * D,
                      kLMChunk, D, D, tid, kLMThreads);
      load_tile_async(sW2 + (buf ^ 1) * D * SH, w2 + (c + 1) * kLMChunk, D, kLMChunk, hid, tid,
                      kLMThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c's weights (and, at c == 0, y) are visible
    const __nv_bfloat16* w1t = sW1 + buf * kLMChunk * SD;
    const __nv_bfloat16* w2t = sW2 + buf * D * SH;

    // fc1: rows [16 rg, 16 rg + 16) x hidden [HN cg, HN cg + HN) of the chunk
    float hacc[HN / 8][4];
#pragma unroll
    for (int j = 0; j < HN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sY, SD, rg * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < HN / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, w1t, SD, cg * HN + np * 16, kk * 16, lane);
        mma_bf16(hacc[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(hacc[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < HN / 8; ++j) {
      const int lc = cg * HN + j * 8 + t4 * 2;
      const float bb0 = bf(b1[c * kLMChunk + lc]), bb1 = bf(b1[c * kLMChunk + lc + 1]);
      const int r0 = rg * 16 + g;
      *reinterpret_cast<uint32_t*>(sH + r0 * SH + lc) =
          pack_bf16(gelu_tanh(hacc[j][0] + bb0), gelu_tanh(hacc[j][1] + bb1));
      *reinterpret_cast<uint32_t*>(sH + (r0 + 8) * SH + lc) =
          pack_bf16(gelu_tanh(hacc[j][2] + bb0), gelu_tanh(hacc[j][3] + bb1));
    }
    __syncthreads();  // the whole 64 x 32 h tile is written

    // fc2: rows [16 rg, 16 rg + 16) x out columns [WN cg, WN cg + WN)
#pragma unroll
    for (int kk = 0; kk < kLMChunk / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sH, SH, rg * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < WN / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, w2t, SH, cg * WN + np * 16, kk * 16, lane);
        mma_bf16(acc[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // `buf` and the h tile are free for the next chunk
  }

#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = cg * WN + j * 8 + t4 * 2;
    const float bb0 = bf(b2[col]), bb1 = bf(b2[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = m0 + rg * 16 + g + half * 8;
      if (r >= m) continue;
      float v0 = acc[j][2 * half] + bb0, v1 = acc[j][2 * half + 1] + bb1;
      if (residual) {
        const float2 xr = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + r * D + col));
        v0 += xr.x;
        v1 += xr.y;
      }
      *reinterpret_cast<uint32_t*>(out + r * D + col) = pack_bf16(v0, v1);
    }
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: x and out (M, D) bf16,
// ln_scale and ln_bias (D,) f32, w1 (HID, D) and w2 (D, HID) in nn.Linear
// layout, b1 (HID,) and b2 (D,), all bf16 unless stated and contiguous.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int dcvit_ln_mlp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* out, long long m, int d, int hid, int residual,
                                void* stream) {
  using namespace dcvit;
  if (d != 384 || hid % kLMChunk != 0 || m < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (m + kLMRows - 1) / kLMRows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(__nv_bfloat16) * lm_smem_elems<384>();
  auto kernel = ln_mlp_fwd_kernel<384>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kLMThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out), m, hid,
      residual);
  return (int)cudaGetLastError();
}
