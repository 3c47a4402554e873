// int8_ln_mlp: LayerNorm, int8 fc1, tanh-GELU, int8 fc2, bias and optional
// residual in one launch, computing the hidden activation ONCE.
//
// Replaces the TPU kernel `_int8_kernel` (scripts/bench_int8_lnmlp.py:39),
// reached through `int8_ln_mlp` (:55, call :58), the prototype of the
// package's int8 ln_mlp forward (B7, ln_mlp_q.cu).
//
// Arithmetic, as the TPU kernel's (:41-52) and B7's: y = LayerNorm(x) in f32
// (eps 1e-6); y quantised per row (scale max(max|y| / 127, 1e-8), codes
// round-half-even(y / s)); h = GELU_tanh((float(yq W1q^T) * ys) * s1 + b1);
// h quantised per row the same way; out = (float(hq W2q^T) * hs) * s2 + b2
// (+ x), rounded to bf16 once. W1q (HID, D) and W2q (D, HID) are int8 codes
// with a scale per output unit, quantised outside the kernel, k-major as
// nn.Linear holds them. The quantisation, dequantisation, LayerNorm and GELU
// are int8.cuh's round-to-nearest helpers, B7's instructions, so on the same
// codes and scales this kernel writes B7's codes and outputs.
//
// What bounds it on an H100: operations. The two int8 GEMMs are
// 4 * M * D * HID operations, 242 G at the benchmark's defaults (M = 64 *
// 1600 rows, D = 384, HID = 1536), 0.12 ms at 1979 TOP/s, against 158 MB of
// compulsory traffic (x read and out written in bf16, 1.2 MB of int8
// weights), 0.05 ms at 3.35 TB/s.
//
// Design. Quantising h needs each row's max|h| over all HID hidden units
// before fc2's first int8 product. The TPU kept a block's whole h in VMEM
// and computed it once (the point of the prototype, :1-9); B7 cannot hold
// 64 rows of f32 h beside its weight stages and runs fc1 twice instead. This
// kernel keeps the one pass by keeping fewer rows: a block owns 16 rows (one
// m16 tile), whose f32 h (16 x 1536 x 4 B = 96 KB) stays in shared memory
// beside a ring of int8 weight stages.
// - fc1: the 16 rows' y codes stay in registers as A fragments; W1q streams
//   in stages of 64 hidden units through a ring of three cp.async buffers
//   (two stages in flight while one is used), each warp taking 8 units of a
//   stage (one n8 tile, 12 k-steps of 32); h = GELU(dequant + b1) goes to
//   shared memory in f32 while each warp keeps its rows' running max|h|.
// - between the passes: the eight warps' row maxima give each row's scale,
//   and h is quantised once, in place order, into a 16 x HID int8 tile (the
//   codes fc2 reads; with `codes` also written out for checks).
// - fc2: W2q streams through the same ring in stages of 64 hidden units (two
//   k-steps), each warp owning 48 of the D = 384 output columns in int32
//   registers; the epilogue dequantises, adds b2 (and x) and writes bf16.
// Shared memory at HID = 1536: 96.5 KB of h, 24 KB of hq, 6 KB of y codes,
// 90 KB of weight ring: one block of eight warps per SM. Every block reads
// both weight matrices (1.2 MB) from L2, four times as often per row as B7's
// 64-row blocks read theirs, so the ring keeps two stages in flight.
#include "int8.cuh"

namespace dcvit {

constexpr int kS3Rows = 16;     // rows per block: one m16 tile
constexpr int kS3Threads = 256;  // eight warps
constexpr int kS3Stage = 64;    // hidden units per weight stage (fc1 and fc2)
constexpr int kS3Ring = 3;      // weight stages in the ring: two in flight

// Shared-memory layout for D and a hidden width `hid` (a multiple of 64).
template <int D>
struct S3Layout {
  static constexpr int SY = padded_s8(D);             // y codes and W1q stage rows
  static constexpr int SC2 = padded_s8(kS3Stage);     // W2q stage rows
  static constexpr int w1_stage = kS3Stage * SY;      // [64 hidden][SY]
  static constexpr int w2_stage = D * SC2;            // [D][SC2]
  static constexpr int stage = w1_stage > w2_stage ? w1_stage : w2_stage;
  int sh, sq;                      // row strides: h in floats, hq in bytes
  int ring, hq, y, stats, bytes;   // byte offsets (h at 0) and the total
  __host__ __device__ explicit S3Layout(int hid)
      : sh(hid + 8), sq(hid + 16),
        ring(4 * kS3Rows * (hid + 8)),
        hq(ring + kS3Ring * stage),
        y(hq + kS3Rows * (hid + 16)),
        stats(y + kS3Rows * SY),
        bytes(stats + 4 * (2 * kS3Rows + 8 * kS3Rows)) {}
};

template <int D>
__global__ void __launch_bounds__(kS3Threads, 1)
    int8_ln_mlp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                       const float* __restrict__ ln_bias, const int8_t* __restrict__ w1q,
                       const float* __restrict__ s1, const __nv_bfloat16* __restrict__ b1,
                       const int8_t* __restrict__ w2q, const float* __restrict__ s2,
                       const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                       int8_t* __restrict__ codes, long long m, int hid, int residual) {
  static_assert(D % 64 == 0 && D % (8 * 16) == 0, "D must split into eight n16 groups");
  using L = S3Layout<D>;
  constexpr int SY = L::SY, SC2 = L::SC2;
  constexpr int WN = D / 8;  // fc2 output columns per warp
  const L lay(hid);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long m0 = (long long)blockIdx.x * kS3Rows;
  const long long rows_here = m - m0;  // >= 1; rows at or past it are padding

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sH = reinterpret_cast<float*>(smem_raw);       // [16][sh] f32 h
  int8_t* sRing = reinterpret_cast<int8_t*>(smem_raw + lay.ring);
  int8_t* sHq = reinterpret_cast<int8_t*>(smem_raw + lay.hq);  // [16][sq]
  int8_t* sY = reinterpret_cast<int8_t*>(smem_raw + lay.y);    // [16][SY]
  float* sYs = reinterpret_cast<float*>(smem_raw + lay.stats);  // y row scales
  float* sHs = sYs + kS3Rows;                                   // h row scales
  float* sMax = sHs + kS3Rows;                                  // [8 warps][16 rows]

  const int n_stages = hid / kS3Stage;
  // step s < n_stages is fc1 over hidden stage s, step n_stages + c fc2 over
  // stage c; each loads into ring buffer `buf` as one cp.async group
  auto load_step = [&](int s, int buf) {
    int8_t* dst = sRing + buf * L::stage;
    if (s < n_stages)
      load_s8_async(dst, w1q + (long long)s * kS3Stage * D, kS3Stage, D, D, SY, tid, kS3Threads);
    else
      load_s8_async(dst, w2q + (s - n_stages) * kS3Stage, D, kS3Stage, hid, SC2, tid,
                    kS3Threads);
    cp_async_commit();
  };
  // the first kS3Ring - 1 stages of W1q load while the LayerNorm runs
  for (int s = 0; s < kS3Ring - 1; ++s) load_step(s, s);

  for (int r = warp; r < kS3Rows; r += kS3Threads / 32) {
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

  uint32_t yf[D / 32][4];  // the block's y codes as A fragments, all of K
  int acc[WN / 8][4];      // fc2: 16 rows x out columns [WN warp, +WN)
  zero_acc(acc);
  float rmax_a = 0.f, rmax_b = 0.f, ys_a = 1.f, ys_b = 1.f;

  for (int s = 0; s < 2 * n_stages; ++s) {
    const int8_t* w_t = sRing + (s % kS3Ring) * L::stage;
    // refill the buffer step s - 1 used (every warp passed the end of step
    // s - 1); an empty group past the last step keeps the count uniform
    if (s + kS3Ring - 1 < 2 * n_stages)
      load_step(s + kS3Ring - 1, (s + kS3Ring - 1) % kS3Ring);
    else
      cp_async_commit();
    cp_async_wait<kS3Ring - 1>();
    __syncthreads();  // step s's weights (and, at s == 0, y) are visible
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) load_a_frag_s8(yf[kk], sY, SY, 0, kk * 32, lane);
      ys_a = sYs[g];
      ys_b = sYs[g + 8];
    }
    if (s < n_stages) {
      // fc1: 16 rows x hidden units [64 s + 8 warp, +8), two k-steps per ldmatrix
      int hacc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k2 = 0; k2 < D / 64; ++k2) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, w_t + (warp * 8 + (lane & 7)) * SY + k2 * 64 + (lane >> 3) * 16);
        mma_s8(hacc, yf[2 * k2], bfr[0], bfr[1]);
        mma_s8(hacc, yf[2 * k2 + 1], bfr[2], bfr[3]);
      }
      const int hc = s * kS3Stage + warp * 8 + t4 * 2;
      const float cs0 = s1[hc], cs1 = s1[hc + 1];
      const float bb0 = bf(b1[hc]), bb1 = bf(b1[hc + 1]);
      float2 ha, hb;
      ha.x = gelu_tanh_rn(__fadd_rn(dequant(hacc[0], ys_a, cs0), bb0));
      ha.y = gelu_tanh_rn(__fadd_rn(dequant(hacc[1], ys_a, cs1), bb1));
      hb.x = gelu_tanh_rn(__fadd_rn(dequant(hacc[2], ys_b, cs0), bb0));
      hb.y = gelu_tanh_rn(__fadd_rn(dequant(hacc[3], ys_b, cs1), bb1));
      *reinterpret_cast<float2*>(sH + g * lay.sh + hc) = ha;
      *reinterpret_cast<float2*>(sH + (g + 8) * lay.sh + hc) = hb;
      rmax_a = fmaxf(rmax_a, fmaxf(fabsf(ha.x), fabsf(ha.y)));
      rmax_b = fmaxf(rmax_b, fmaxf(fabsf(hb.x), fabsf(hb.y)));
      if (s == n_stages - 1) {  // this warp's row maxima over its columns of every stage
        rmax_a = quad_max(rmax_a);
        rmax_b = quad_max(rmax_b);
        if (t4 == 0) {
          sMax[warp * kS3Rows + g] = rmax_a;
          sMax[warp * kS3Rows + g + 8] = rmax_b;
        }
      }
    } else {
      const int c = s - n_stages;
      if (c == 0) {  // every h value and every warp's row maxima are in shared memory
        if (tid < kS3Rows) {
          float amax = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) amax = fmaxf(amax, sMax[w * kS3Rows + tid]);
          sHs[tid] = row_scale(amax);
        }
        __syncthreads();
        // quantise h once: four values per thread and pass
        const int per_row = hid / 4;
        for (int i = tid; i < kS3Rows * per_row; i += kS3Threads) {
          const int r = i / per_row, col = (i - r * per_row) * 4;
          const float4 hv = *reinterpret_cast<const float4*>(sH + r * lay.sh + col);
          const float hs = sHs[r];
          const char4 qv = make_char4(quant_s8(hv.x, hs), quant_s8(hv.y, hs),
                                      quant_s8(hv.z, hs), quant_s8(hv.w, hs));
          *reinterpret_cast<char4*>(sHq + r * lay.sq + col) = qv;
          if (codes != nullptr && r < rows_here)
            *reinterpret_cast<char4*>(codes + (m0 + r) * hid + col) = qv;
        }
        __syncthreads();  // the whole hq tile is written
      }
      // fc2: 16 rows x out columns [WN warp, +WN), hidden [64 c, +64): two k-steps
#pragma unroll
      for (int kk = 0; kk < kS3Stage / 32; ++kk) {
        uint32_t af[4];
        load_a_frag_s8(af, sHq, lay.sq, 0, c * kS3Stage + kk * 32, lane);
#pragma unroll
        for (int np = 0; np < WN / 16; ++np) {
          uint32_t bfr[4];
          load_b_frag_s8(bfr, w_t, SC2, warp * WN + np * 16, kk * 32, lane);
          mma_s8(acc[2 * np], af, bfr[0], bfr[1]);
          mma_s8(acc[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // step s's buffer is free to be refilled
  }

  const float hs_a = sHs[g], hs_b = sHs[g + 8];
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = warp * WN + j * 8 + t4 * 2;
    const float cs0 = s2[col], cs1 = s2[col + 1];
    const float bb0 = bf(b2[col]), bb1 = bf(b2[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
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
// ln_scale, ln_bias (D,) f32; w1q (HID, D) int8 with s1 (HID,) f32; b1
// (HID,) bf16; w2q (D, HID) int8 with s2 (D,) f32; b2 (D,) bf16; codes
// (M, HID) int8 or null. All contiguous. Returns a cudaError_t: the launch's,
// or cudaErrorInvalidValue for a shape the kernel does not take (D other
// than 384, HID not a multiple of 64, or h too large for shared memory).
extern "C" int dcvit_int8_ln_mlp(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1q, const void* s1, const void* b1,
                                 const void* w2q, const void* s2, const void* b2, void* out,
                                 void* codes, long long m, int d, int hid, int residual,
                                 void* stream) {
  using namespace dcvit;
  if (d != 384 || hid < kS3Stage || hid % kS3Stage != 0 || m < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = S3Layout<384>(hid).bytes;
  const long long blocks = (m + kS3Rows - 1) / kS3Rows;
  if (smem > 232448 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto kernel = int8_ln_mlp_kernel<384>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kS3Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(s1), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const int8_t*>(w2q), static_cast<const float*>(s2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out),
      static_cast<int8_t*>(codes), m, hid, residual);
  return (int)cudaGetLastError();
}
