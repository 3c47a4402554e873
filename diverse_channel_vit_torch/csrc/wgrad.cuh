// Weight gradients of the int8 ln_mlp backward (ln_mlp_q_bwd.cu), without
// f32 atomics. (The bf16 backwards, ln_mlp_bwd.cu and attend_project_bwd.cu,
// have `wgmma` weight-gradient kernels of their own.)
//
// A weight gradient is C = A^T B summed over every row of a batch (here up to
// 64 x 1600 rows): dW2 = do^T h and dW1 = dh_pre^T y. The TPU kernel summed
// these across a sequential grid in VMEM scratch; Hopper blocks run in no
// order, so:
//
// - `wgrad_kernel`: block (tile of 64 x 64 outputs, split s) sums the rows of
//   split s in order, streaming 64-row stages of A and B through a
//   double-buffered cp.async ring, and writes its f32 partial
//   part[s][M1][M2]. Four warps hold 32 x 32 of the tile each in registers
//   (bf16 mma.sync, f32 accumulation); A^T's fragments come from ldmatrix.trans.
// - `reduce_partials_kernel` (reduce.cuh) sums the partials in a fixed
//   order, so the result is the same from run to run.
//
// Split counts are chosen by the caller so that the grid fills the card a few
// times over; rows past R are zero-filled.
#pragma once

#include "reduce.cuh"

namespace dcvit {

constexpr int kWGTile = 64;
constexpr int kWGThreads = 128;

__global__ void __launch_bounds__(kWGThreads)
    wgrad_kernel(const __nv_bfloat16* __restrict__ a, int lda, const __nv_bfloat16* __restrict__ b,
                 int ldb, float* __restrict__ part, long long rows, int m1, int m2,
                 long long rows_per_split) {
  constexpr int S = padded(kWGTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int i1 = blockIdx.y * kWGTile, i2 = blockIdx.x * kWGTile;
  const long long r_begin = (long long)blockIdx.z * rows_per_split;
  const long long r_end = r_begin + rows_per_split < rows ? r_begin + rows_per_split : rows;
  const int n_steps = r_end > r_begin ? (int)((r_end - r_begin + kWGTile - 1) / kWGTile) : 0;

  __shared__ __align__(16) __nv_bfloat16 sA[2 * kWGTile * S];
  __shared__ __align__(16) __nv_bfloat16 sB[2 * kWGTile * S];

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  auto load_stage = [&](int st, int buf) {
    const long long r0 = r_begin + (long long)st * kWGTile;
    load_rows_zfill(sA + buf * kWGTile * S, a + r0 * lda + i1, kWGTile, lda, r_end - r0, tid,
                    kWGThreads);
    load_rows_zfill(sB + buf * kWGTile * S, b + r0 * ldb + i2, kWGTile, ldb, r_end - r0, tid,
                    kWGThreads);
    cp_async_commit();
  };

  if (n_steps > 0) load_stage(0, 0);
  for (int st = 0; st < n_steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_steps) {
      load_stage(st + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a_t = sA + buf * kWGTile * S;
    const __nv_bfloat16* b_t = sB + buf * kWGTile * S;
#pragma unroll
    for (int kk = 0; kk < kWGTile / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) load_a_frag_km(af[mi], a_t, S, wm * 32 + mi * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        load_b_frag_kn(bfr, b_t, S, wn * 32 + np * 16, kk * 16, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // `buf` is free for the stage after next
  }

  float* out = part + (long long)blockIdx.z * m1 * m2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i1 + wm * 32 + mi * 16 + g + half * 8;
        const int c = i2 + wn * 32 + j * 8 + t4 * 2;
        *reinterpret_cast<float2*>(out + (long long)r * m2 + c) =
            make_float2(acc[mi][j][2 * half], acc[mi][j][2 * half + 1]);
      }
}

// Returns the launch's cudaError_t.
inline cudaError_t launch_wgrad(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb,
                                float* part, long long rows, int m1, int m2, int splits,
                                cudaStream_t stream) {
  const long long per = (rows + splits - 1) / splits;
  const long long rows_per_split = (per + kWGTile - 1) / kWGTile * kWGTile;
  const dim3 grid(m2 / kWGTile, m1 / kWGTile, splits);
  wgrad_kernel<<<grid, kWGThreads, 0, stream>>>(a, lda, b, ldb, part, rows, m1, m2,
                                               rows_per_split);
  return cudaGetLastError();
}

}  // namespace dcvit
