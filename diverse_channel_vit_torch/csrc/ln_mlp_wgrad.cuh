// The weight gradients of the ln_mlp backwards, B4 (ln_mlp_bwd.cu) and B8
// (ln_mlp_q_bwd.cu), which both hand it the same bf16 operands: dW2 = do^T h
// and dW1 = dh_pre^T y, summed over every row of the batch (up to 64 x 1600)
// without f32 atomics.
//
// `wgrad_kernel` runs both GEMMs in one launch on the wgmma + TMA core
// (wgmma_core.cuh), 128 x 192 output tiles, both operands MN-major (wgmma's
// transposed layout, straight from the row-major activations); block (tile,
// split z) writes its f32 partial over the rows of split z, and
// `launch_ln_mlp_wgrad` then sums the splits in a fixed order (reduce.cuh),
// so two calls on the same inputs agree bit for bit. Also here: the tile
// constants and the ring set-up that B4's and B8's other kernels share.
#pragma once

#include "reduce.cuh"
#include "wgmma_core.cuh"

namespace dcvit {

constexpr int kLBTile = 128;     // rows, hidden columns or output columns of a tile

// per stage A (two MN-major [64 rows][64] boxes) and B (three)
constexpr int kWgN = 192;  // output columns of a weight-gradient tile
constexpr int kWgStages = 4;
constexpr int kWgStageBytes = (2 + kWgN / wg::kBox) * wg::kBoxBytes;
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

// Both weight gradients in one launch: dW2 (D x HID) = do^T h and dW1 (HID
// x D) = dh_pre^T y, on 128 x 192 output tiles, dW2's tiles first. Block
// (tile, split z) writes part[z][g][i1][i2] = sum over the rows of split z
// of a_g[r][i1] * b_g[r][i2] for its GEMM g; rows past the end load as zeros.
template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap do_map, const __grid_constant__ CUtensorMap h_map,
                 const __grid_constant__ CUtensorMap dhp_map,
                 const __grid_constant__ CUtensorMap y_map, float* __restrict__ part,
                 long long rows, int hid, long long rows_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  // dW2 (D x HID) and dW1 (HID x D): m2 output columns
  const int tiles2 = (D / kLBTile) * (hid / kWgN);
  const bool g1 = (int)blockIdx.x >= tiles2;
  const int tile = g1 ? blockIdx.x - tiles2 : blockIdx.x;
  const int m2 = g1 ? D : hid;
  const CUtensorMap* a_map = g1 ? &dhp_map : &do_map;
  const CUtensorMap* b_map = g1 ? &y_map : &h_map;
  const int i1 = (tile / (m2 / kWgN)) * kLBTile, i2 = (tile % (m2 / kWgN)) * kWgN;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = r_begin + rows_per_split < rows ? r_begin + rows_per_split : rows;
  const int n_steps = r_end > r_begin ? (int)((r_end - r_begin + wg::kBox - 1) / wg::kBox) : 0;
  init_ring(full, empty, kWgStages);

  if (wgi == wg::kConsumers) {
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int st = 0; st < n_steps; ++st) {
        const int s = st % kWgStages;
        const int r = (int)(r_begin + (long long)st * wg::kBox);
        wg::bar_wait(&empty[s], ((st / kWgStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kWgStageBytes);
        uint8_t* stg = ring + s * kWgStageBytes;
        for (int b = 0; b < 2; ++b)
          wg::tma_load(stg + b * wg::kBoxBytes, a_map, &full[s], i1 + b * wg::kBox, r);
        for (int b = 0; b < kWgN / wg::kBox; ++b)
          wg::tma_load(stg + (2 + b) * wg::kBoxBytes, b_map, &full[s], i2 + b * wg::kBox, r);
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    float acc[kWgN / 2];  // rows [i1 + 64 wgi, + 64) x columns [i2, i2 + 192)
    wg::acc_zero(acc);
    const uint32_t ring_s = smem_addr(ring);
    for (int st = 0; st < n_steps; ++st) {
      const int s = st % kWgStages;
      wg::bar_wait(&full[s], (st / kWgStages) & 1);
      const uint32_t stg = wg::opaque(ring_s) + s * kWgStageBytes;
      wg::mma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wg::mma_m64n192<1, 1>(acc, wg::desc_mn(stg + wgi * wg::kBoxBytes, k4, wg::kBoxBytes),
                              wg::desc_mn(stg + 2 * wg::kBoxBytes, k4, wg::kBoxBytes), 1);
      wg::mma_commit();
      wg::mma_wait<1>();
      if (st > 0 && t == 0) wg::bar_arrive(&empty[(st - 1) % kWgStages]);
    }
    wg::mma_wait<0>();
    wg::acc_fence(acc);
    float* out = part + ((long long)blockIdx.y * 2 + g1) * D * hid;
#pragma unroll
    for (int i = 0; i < kWgN / 2; i += 2) {
      const long long r = i1 + 64 * wgi + wg::acc_row(t, i);
      *reinterpret_cast<float2*>(out + r * m2 + i2 + wg::acc_col(t, i)) =
          make_float2(acc[i], acc[i + 1]);
    }
  }
}

// dW2 and dW1 in one launch on the bf16 maps (rows, cols) with 64-row boxes
// do64 (M, D), h64 and dhp64 (M, HID), y64 (M, D), then every split summed in
// order into dw, which holds dW2 (D, HID) and then dW1 (HID, D); part is
// (splits, 2, D, HID) f32 scratch. Returns the first failed launch's error.
template <int D>
inline cudaError_t launch_ln_mlp_wgrad(const CUtensorMap& do64, const CUtensorMap& h64,
                                       const CUtensorMap& dhp64, const CUtensorMap& y64,
                                       float* part, float* dw, long long m, int hid, int splits,
                                       cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute((const void*)wgrad_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return err;
  const long long per = (m + splits - 1) / splits;
  const long long rows_per_split = (per + wg::kBox - 1) / wg::kBox * wg::kBox;
  const int wg_tiles = 2 * (D / kLBTile) * (hid / kWgN);
  wgrad_kernel<D><<<dim3(wg_tiles, splits), wg::kThreads, kWgSmem, st>>>(
      do64, h64, dhp64, y64, part, m, hid, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce<1>(part, dw, splits, 2LL * D * hid, st);
}

}  // namespace dcvit
