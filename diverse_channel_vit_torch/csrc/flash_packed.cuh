// The kernels of masked multi-head attention with no projection, on the
// flash core (flash_wgmma.cuh), shared by the package's flash_packed
// kernels (flash_packed.cu, B5; flash_packed_bwd.cu, B6) and the benchmark
// scripts' (qkv_flash.cu, S2; bench_attn_bwd.cu, S1). Each `.cu` validates
// its shapes, encodes its TMA maps and launches these:
// - `flash_packed_fwd_kernel<true>`, the forward (B5, S2): one block per
//   (64 query rows, head, image), one consumer warpgroup on
//   `fw::attend_tiles` and a producer warp streaming (K, V) tiles; with
//   `lse` it also writes each row's log-sum-exp;
// - `flash_packed_fwd_kernel<false>`, S1's statistics pass: the same block
//   with a ring of K tiles alone, `fw::stat_tiles` in place of
//   `attend_tiles` and no P V; it writes only the log-sum-exp, equal to the
//   forward's bit for bit;
// - `launch_flash_bwd<HP>`, the backward (B6, S1): the di pass, then the
//   flash core's dk/dv and dq passes.
// q, k and v are read through rank-3 maps at columns q_col, k_col and v_col
// (+ HD h): three maps at 0 for tensors of their own or strided views (B5,
// B6, S1), or one map over a packed (B, N, 3D) qkv at 0, D and 2D (S2).
// Each kernel takes the head width HD, 64 or 128 (flash_wgmma.cuh).
#pragma once

#include "flash_wgmma.cuh"

namespace dcvit {

// The ring's stages: three, but two for the forward at head width 128, whose
// 32 KiB (K, V) stages would otherwise leave one block an SM; its 81 KiB
// let two run. A stage holds the K and V tiles, or the statistics pass's K
// tile.
template <bool kPV, int HD>
constexpr int kPackedStages = kPV && HD == 128 ? 2 : fw::kFwdStages;
template <bool kPV, int HD>
constexpr int kPackedStageBytes =
    kPV ? fw::fwd_stage_bytes(HD) : fw::head_boxes(HD) * wg::kBoxBytes;
// the Q (then O) boxes, the ring, its full and empty barriers and the Q barrier
template <bool kPV, int HD>
constexpr int kFwdSmem = fw::head_boxes(HD) * wg::kBoxBytes +
                         kPackedStages<kPV, HD> * kPackedStageBytes<kPV, HD> +
                         (2 * kPackedStages<kPV, HD> + 1) * 8 + wg::kAlign;

// Grid (N / 64, heads, B). The forward's launch bound asks for two blocks an
// SM, which leaves ptxas room for the tile loop; at head width 64 the 106
// registers it uses let three run. The statistics pass holds no o and asks
// for four.
template <bool kPV, int HD>
__global__ void __launch_bounds__(fw::kFwdThreads, kPV ? 2 : 4)
    flash_packed_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap o_map, int q_col, int k_col,
                            int v_col, float* __restrict__ lse, int n, int n_valid,
                            float scale_log2) {
  constexpr int nb = fw::head_boxes(HD), kS = kPackedStages<kPV, HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = wg::align(smem_raw);  // Q, then O
  uint8_t* ring = sQ + nb * wg::kBoxBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kS * kPackedStageBytes<kPV, HD>);
  uint64_t* empty = full + kS;
  uint64_t* qbar = empty + kS;
  const int tid = threadIdx.x, t = tid & 127;
  const int q0 = blockIdx.x * fw::kWgRows, h = blockIdx.y, b = blockIdx.z, hc = h * HD;
  const int n_kt = (n_valid + fw::kWgRows - 1) / fw::kWgRows;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 1);
    }
    wg::bar_init(qbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (wg::warpgroup() == 1) {
    // producer: the Q rows, then the head's (K, V) tiles, or its K tiles
    if (t == 0) {
      wg::bar_expect_tx(qbar, nb * wg::kBoxBytes);
      for (int j = 0; j < nb; ++j)
        fw::tma_load3(sQ + j * wg::kBoxBytes, &q_map, qbar, q_col + hc + j * wg::kBox, q0, b);
      int it = 0;
      if constexpr (kPV)
        fw::load_kv_tiles<HD, kS>(ring, full, empty, it, &k_map, k_col + hc, &v_map, v_col + hc,
                                  n_kt, b);
      else
        fw::load_k_tiles<HD, kS>(ring, full, empty, it, &k_map, k_col + hc, n_kt, b);
    }
  } else {
    const int row_a = q0 + wg::acc_row(t, 0);  // this thread's rows
    float* lrow = lse != nullptr ? lse + ((long long)b * gridDim.y + h) * n : nullptr;
    wg::bar_wait(qbar, 0);
    int it = 0;
    float m_a, m_b, l_a, l_b;
    if constexpr (kPV) {
      float o[HD / 2];
      fw::attend_tiles<HD, kS>(o, m_a, m_b, l_a, l_b, smem_addr(sQ), smem_addr(ring), full,
                               empty, it, n_kt, n_valid, scale_log2, t);
      fw::finish_rows(o, m_a, m_b, l_a, l_b, lrow, row_a, row_a + 8, n, sQ, t);
      if (t == 0) {
        for (int j = 0; j < nb; ++j)
          fw::tma_store3(&o_map, sQ + j * wg::kBoxBytes, hc + j * wg::kBox, q0, b);
        wg::tma_store_commit();
        wg::tma_store_wait();
      }
    } else {
      fw::stat_tiles<HD, kS>(m_a, m_b, l_a, l_b, smem_addr(sQ), smem_addr(ring), full, empty, it,
                             n_kt, n_valid, scale_log2, t);
      fw::row_sums(l_a, l_b, m_a, m_b, lrow, row_a, row_a + 8, n, t);
    }
  }
}

// Launch flash_packed_fwd_kernel<kPV, HD> on grid (N / 64, heads, B). The
// statistics pass reads no v_map and writes no o_map.
template <bool kPV, int HD>
cudaError_t launch_flash_fwd(const CUtensorMap& q_map, const CUtensorMap& k_map,
                             const CUtensorMap& v_map, const CUtensorMap& o_map, int q_col,
                             int k_col, int v_col, float* lse, int batch, int n, int heads,
                             int n_valid, float sm_scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_packed_fwd_kernel<kPV, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFwdSmem<kPV, HD>);
  if (err != cudaSuccess) return err;
  flash_packed_fwd_kernel<kPV, HD><<<dim3(n / fw::kWgRows, heads, batch), fw::kFwdThreads,
                                     kFwdSmem<kPV, HD>, st>>>(q_map, k_map, v_map, o_map, q_col,
                                                              k_col, v_col, lse, n, n_valid,
                                                              sm_scale * fw::kLog2e);
  return cudaGetLastError();
}

// o * do over one bf16 pair, in f32
DEV float dot_pair(const __nv_bfloat16* o, const __nv_bfloat16* dO) {
  const float2 ov = unpack_bf16(*reinterpret_cast<const uint32_t*>(o));
  const float2 dv = unpack_bf16(*reinterpret_cast<const uint32_t*>(dO));
  return ov.x * dv.x + ov.y * dv.y;
}

// di[b, h, r] = sum over the head's columns of o * do, f32: the backward's
// first pass, row-parallel. Grid (B * N / kRows), one warp a row, HD / 32
// columns of each head a lane.
template <int HD, int kRows>
__global__ void __launch_bounds__(32 * kRows)
    flash_bwd_di_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
                        float* __restrict__ di, int n, int heads) {
  static_assert(HD == 64 || HD == 128, "one or two bf16 pairs per lane and head");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kRows + warp;  // b * n + r
  const long long b = row / n, r = row - b * n;
  const int d = heads * HD;
  for (int h = 0; h < heads; ++h) {
    const long long off = row * d + h * HD + lane * (HD / 32);
    float s = dot_pair(o + off, dO + off);
    if constexpr (HD == 128) s += dot_pair(o + off + 2, dO + off + 2);
    s = warp_sum(s);
    if (lane == 0) di[(b * heads + h) * n + r] = s;
  }
}

constexpr int kDiRows = 8;  // rows per block of the di pass, one per warp

// The backward given the lse: the di pass over o and do (contiguous
// (B, N, D)), then flash_bwd_kv_kernel<false, HD, HP> and
// flash_bwd_q_kernel<false, HD, HP> (HP heads a block) on grid
// (N / 64, ceil(heads / HP), B), writing [dq | dk | dv] through grads_map
// into `grads`; di is (B, H, N) f32 scratch.
template <int HD, int HP>
cudaError_t launch_flash_bwd(const CUtensorMap& q_map, const CUtensorMap& k_map,
                             const CUtensorMap& v_map, const CUtensorMap& do_map,
                             const CUtensorMap& grads_map, int q_col, int k_col, int v_col,
                             const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
                             float* di, __nv_bfloat16* grads, int batch, int n, int heads,
                             int n_valid, float sm_scale, cudaStream_t st) {
  constexpr int kv_bytes = kv_smem(HD, HP), q_bytes = q_smem(HD, HP);
  const struct {
    const void* fn;
    int smem;
  } attrs[] = {{(const void*)flash_bwd_kv_kernel<false, HD, HP>, kv_bytes},
               {(const void*)flash_bwd_q_kernel<false, HD, HP>, q_bytes}};
  cudaError_t err;
  for (const auto& a : attrs)
    if ((err = cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    a.smem)) != cudaSuccess)
      return err;

  flash_bwd_di_kernel<HD, kDiRows><<<(unsigned)((long long)batch * n / kDiRows), 32 * kDiRows,
                                     0, st>>>(o, dout, di, n, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const float scale_log2 = sm_scale * fw::kLog2e;
  const dim3 grid(n / fw::kWgRows, (heads + HP - 1) / HP, batch);
  flash_bwd_kv_kernel<false, HD, HP><<<grid, kFlashThreads * HP, kv_bytes, st>>>(
      q_map, k_map, v_map, do_map, grads_map, q_col, k_col, v_col, lse, di, grads, nullptr, n,
      n_valid, heads, scale_log2, sm_scale, 0, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_q_kernel<false, HD, HP><<<grid, kFlashThreads * HP, q_bytes, st>>>(
      q_map, k_map, v_map, do_map, grads_map, q_col, k_col, v_col, lse, di, nullptr, n, n_valid,
      heads, scale_log2, sm_scale, 0, 0);
  return cudaGetLastError();
}

}  // namespace dcvit
