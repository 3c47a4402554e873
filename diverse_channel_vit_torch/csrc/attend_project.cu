// attend_project forward: masked multi-head attention over a packed qkv
// tensor, then the output projection, its bias and the residual, in one
// launch.
//
// Replaces the TPU kernel `_ap_fwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:671), reached through
// `_ap_fwd_impl` and `attend_project`.
//
// What bounds it on an H100: operations, of two kinds. Per image and layer
// at the DiChaViT-S flagship (N = 1600 padded from 1569, D = 384, 6 heads of
// 64) the function does about 4.3 GFLOP of bf16 products (2.72e11 at
// B = 64: 0.27 ms at 989 TFLOP/s) against about 6.4 MB of compulsory
// traffic (qkv, x_res and Wp read once, xo written once), some 670 FLOP per
// byte, above the card's ~295 FLOP/byte ridge; and 6 x 1569^2 exponentials
// per image (9.45e8 at B = 64: about 0.24 ms at the special-function units'
// ~3.9 T exp2/s).
//
// Design (flash_wgmma.cuh on wgmma_core.cuh), and what differs from the TPU
// kernel:
// - The TPU kept each batch row's whole K and V resident in VMEM. Here K+V of
//   one head at N = 1600 is 400 KB, above the 227 KB of shared memory a block
//   may use, so K/V stream by TMA through a three-stage mbarrier ring in
//   tiles of 64 keys, fed by a producer warp, with an online softmax
//   (running max and sum in f32 registers, quad shuffles). Key tiles at or
//   past `n_valid` are skipped; keys of the last tile at or past it get
//   -1e30 before the max. The softmax normalises once at the end, where the
//   TPU divided the unnormalised P.V by the row sum.
// - A block owns 64 query rows of one image, one consumer warpgroup, and
//   loops over all heads (the tile loop is `fw::attend_tiles`, which the
//   flash_packed forward B5 runs too). S = Q K^T is a `wgmma` m64n64 from shared memory;
//   P, rounded to bf16 against the running max, is the register A operand of
//   O += P V (V the MN-major operand of the same box). Tile kt's S product
//   is issued together with tile kt-1's P V, so the row maxima of S_kt are
//   taken while P V runs. Two blocks share an SM (80 KB of shared memory and
//   160 threads each at D = 384), so one block's exponentials run while the
//   other's products do, and 1600 blocks at the flagship fill 6.06 waves of
//   132 SMs x 2. (Blocks of 128 rows, two consumer warpgroups taking turns
//   issuing their products, ran slower on an H100: one block an SM, 832
//   blocks in 6.3 waves. So did a producer-free block with K and V in
//   separate stages, three blocks an SM: three single-tile stages could not
//   keep the loads ahead.)
// - The softmax takes the row maxima of the raw scores and folds the scale
//   into each exponential's argument (one FMA and one ex2), masks only in
//   the ragged last tile, and sums in two chains a row.
// - The Q boxes of all heads load once, at the start, into the shared O
//   boxes (64 rows x D, 48 KB at D = 384); each head's normalised O_h,
//   rounded to bf16, replaces its Q_h there. O never goes to device memory
//   unless the caller asks for it (`o`, needed only by a backward pass: then
//   each O_h leaves by TMA store, and each row's per-head log-sum-exp of the
//   scaled scores, `lse`, f32, is written for attend_project_bwd.cu).
// - The O boxes are then the K-major A operand of the fused projection
//   xo = O Wp^T + bp (+x_res), Wp's [128 output columns][64] boxes streaming
//   through the same ring; the warpgroup holds a 64 x 128 f32 accumulator
//   (64 registers) per chunk of 128 output columns, and adds bp and x_res in
//   f32 before the single bf16 rounding.
// - Head width 64 or 128 (a template parameter, as in the whole flash core;
//   the `small_tpu` preset has 3 heads of 128). A head of 128 is two boxes
//   of Q (then O), and its (K, V) stage 32 KB: at D = 384 the block holds
//   145 KB (48 KB of Q, three 32 KB stages), one block an SM, where at
//   head width 64 two fit. Up to 22 heads of 64 (D = 1408) or 8 of 128
//   (D = 1024) fit a block's shared memory.
// - Rows past N load as zeros and are clipped by TMA stores or skipped by
//   the epilogue.
#include "flash_wgmma.cuh"

namespace dcvit {

constexpr int kApN = 128;                 // output columns of a projection chunk
constexpr int kWpBox = kApN * 128;        // a [128 output columns][64] Wp box
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may use

constexpr int kApRows = fw::kWgRows;      // query rows of a block, and keys of a tile
constexpr int kApBox = kApRows * 128;      // a Q (then O) box of 64 columns, or a K or V box
constexpr int kApStages = fw::kFwdStages;
constexpr int kApThreads = fw::kFwdThreads;
// a stage: one head's K + V tiles, or one Wp box
static_assert(fw::fwd_stage_bytes(64) >= kWpBox, "a Wp box fits a stage");
__host__ __device__ constexpr int ap_smem(int heads, int hd) {
  return heads * fw::head_boxes(hd) * kApBox + kApStages * fw::fwd_stage_bytes(hd) +
         (2 * kApStages + 1) * 8 + wg::kAlign;
}

template <int HD>
__global__ void __launch_bounds__(kApThreads, 2)
    ap_fwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                  const __grid_constant__ CUtensorMap wp_map,
                  const __grid_constant__ CUtensorMap o_map,
                  const __nv_bfloat16* __restrict__ x_res, const __nv_bfloat16* __restrict__ bp,
                  float* __restrict__ lse_out, __nv_bfloat16* __restrict__ xo, int n, int heads,
                  int d_out, int n_valid, float scale_log2, int need_o) {
  constexpr int nb = fw::head_boxes(HD), kStage = fw::fwd_stage_bytes(HD);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sO = wg::align(smem_raw);  // D / 64 boxes [64][64]: Q, then O; head h's from h nb
  uint8_t* ring = sO + heads * nb * kApBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kApStages * kStage);
  uint64_t* empty = full + kApStages;
  uint64_t* qbar = empty + kApStages;
  const int tid = threadIdx.x, t = tid & 127;
  const int q0 = blockIdx.x * kApRows, b = blockIdx.y;
  const int d = heads * HD;
  const int n_kt = (n_valid + kApRows - 1) / kApRows;
  const int n_chunks = (d_out + kApN - 1) / kApN;
  const int n_kc = d / wg::kBox;

  if (tid == 0) {
    for (int s = 0; s < kApStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 1);
    }
    wg::bar_init(qbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (wg::warpgroup() == 1) {
    // producer: the Q rows of every head (D / 64 boxes), then (K, V) tile kt
    // of head h for every head in order, then Wp box (chunk c, k-step kc)
    // for every chunk
    if (t == 0) {
      wg::bar_expect_tx(qbar, n_kc * kApBox);
      for (int kc = 0; kc < n_kc; ++kc)
        fw::tma_load3(sO + kc * kApBox, &qkv_map, qbar, kc * wg::kBox, q0, b);
      int it = 0;
      for (int h = 0; h < heads; ++h)
        fw::load_kv_tiles<HD, kApStages>(ring, full, empty, it, &qkv_map, d + h * HD, &qkv_map,
                                         2 * d + h * HD, n_kt, b);
      for (int c = 0; c < n_chunks; ++c)
        for (int kc = 0; kc < n_kc; ++kc, ++it) {
          const int s = it % kApStages;
          wg::bar_wait(&empty[s], ((it / kApStages) & 1) ^ 1);
          wg::bar_expect_tx(&full[s], kWpBox);
          wg::tma_load(ring + s * kStage, &wp_map, &full[s], kc * wg::kBox, c * kApN);
        }
    }
  } else {
    const uint32_t sO_s = smem_addr(sO), ring_s = smem_addr(ring);
    const int row_a = q0 + wg::acc_row(t, 0), row_b = row_a + 8;  // this thread's rows
    wg::bar_wait(qbar, 0);
    int it = 0;
    for (int h = 0; h < heads; ++h) {
      float o[HD / 2], m_a, m_b, l_a, l_b;
      fw::attend_tiles<HD, kApStages>(o, m_a, m_b, l_a, l_b, sO_s + h * nb * kApBox, ring_s,
                                      full, empty, it, n_kt, n_valid, scale_log2, t);
      // normalise; lse; O_h (bf16) over Q_h
      uint8_t* obox = sO + h * nb * kApBox;
      fw::finish_rows(o, m_a, m_b, l_a, l_b,
                      need_o ? lse_out + ((long long)b * heads + h) * n : nullptr, row_a, row_b,
                      n, obox, t);
      if (need_o && t == 0) {
        for (int j = 0; j < nb; ++j)
          fw::tma_store3(&o_map, obox + j * kApBox, h * HD + j * wg::kBox, q0, b);
        wg::tma_store_commit();
      }
    }

    // xo = O Wp^T + bp (+ x_res), 128 output columns at a time
    for (int c = 0; c < n_chunks; ++c) {
      float acc[64];
      for (int kc = 0; kc < n_kc; ++kc, ++it) {
        const int s = it % kApStages;
        wg::bar_wait(&full[s], (it / kApStages) & 1);
        const uint32_t st = wg::opaque(ring_s) + s * kStage;
        const uint32_t oa = wg::opaque(sO_s) + kc * kApBox;
        wg::mma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          wg::mma_m64n128<0, 0>(acc, wg::desc_k(oa, k4), wg::desc_k(st, k4), kc + k4 > 0);
        wg::mma_commit();
        wg::mma_wait<0>();
        if (t == 0) wg::bar_arrive(&empty[s]);
      }
      wg::acc_fence(acc);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = (i >> 1) & 1 ? row_b : row_a;
        const int col = c * kApN + wg::acc_col(t, i);
        if (row < n && col < d_out) {
          const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(bp + col));
          float v0 = acc[i] + bb.x, v1 = acc[i + 1] + bb.y;
          const long long gi = ((long long)b * n + row) * d_out + col;
          if (x_res != nullptr) {
            const float2 xr = unpack_bf16(*reinterpret_cast<const uint32_t*>(x_res + gi));
            v0 += xr.x;
            v1 += xr.y;
          }
          *reinterpret_cast<uint32_t*>(xo + gi) = pack_bf16(v0, v1);
        }
      }
    }
    if (need_o && t == 0) wg::tma_store_wait();
  }
}

template <int HD>
cudaError_t launch_ap_fwd(const void* qkv, const void* x_res, const void* wp, const void* bp,
                          void* o, void* lse, void* xo, int batch, int n, int heads, int d_out,
                          int n_valid, float sm_scale, cudaStream_t st) {
  const int d = heads * HD;
  CUtensorMap qkv_map, wp_map, o_map;
  cudaError_t err;
  if ((err = tensor_map3(&qkv_map, qkv, batch, n, 3 * d, kApRows, 3 * d)) != cudaSuccess ||
      (err = tensor_map(&wp_map, wp, d_out, d, kApN)) != cudaSuccess)
    return err;
  if (o != nullptr) {
    if ((err = tensor_map3(&o_map, o, batch, n, d, kApRows, d)) != cudaSuccess) return err;
  } else {
    o_map = qkv_map;  // never read
  }
  const int smem = ap_smem(heads, HD);
  if ((err = cudaFuncSetAttribute(ap_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  ap_fwd_kernel<HD><<<dim3(n / kApRows, batch), kApThreads, smem, st>>>(
      qkv_map, wp_map, o_map, static_cast<const __nv_bfloat16*>(x_res),
      static_cast<const __nv_bfloat16*>(bp), static_cast<float*>(lse),
      static_cast<__nv_bfloat16*>(xo), n, heads, d_out, n_valid, sm_scale * fw::kLog2e,
      o != nullptr);
  return cudaGetLastError();
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Head width DH 64 or 128.
// Shapes: qkv (B, N, 3*H*DH), x_res and xo (B, N, D_out) or x_res NULL, wp (D_out, H*DH) in nn.Linear
// layout, bp (D_out,), o (B, N, H*DH) or NULL; all bf16 and contiguous; lse
// (B, H, N) f32, written when o is.
// Returns a cudaError_t: the launch's (or a TMA descriptor's), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int dcvit_attend_project_fwd(const void* qkv, const void* x_res, const void* wp,
                                        const void* bp, void* o, void* lse, void* xo, int batch,
                                        int n, int heads, int head_dim, int d_out, int n_valid,
                                        float sm_scale, void* stream) {
  using namespace dcvit;
  if (!fw::head_width_built(head_dim) || heads < 1 || ap_smem(heads, head_dim) > kMaxSmem ||
      n % kApRows != 0 || d_out % 64 != 0 || n_valid < 1 || n_valid > n || batch < 1 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  auto launch = head_dim == 64 ? launch_ap_fwd<64> : launch_ap_fwd<128>;
  return (int)launch(qkv, x_res, wp, bp, o, lse, xo, batch, n, heads, d_out, n_valid, sm_scale,
                     static_cast<cudaStream_t>(stream));
}
