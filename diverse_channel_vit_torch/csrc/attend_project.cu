// attend_project forward: masked multi-head attention over a packed qkv
// tensor, then the output projection, its bias and the residual, in two
// launches on the caller's stream.
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
// ~3.9 T exp2/s). At D = 768 (12 heads of 64) the products double.
//
// The TPU kernel kept one image's rows and every head in VMEM and projected
// from there. On the card a block that holds the Q (then O) boxes of every
// head beside its K/V ring needs 97 KB at 6 x 64 and 145 KB at 12 x 64 or
// 3 x 128: at most two blocks an SM, each running its heads one after
// another, and every block streams all of Wp again (1.9 GB of L2 reads a
// call at D = 768). That design lost to the two launches below at every
// shape and grid measured but the DCS recipe's smallest (N = 256, 64
// images: 0.057 ms against 0.070), so B1 is:
// - (a) the attention: B5's forward, `flash_packed_fwd_kernel<true, HD>`
//   (flash_packed.cuh on flash_wgmma.cuh), one block per (64 query rows,
//   head, image) on one rank-3 map over the packed qkv at columns 0, D and
//   2D, as the scripts' S2 runs it. K/V stream by TMA through an mbarrier
//   ring in tiles of 64 keys, fed by a producer warp, with an online
//   softmax; key tiles at or past `n_valid` are skipped (the tile loop is
//   `fw::attend_tiles`). It writes O (B, N, D) bf16 to device memory,
//   scratch the caller passes in, and each row's per-head log-sum-exp of
//   the scaled scores, `lse`, f32, when the caller asks for it (a backward
//   pass: attend_project_bwd.cu reads o and lse). Its blocks hold one
//   head's Q (then O) boxes and a ring: 57 KB at head width 64 (three an
//   SM), 81 KB with two stages at 128 (two).
// - (b) the projection: xo = O Wp^T + bp (+ x_res) on the persistent
//   128 x 256-tile GEMM of ln_mlp_gemm.cuh, `gemm_kernel<EpiBiasResidual>`
//   (B3's fc2 at D = 768): A is O, (B N) x D, B is Wp in its nn.Linear
//   layout, multicast to clusters of two row tiles; x_res comes by TMA in
//   the epilogue; bias and residual are added in f32 and rounded once.
//   Output columns past D_out (D_out a multiple of 64, not of 256) are
//   clipped by the stores and read no bias or residual.
// - xo, o and the lse equal, bit for bit, what the one-launch kernel gave
//   (the same tile loop, the products summed in the same order).
// - What bounds each launch at B = 64, N = 1600: (a) operations, 4 B N
//   n_valid D bf16 FLOP and B H N n_valid exponentials; (b) bytes at D =
//   768 (O and x_res read, xo written: 472 MB, 0.14 ms at 3.35 TB/s against
//   0.12 ms of products) and at D = 384 (236 MB, 0.07 ms).
// - O is written to device memory and read back: 78 MB at the flagship's
//   B = 64, 157 MB at D = 768.
// - ptxas (nvcc 12.9, sm_90a): (a) 106 registers at head width 64 and 138
//   at 128, no spill; (b) 168 registers and 68 bytes of spill stores, as in
//   ln_mlp.cu.
// - On an H100 80GB HBM3 at 700 W, B = 64, N = 1600 (n_valid 1569): 6 x 64
//   0.69 ms (attention 0.53, projection 0.14) where the one-launch kernel
//   took 0.81 and one PyTorch composition (SDPA, `F.linear`, the add) 1.21;
//   12 x 64 1.35 ms (1.06 and 0.27) where it took 2.59 and PyTorch 2.47;
//   3 x 128 0.69 ms (0.54 and 0.14) where it took 0.89 and PyTorch 0.85.
// - Rows past N load as zeros and are clipped by TMA stores.
#include "flash_packed.cuh"
#include "ln_mlp_gemm.cuh"

namespace dcvit {

// (a) B5's forward on the packed qkv, O (and the lse) to device memory;
// (b) xo = O Wp^T + bp (+ x_res) on the persistent GEMM.
template <int HD>
cudaError_t launch_ap(const void* qkv, const void* x_res, const void* wp, const void* bp, void* o,
                      void* lse, void* xo, int batch, int n, int heads, int d_out, int n_valid,
                      float sm_scale, cudaStream_t st) {
  const int d = heads * HD;
  const long long m = (long long)batch * n;
  EpiBiasResidual::Params p;
  CUtensorMap qkv_map, o_map, a_map, b_map, c_map;
  cudaError_t err;
  if ((err = tensor_map3(&qkv_map, qkv, batch, n, 3 * d, fw::kWgRows, 3LL * d)) != cudaSuccess ||
      (err = tensor_map3(&o_map, o, batch, n, d, fw::kWgRows, d)) != cudaSuccess ||
      (err = tensor_map(&a_map, o, m, d, gm::kTileM)) != cudaSuccess ||
      (err = tensor_map(&b_map, wp, d_out, d, gm::kTileN / 2)) != cudaSuccess ||
      (err = tensor_map(&c_map, xo, m, d_out, wg::kBox)) != cudaSuccess ||
      (err = tensor_map(&p.x_map, x_res != nullptr ? x_res : xo, m, d_out, wg::kBox)) !=
          cudaSuccess)
    return err;
  if ((err = launch_flash_fwd<true, HD>(qkv_map, qkv_map, qkv_map, o_map, 0, d, 2 * d,
                                        static_cast<float*>(lse), batch, n, heads, n_valid,
                                        sm_scale, st)) != cudaSuccess)
    return err;
  p.b2 = static_cast<const __nv_bfloat16*>(bp);
  p.n = d_out;
  p.residual = x_res != nullptr;  // else x_map is never read
  return launch_gemm<EpiBiasResidual, false>(a_map, b_map, c_map, p, m, d_out, d, st);
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes).
//
// Head width DH 64 or 128. Shapes: qkv (B, N, 3*H*DH), x_res and xo (B, N,
// D_out) or x_res NULL, wp (D_out, H*DH) in nn.Linear layout, bp (D_out,),
// o (B, N, H*DH), required (scratch the caller need not read); all bf16 and
// contiguous; lse (B, H, N) f32, written when given, or NULL.
// Returns a cudaError_t: the first failed launch's (or TMA descriptor's), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int dcvit_attend_project_fwd(const void* qkv, const void* x_res, const void* wp,
                                        const void* bp, void* o, void* lse, void* xo, int batch,
                                        int n, int heads, int head_dim, int d_out, int n_valid,
                                        float sm_scale, void* stream) {
  using namespace dcvit;
  if (!fw::head_width_built(head_dim) || heads < 1 || heads > 65535 || n % fw::kWgRows != 0 ||
      d_out % 64 != 0 || d_out < 64 || n_valid < 1 || n_valid > n || batch < 1 ||
      batch > 65535 || (long long)batch * n > 2147483647LL || o == nullptr)
    return (int)cudaErrorInvalidValue;
  auto launch = head_dim == 64 ? launch_ap<64> : launch_ap<128>;
  return (int)launch(qkv, x_res, wp, bp, o, lse, xo, batch, n, heads, d_out, n_valid, sm_scale,
                     static_cast<cudaStream_t>(stream));
}
