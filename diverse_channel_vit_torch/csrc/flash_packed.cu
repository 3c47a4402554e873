// flash_packed forward: masked multi-head attention on lane-packed
// (B, N, H * dh) q, k and v (head width dh 64 or 128), with no projection.
//
// Replaces the TPU kernel `_packed_fwd_kernel`
// (diverse_channel_vit_tpu/ops/attention.py:243), reached through
// `_packed_fwd_impl` (:268) and `flash_attention_packed` (:426).
//
// What bounds it on an H100: operations, of two kinds. The function does
// 4 * B * n_valid^2 * D FLOP of bf16 products (the TPU kernel's
// `CostEstimate`, :288, counted over the real keys); at the DiChaViT-S
// flagship (B = 64, n_valid = 1569, D = 384) that is 242 GFLOP, 0.245 ms at
// 989 TFLOP/s, beside 9.45e8 exponentials, about 0.24 ms at the
// special-function units' ~3.9 T exp2/s, against 308 MB of compulsory
// traffic (q, k, v read once, o written once), 0.092 ms at 3.35 TB/s.
//
// Design (flash_packed.cuh on flash_wgmma.cuh and wgmma_core.cuh): the
// attend_project forward's (B1's) tile loop, one head a block, without the
// projection; the benchmark scripts' qkv_flash forward (S2) launches the same
// kernel on one packed qkv map.
// - The TPU kept each batch row's whole K and V resident in VMEM (:279-280).
//   One head's K+V at N = 1600 is 400 KB, above the 227 KB of shared memory
//   a block may use, so K/V stream by TMA through a three-stage mbarrier
//   ring in tiles of 64 keys, fed by a producer warp, with an online softmax
//   (`fw::attend_tiles`). S = Q K^T is a `wgmma` m64n64 from shared memory;
//   P, rounded to bf16 against the running max, is the register A operand
//   of O += P V, and tile kt's S is issued together with tile kt-1's P V.
//   The scale is folded into each `ex2`; the row is normalised once at the
//   end, as the TPU divided its unnormalised P V by the row sum.
// - A block owns (64 query rows, head, image): one consumer warpgroup and a
//   producer warp. At head width 64, 57 KB of shared memory and (ptxas,
//   nvcc 12.9) 106 registers a thread, three blocks share an SM, so one
//   block's exponentials run while another's products do; at 128, two
//   ring stages of 32 KB keep two blocks an SM (81 KB). The grid (N / 64, H, B)
//   keeps the card full at the small EViT grids too (4608 blocks at N = 768,
//   against B1's 768 all-heads blocks).
// - q, k and v come as strided views, each through a rank-3 TMA map
//   (columns, rows, images) with its own row stride, so the thirds of the
//   packed qkv GEMM output, or three tensors of their own, go in without a
//   copy and a box never reads past its image. O, rounded to bf16, replaces
//   Q in the Q box and leaves by TMA store into a contiguous (B, N, D) o.
//   With `lse` the kernel also writes each row's per-head log-sum-exp of
//   the scaled scores (f32), which the backward (flash_packed_bwd.cu) uses to
//   recompute P tile by tile.
#include "flash_packed.cuh"

// Plain C entry point (loaded with ctypes). head_dim 64 or 128. q, k, v:
// (B, N, H * head_dim)
// bf16 views whose rows are contiguous and 16-byte aligned, rows `stride_*`
// elements apart (a multiple of 8) and images N rows apart; o
// (B, N, H * head_dim) bf16 contiguous; lse (B, H, N) f32 contiguous, or
// NULL. Returns a cudaError_t: the launch's (or a TMA descriptor's), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int dcvit_flash_packed_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int batch, int n, int heads, int head_dim,
                                      long long stride_q, long long stride_k, long long stride_v,
                                      int n_valid, float sm_scale, void* stream) {
  using namespace dcvit;
  const long long d = (long long)heads * head_dim;
  if (!fw::head_width_built(head_dim) || n % fw::kWgRows != 0 || n_valid < 1 || n_valid > n || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535 || stride_q < d || stride_k < d ||
      stride_v < d || (stride_q | stride_k | stride_v) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map, o_map;
  cudaError_t err;
  if ((err = tensor_map3(&q_map, q, batch, n, (int)d, fw::kWgRows, stride_q)) != cudaSuccess ||
      (err = tensor_map3(&k_map, k, batch, n, (int)d, fw::kWgRows, stride_k)) != cudaSuccess ||
      (err = tensor_map3(&v_map, v, batch, n, (int)d, fw::kWgRows, stride_v)) != cudaSuccess ||
      (err = tensor_map3(&o_map, o, batch, n, (int)d, fw::kWgRows, d)) != cudaSuccess)
    return (int)err;
  auto launch = head_dim == 64 ? launch_flash_fwd<true, 64> : launch_flash_fwd<true, 128>;
  return (int)launch(q_map, k_map, v_map, o_map, 0, 0, 0, static_cast<float*>(lse), batch, n,
                     heads, n_valid, sm_scale, static_cast<cudaStream_t>(stream));
}
