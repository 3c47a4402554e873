// qkv_flash forward: masked multi-head attention read from ONE packed
// (B, N, 3D) qkv tensor, with no projection and no log-sum-exp.
//
// Replaces the TPU kernel `_qkv_fwd_kernel`
// (scripts/bench_block_fusion.py:121), reached through `qkv_flash_fwd`
// (:145, call :151), the "v2" layout probe of that benchmark.
//
// What bounds it on an H100: operations, of two kinds. The function does
// 4 * B * N * n_valid * D FLOP of bf16 products (the TPU kernel's
// `CostEstimate`, :166, over the real keys); at the benchmark's defaults
// (B = 64, N = 1664, n_valid = 1569, D = 384) that is 257 GFLOP, 0.26 ms at
// 989 TFLOP/s, beside 64 x 6 x 1664 x 1569 = 1.0e9 exponentials, about
// 0.26 ms at the special-function units' ~3.9 T exp2/s, against 327 MB of
// compulsory traffic (qkv read once, o written once), 0.10 ms at 3.35 TB/s.
//
// Design: the package's flash_packed forward (B5) itself,
// `flash_packed_fwd_kernel<true>` (flash_packed.cuh, on the flash core
// flash_wgmma.cuh), launched on one rank-3 TMA map over the packed qkv
// (columns 3D, row stride 3D) at column offsets 0, D and 2D for q, k and v,
// with no lse. So S2 and B5 on the three views of one qkv load the same
// boxes and run the same instructions: their outputs agree bit for bit.
// - The TPU read q, k and v as lane blocks 0, 1 and 2 of the packed array
//   through BlockSpec index maps (:155-157); the column offsets are those
//   index maps. It held one image's whole K and V resident in VMEM; here one
//   head's K+V at N = 1664 is 416 KB, above the 227 KB of shared memory a
//   block may use, so K and V stream by TMA in 64-key tiles through a
//   three-stage ring with an online softmax.
// - The TPU's grid was (q tile, image), every head in one block. A block
//   here owns (64 query rows, head, image): one consumer warpgroup and a
//   producer warp, three blocks an SM, so one block's exponentials run
//   while another's products do. The first version (`mma.sync`) kept the
//   TPU's grid and ran the 6 heads one after another in one block of four
//   warps, with nothing to overlap its exponentials: 1.2 ms at the defaults
//   on an H100 against B5's 0.57 on the same qkv (PERF.md §6).
// - o is written contiguous (B, N, D) by TMA; nothing else is written.
#include "flash_packed.cuh"

// Plain C entry point (loaded with ctypes). head_dim 64 or 128. qkv:
// (B, N, 3 * H * head_dim)
// bf16 contiguous, [q | k | v], 16-byte aligned; o: (B, N, H * head_dim)
// bf16 contiguous. Returns a cudaError_t: the launch's (or a TMA
// descriptor's), or cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int dcvit_qkv_flash_fwd(const void* qkv, void* o, int batch, int n, int heads,
                                   int head_dim, int n_valid, float sm_scale, void* stream) {
  using namespace dcvit;
  const int d = heads * head_dim;
  if (!fw::head_width_built(head_dim) || n < fw::kWgRows || n % fw::kWgRows != 0 || n_valid < 1 ||
      n_valid > n || batch < 1 || batch > 65535 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qkv_map, o_map;
  cudaError_t err;
  if ((err = tensor_map3(&qkv_map, qkv, batch, n, 3 * d, fw::kWgRows, 3LL * d)) != cudaSuccess ||
      (err = tensor_map3(&o_map, o, batch, n, d, fw::kWgRows, d)) != cudaSuccess)
    return (int)err;
  auto launch = head_dim == 64 ? launch_flash_fwd<true, 64> : launch_flash_fwd<true, 128>;
  return (int)launch(qkv_map, qkv_map, qkv_map, o_map, 0, d, 2 * d, nullptr, batch, n, heads,
                     n_valid, sm_scale, static_cast<cudaStream_t>(stream));
}
