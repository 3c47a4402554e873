// qkv_flash forward: masked multi-head attention read from ONE packed
// (B, N, 3D) qkv tensor, with no projection and no log-sum-exp.
//
// Replaces the TPU kernel `_qkv_fwd_kernel`
// (scripts/bench_block_fusion.py:121), reached through `qkv_flash_fwd`
// (:145, call :151), the "v2" layout probe of that benchmark.
//
// What bounds it on an H100: operations. The function does
// 4 * B * N * n_valid * D FLOP of bf16 products (the TPU kernel's
// `CostEstimate`, :166, over the real keys); at the benchmark's defaults
// (B = 64, N = 1664, n_valid = 1569, D = 384) that is 257 GFLOP, 0.26 ms at
// 989 TFLOP/s, against 327 MB of compulsory traffic (qkv read once, o
// written once), 0.10 ms at 3.35 TB/s.
//
// Design, and what differs from the TPU kernel:
// - The TPU read q, k and v as lane blocks 0, 1 and 2 of the packed array
//   through BlockSpec index maps (:155-157), with one image's whole K and V
//   resident in VMEM. Here the block computes the three column offsets (0,
//   D, 2D) itself and streams K/V in 64-key tiles with an online softmax
//   (`flash_fwd_tile`, flash_tiles.cuh, the loop of the flash_packed
//   forward): one head's K+V at N = 1664 is 416 KB, above the
//   227 KB of shared memory a block may use.
// - The grid is the TPU's, (q tile, image), and the heads loop inside the
//   block, one after the other through the same 46 KB of shared memory. The
//   package's flash_packed forward (B5, flash_packed.cu) spreads the heads
//   over the grid instead, (q tile, head, image), so the two time the same
//   arithmetic on two schedules.
// - o is written contiguous (B, N, D); nothing else is written.
#include "flash_tiles.cuh"

namespace dcvit {

// Grid (N / 64, B).
template <int DH>
__global__ void __launch_bounds__(kFThreads)
    qkv_flash_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ o,
                         int n, int heads, int n_valid, float scale_log2) {
  const int d = heads * DH;
  const long long s3 = 3LL * d;
  const int q0 = blockIdx.x * kFRows, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long row_a = warp * 16 + g, row_b = row_a + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long img = (long long)b * n;
  const __nv_bfloat16* qrow = qkv + (img + q0) * s3;
  const __nv_bfloat16* krow = qkv + img * s3 + d;
  const __nv_bfloat16* vrow = krow + d;
  __nv_bfloat16* orow = o + (img + q0) * d;
  for (int h = 0; h < heads; ++h) {
    const int hc = h * DH;
    float acc[DH / 8][4];
    float lse_a, lse_b;  // not written
    flash_fwd_tile<DH>(qrow + hc, s3, krow + hc, s3, vrow + hc, s3, n_valid, scale_log2,
                       reinterpret_cast<__nv_bfloat16*>(smem_raw), acc, lse_a, lse_b);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = hc + j * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(orow + row_a * d + col) = pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(orow + row_b * d + col) = pack_bf16(acc[j][2], acc[j][3]);
    }
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). qkv: (B, N, 3 * H * head_dim)
// bf16 contiguous, [q | k | v]; o: (B, N, H * head_dim) bf16 contiguous.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int dcvit_qkv_flash_fwd(const void* qkv, void* o, int batch, int n, int heads,
                                   int head_dim, int n_valid, float sm_scale, void* stream) {
  using namespace dcvit;
  if (head_dim != 64 || n < kFRows || n % kFRows != 0 || n_valid < 1 || n_valid > n ||
      batch < 1 || batch > 65535 || heads < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(__nv_bfloat16) * flash_fwd_smem_elems<64>();
  auto kernel = qkv_flash_fwd_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n / kFRows, batch), kFThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(o), n, heads, n_valid,
      sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
