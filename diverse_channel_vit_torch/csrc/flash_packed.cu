// flash_packed forward: masked multi-head attention on lane-packed
// (B, N, H * 64) q, k and v, with no projection.
//
// Replaces the TPU kernel `_packed_fwd_kernel`
// (diverse_channel_vit_tpu/ops/attention.py:243), reached through
// `_packed_fwd_impl` (:268) and `flash_attention_packed` (:426).
//
// What bounds it on an H100: operations. The function does
// 4 * B * n_valid^2 * D FLOP of bf16 products (the TPU kernel's
// `CostEstimate`, :288, counted over the real keys); at the DiChaViT-S
// flagship (B = 64, n_valid = 1569, D = 384) that is 242 GFLOP, 0.245 ms at
// 989 TFLOP/s, against 308 MB of compulsory traffic (q, k, v read once, o
// written once), 0.092 ms at 3.35 TB/s.
//
// Design, and what differs from the TPU kernel:
// - The TPU kept each batch row's whole K and V resident in VMEM (:279-280).
//   One head's K+V at N = 1600 is 400 KB, above the 227 KB of shared memory
//   a block may use, so one block owns one (64-query tile, head, image) and
//   streams K/V through a double-buffered cp.async ring in 64-key tiles with
//   an online softmax (`flash_fwd_tile`, flash_tiles.cuh, the loop of the
//   attend_project forward, B1). The TPU normalised once after the P.V
//   product; so does this kernel, against the final running sum.
// - Without B1's output projection a block needs only 46 KB of shared
//   memory, so several blocks share an SM and the grid (N / 64 x H x B)
//   spreads one image's heads over the card.
// - q, k and v come as strided views (rows `sq`, `sk`, `sv` elements apart),
//   so the thirds of the packed qkv GEMM output go in without a copy. o is
//   written contiguous, (B, N, D). With `lse` the kernel also writes each
//   row's per-head log-sum-exp of the scaled scores (f32), which the
//   backward (flash_packed_bwd.cu) uses to recompute P tile by tile.
#include "flash_tiles.cuh"

namespace dcvit {

// Grid (N / 64, heads, B).
template <int DH>
__global__ void __launch_bounds__(kFThreads)
    flash_packed_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int n, long long sq, long long sk,
                            long long sv, int n_valid, float scale_log2) {
  const int heads = gridDim.y;
  const int d = heads * DH;
  const int q0 = blockIdx.x * kFRows, h = blockIdx.y, b = blockIdx.z;
  const int hc = h * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = warp * 16 + g, row_b = row_a + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long img = (long long)b * n;
  float o_acc[DH / 8][4];
  float lse_a, lse_b;
  flash_fwd_tile<DH>(q + (img + q0) * sq + hc, sq, k + img * sk + hc, sk, v + img * sv + hc, sv,
                     n_valid, scale_log2, reinterpret_cast<__nv_bfloat16*>(smem_raw), o_acc,
                     lse_a, lse_b);

  if (lse != nullptr && t4 == 0) {
    float* lrow = lse + ((long long)b * heads + h) * n + q0;
    lrow[row_a] = lse_a;
    lrow[row_b] = lse_b;
  }
  __nv_bfloat16* orow = o + (img + q0) * d + hc;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(orow + (long long)row_a * d + col) =
        pack_bf16(o_acc[j][0], o_acc[j][1]);
    *reinterpret_cast<uint32_t*>(orow + (long long)row_b * d + col) =
        pack_bf16(o_acc[j][2], o_acc[j][3]);
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). q, k, v: (B, N, H * head_dim)
// bf16 views whose rows are contiguous and 16-byte aligned, rows `stride_*`
// elements apart and images N rows apart; o (B, N, H * head_dim) bf16
// contiguous; lse (B, H, N) f32 contiguous, or NULL. Returns a cudaError_t:
// the launch's, or cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int dcvit_flash_packed_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int batch, int n, int heads, int head_dim,
                                      long long stride_q, long long stride_k, long long stride_v,
                                      int n_valid, float sm_scale, void* stream) {
  using namespace dcvit;
  const long long d = (long long)heads * head_dim;
  if (head_dim != 64 || n % kFRows != 0 || n_valid < 1 || n_valid > n || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535 || stride_q < d || stride_k < d ||
      stride_v < d || (stride_q | stride_k | stride_v) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(__nv_bfloat16) * flash_fwd_smem_elems<64>();
  auto kernel = flash_packed_fwd_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n / kFRows, heads, batch), kFThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), n, stride_q, stride_k, stride_v, n_valid, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
