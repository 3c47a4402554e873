// flash_packed backward: given do, the gradients dq, dk and dv of the
// forward in flash_packed.cu.
//
// Replaces the TPU kernel `_packed_bwd_kernel`
// (diverse_channel_vit_tpu/ops/attention.py:297), reached through
// `_packed_bwd_impl` (:358) and `_flash_packed_vjp_bwd` (:418).
//
// What bounds it on an H100: operations. The TPU kernel's `CostEstimate`
// (:398-402) counts 10 * B * N^2 * D FLOP, about 2.5 times the forward's;
// over the real keys the products below are 2.5 * 4 * B * n_valid^2 * D =
// 605 GFLOP at the DiChaViT-S flagship (B = 64, n_valid = 1569, D = 384),
// 0.612 ms at 989 TFLOP/s, against 617 MB of compulsory traffic (q, k, v, o,
// do read once, dq, dk, dv written once; the lse read is 2.4 MB), 0.18 ms at
// 3.35 TB/s.
//
// Design, and what differs from the TPU kernel:
// - The TPU ran grid (b, q-block) with the whole K/V row resident in VMEM
//   and accumulated dk and dv in f32 VMEM scratch across a sequential q axis
//   (:304-356), recomputing the softmax's max and sum. Here K+V of one head
//   (400 KB at N = 1600) does not fit a block's shared memory, and blocks run
//   in no order, so the work splits FlashAttention-2 style into three passes,
//   with no float atomics (the split of the attend_project backward, B2,
//   without its output projection and bias sums):
//   (a) `flash_bwd_di_kernel`, row-parallel: di = rowsum(o_h * do_h) per
//       head, in f32;
//   (b) `flash_bwd_kv_kernel`, one block per (64-key tile, head, image),
//       looping over every query tile (`flash_bwd_kv_tile`, flash_tiles.cuh):
//       P^T = exp(S^T * scale - lse) from the forward's log-sum-exp, in place
//       of the recomputed max and sum (the same P up to f32 rounding);
//       dv += P^T dO and dk += dS^T Q in registers, written once;
//   (c) `flash_bwd_q_kernel`, one block per (64-query tile, head, image),
//       looping over the valid key tiles (`flash_bwd_q_tile`): dq = dS K.
// - Keys at or past `n_valid` get P = 0 exactly, so their dk and dv rows come
//   out exactly 0 (key tiles wholly past `n_valid` are written as zeros):
//   the qkv GEMM's weight gradient sums over every row, padded ones too.
// - P and dS are rounded to bf16 before their products, as on the TPU; all
//   accumulators are f32. q, k and v come as strided views; dq, dk and dv are
//   written into one (B, N, 3D) buffer, [dq | dk | dv], the layout the qkv
//   GEMM's backward reads.
#include "flash_tiles.cuh"

namespace dcvit {

constexpr int kDiRows = 8;  // rows per block of the di pass, one per warp

// (a) di[b, h, r] = sum over the head's columns of o * do, f32. Grid
// (B * N / 8), 256 threads.
template <int DH>
__global__ void __launch_bounds__(32 * kDiRows)
    flash_bwd_di_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
                        float* __restrict__ di, int n, int heads) {
  static_assert(DH == 64, "one bf16 pair per lane and head");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kDiRows + warp;  // b * n + r
  const long long b = row / n, r = row - b * n;
  const int d = heads * DH;
  for (int h = 0; h < heads; ++h) {
    const long long off = row * d + h * DH + lane * 2;
    const float2 ov = unpack_bf16(*reinterpret_cast<const uint32_t*>(o + off));
    const float2 dv = unpack_bf16(*reinterpret_cast<const uint32_t*>(dO + off));
    const float s = warp_sum(ov.x * dv.x + ov.y * dv.y);
    if (lane == 0) di[(b * heads + h) * n + r] = s;
  }
}

// (b) dk and dv. Grid (N / 64, heads, B).
template <int DH>
__global__ void __launch_bounds__(kFThreads)
    flash_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        __nv_bfloat16* __restrict__ grads, int n, long long sq, long long sk,
                        long long sv, int n_valid, float scale_log2, float sm_scale) {
  const int heads = gridDim.y;
  const int d = heads * DH;
  const int k0 = blockIdx.x * kFRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hc = h * DH;
  const long long img = (long long)b * n, sg = 3LL * d;
  __nv_bfloat16* dk_out = grads + img * sg + d + hc;
  __nv_bfloat16* dv_out = dk_out + d;

  if (k0 >= n_valid) {  // wholly padded key tile: exact zeros
    for (int i = tid; i < kFRows * DH / 2; i += kFThreads) {
      const int r = i / (DH / 2), c = (i - r * (DH / 2)) * 2;
      const long long off = (long long)(k0 + r) * sg + c;
      *reinterpret_cast<uint32_t*>(dk_out + off) = 0u;
      *reinterpret_cast<uint32_t*>(dv_out + off) = 0u;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float dk[DH / 8][4], dv[DH / 8][4];
  const long long stat = ((long long)b * heads + h) * n;
  flash_bwd_kv_tile<DH>(q + img * sq + hc, sq, k + (img + k0) * sk + hc, sk,
                        v + (img + k0) * sv + hc, sv, dO + img * d + hc, d, lse + stat,
                        di + stat, n, k0, n_valid, scale_log2, sm_scale, smem_raw, dk, dv);

  const long long key_a = k0 + warp * 16 + g, key_b = key_a + 8;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dk_out + key_a * sg + col) = pack_bf16(dk[j][0], dk[j][1]);
    *reinterpret_cast<uint32_t*>(dk_out + key_b * sg + col) = pack_bf16(dk[j][2], dk[j][3]);
    *reinterpret_cast<uint32_t*>(dv_out + key_a * sg + col) = pack_bf16(dv[j][0], dv[j][1]);
    *reinterpret_cast<uint32_t*>(dv_out + key_b * sg + col) = pack_bf16(dv[j][2], dv[j][3]);
  }
}

// (c) dq. Grid (N / 64, heads, B).
template <int DH>
__global__ void __launch_bounds__(kFThreads)
    flash_bwd_q_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       __nv_bfloat16* __restrict__ grads, int n, long long sq, long long sk,
                       long long sv, int n_valid, float scale_log2, float sm_scale) {
  const int heads = gridDim.y;
  const int d = heads * DH;
  const int q0 = blockIdx.x * kFRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hc = h * DH;
  const long long img = (long long)b * n, sg = 3LL * d;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float dq[DH / 8][4];
  const long long stat = ((long long)b * heads + h) * n + q0;
  flash_bwd_q_tile<DH>(q + (img + q0) * sq + hc, sq, k + img * sk + hc, sk, v + img * sv + hc,
                       sv, dO + (img + q0) * d + hc, d, lse + stat, di + stat, n_valid, scale_log2,
                       sm_scale, smem_raw, dq);

  __nv_bfloat16* drow = grads + (img + q0) * sg + hc;
  const long long row_a = warp * 16 + g, row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(drow + row_a * sg + col) = pack_bf16(dq[j][0], dq[j][1]);
    *reinterpret_cast<uint32_t*>(drow + row_b * sg + col) = pack_bf16(dq[j][2], dq[j][3]);
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). q, k, v: (B, N, H * head_dim)
// bf16 views whose rows are contiguous and 16-byte aligned, rows `stride_*`
// elements apart and images N rows apart; o and dout (B, N, H * head_dim)
// bf16 contiguous; lse and di (B, H, N) f32 contiguous (di is scratch);
// grads (B, N, 3 * H * head_dim) bf16 contiguous, written as [dq | dk | dv].
// Returns a cudaError_t: the first failed launch's, or cudaErrorInvalidValue
// for a shape the kernels do not take.
extern "C" int dcvit_flash_packed_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* grads, void* di,
                                      int batch, int n, int heads, int head_dim,
                                      long long stride_q, long long stride_k, long long stride_v,
                                      int n_valid, float sm_scale, void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  const long long d = (long long)heads * head_dim;
  if (head_dim != 64 || n % kFRows != 0 || n_valid < 1 || n_valid > n || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535 || stride_q < d || stride_k < d ||
      stride_v < d || (stride_q | stride_k | stride_v) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = sm_scale * kLog2e;
  const dim3 grid(n / kFRows, heads, batch);

  flash_bwd_di_kernel<64><<<(unsigned)((long long)batch * n / kDiRows), 32 * kDiRows, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(di), n,
      heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv = flash_bwd_kv_kernel<64>;
  const int kv_smem = flash_bwd_kv_smem_bytes<64>();
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return (int)err;
  kv<<<grid, kFThreads, kv_smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(grads), n, stride_q, stride_k, stride_v,
      n_valid, scale_log2, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto qk = flash_bwd_q_kernel<64>;
  const int q_smem = flash_bwd_q_smem_bytes<64>();
  err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return (int)err;
  qk<<<grid, kFThreads, q_smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(grads), n, stride_q, stride_k, stride_v,
      n_valid, scale_log2, sm_scale);
  return (int)cudaGetLastError();
}
