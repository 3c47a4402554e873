// attend_project forward: masked multi-head attention over a packed qkv
// tensor, then the output projection, its bias and the residual, in one
// launch.
//
// Replaces the TPU kernel `_ap_fwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:671), reached through
// `_ap_fwd_impl` and `attend_project`.
//
// What bounds it on an H100: operations. Per image and layer at the
// DiChaViT-S flagship (N = 1600 padded from 1569, D = 384, 6 heads of 64)
// the function does about 4.3 GFLOP of bf16 products against about 6.4 MB of
// compulsory traffic (qkv, x_res and Wp read once, xo written once), some
// 670 FLOP per byte, above the card's ~295 FLOP/byte ridge.
//
// Design, and what differs from the TPU kernel:
// - The TPU kept each batch row's whole K and V resident in VMEM. Here K+V of
//   one head at N = 1600 is 400 KB, above the 227 KB of shared memory a block
//   may use, so K/V stream through a double-buffered cp.async ring in tiles of
//   64 keys with an online softmax (running max and sum in f32). Key tiles at
//   or past `n_valid` are skipped; columns of the last tile at or past it are
//   masked. The softmax normalises once at the end, where the TPU divided the
//   unnormalised P.V by the row sum.
// - One block owns 64 query rows of one image and loops over all heads, so
//   the concatenated head outputs O (64 x D bf16, 48 KB at D = 384) stay in
//   shared memory and feed the output projection directly: O never goes to
//   device memory unless the caller asks for it (`o`, needed only by a
//   backward pass). With `o` the kernel also writes each row's per-head
//   log-sum-exp of the scaled scores (`lse`, f32), which the backward
//   (attend_project_bwd.cu) uses to recompute P one key tile at a time.
// - Wp (D_out x D bf16, 288 KB) cannot be resident either: the projection
//   streams 64 x 64 tiles of it through the same ring, reusing the K/V
//   buffers, and adds bp and x_res in f32 before the single bf16 rounding.
// - All products are bf16 `mma.sync.m16n8k16` with f32 accumulation; each of
//   the four warps owns 16 query rows, so the softmax statistics never leave
//   registers (only quad shuffles). wgmma and TMA are later work.
// - The attention loop is `flash_fwd_tile` (flash_tiles.cuh), shared with the
//   flash_packed forward (flash_packed.cu).
#include "flash_tiles.cuh"

namespace dcvit {

constexpr int kAPWTile = 64;    // Wp tile edge (output columns x D)

template <int DH>
__host__ __device__ constexpr int ap_smem_elems(int d) {
  return flash_fwd_smem_elems<DH>() + kFRows * padded(d);
}

template <int DH>
__global__ void __launch_bounds__(kFThreads)
    attend_project_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const __nv_bfloat16* __restrict__ x_res,
                              const __nv_bfloat16* __restrict__ wp,
                              const __nv_bfloat16* __restrict__ bp,
                              __nv_bfloat16* __restrict__ o_out, float* __restrict__ lse_out,
                              __nv_bfloat16* __restrict__ xo, int n, int heads, int d_out,
                              int n_valid, float scale_log2) {
  static_assert(4 * kFRows * padded(DH) >= 2 * kAPWTile * padded(kAPWTile),
                "the Wp tiles reuse the K/V buffers");
  const int d = heads * DH;
  const int q0 = blockIdx.x * kFRows;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = warp * 16 + g;  // this thread's two rows in the tile
  const int row_b = row_a + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SD = padded(d);
  __nv_bfloat16* sAttn = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sAttn + flash_fwd_smem_elems<DH>();
  __nv_bfloat16* sW = sAttn + kFRows * padded(DH);  // the K/V ring, once attention is done

  const long long row3 = 3LL * d;
  const __nv_bfloat16* base = qkv + (long long)b * n * row3;

  for (int h = 0; h < heads; ++h) {
    const int hc = h * DH;
    float o_acc[DH / 8][4];
    float lse_a, lse_b;
    flash_fwd_tile<DH>(base + (long long)q0 * row3 + hc, row3, base + d + hc, row3,
                       base + 2 * d + hc, row3, n_valid, scale_log2, sAttn, o_acc, lse_a, lse_b);
    if (lse_out != nullptr && t4 == 0) {
      float* lrow = lse_out + ((long long)b * heads + h) * n + q0;
      lrow[row_a] = lse_a;
      lrow[row_b] = lse_b;
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = hc + j * 8 + t4 * 2;
      const uint32_t va = pack_bf16(o_acc[j][0], o_acc[j][1]);
      const uint32_t vb = pack_bf16(o_acc[j][2], o_acc[j][3]);
      *reinterpret_cast<uint32_t*>(sO + row_a * SD + col) = va;
      *reinterpret_cast<uint32_t*>(sO + row_b * SD + col) = vb;
      if (o_out != nullptr) {
        const long long ga = ((long long)b * n + q0 + row_a) * d + col;
        const long long gb = ((long long)b * n + q0 + row_b) * d + col;
        *reinterpret_cast<uint32_t*>(o_out + ga) = va;
        *reinterpret_cast<uint32_t*>(o_out + gb) = vb;
      }
    }
  }
  __syncthreads();  // O complete for all heads; K/V buffers free for Wp

  // xo = O Wp^T + bp (+ x_res), 64 output columns at a time
  constexpr int SW = padded(kAPWTile);
  const int n_kc = d / kAPWTile;
  for (int n0 = 0; n0 < d_out; n0 += kAPWTile) {
    float acc[kAPWTile / 8][4];
#pragma unroll
    for (int j = 0; j < kAPWTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const __nv_bfloat16* wrow = wp + (long long)n0 * d;
    load_tile_async(sW, wrow, kAPWTile, kAPWTile, d, tid, kFThreads);
    cp_async_commit();
    for (int kc = 0; kc < n_kc; ++kc) {
      const int buf = kc & 1;
      if (kc + 1 < n_kc) {
        load_tile_async(sW + (buf ^ 1) * kAPWTile * SW, wrow + (kc + 1) * kAPWTile, kAPWTile,
                        kAPWTile, d, tid, kFThreads);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* w_t = sW + buf * kAPWTile * SW;
#pragma unroll
      for (int kk = 0; kk < kAPWTile / 16; ++kk) {
        uint32_t a[4];
        load_a_frag(a, sO, SD, warp * 16, kc * kAPWTile + kk * 16, lane);
#pragma unroll
        for (int np = 0; np < kAPWTile / 16; ++np) {
          uint32_t bfr[4];
          load_b_frag_nk(bfr, w_t, SW, np * 16, kk * 16, lane);
          mma_bf16(acc[2 * np], a, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kAPWTile / 8; ++j) {
      const int col = n0 + j * 8 + t4 * 2;
      const float b0 = bf(bp[col]), b1 = bf(bp[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long gi = ((long long)b * n + q0 + row_a + half * 8) * d_out + col;
        float v0 = acc[j][2 * half] + b0, v1 = acc[j][2 * half + 1] + b1;
        if (x_res != nullptr) {
          const float2 xr = unpack_bf16(*reinterpret_cast<const uint32_t*>(x_res + gi));
          v0 += xr.x;
          v1 += xr.y;
        }
        *reinterpret_cast<uint32_t*>(xo + gi) = pack_bf16(v0, v1);
      }
    }
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: qkv (B, N, 3*H*DH),
// x_res and xo (B, N, D_out) or x_res NULL, wp (D_out, H*DH) in nn.Linear
// layout, bp (D_out,), o (B, N, H*DH) or NULL; all bf16 and contiguous; lse
// (B, H, N) f32, written when o is.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int dcvit_attend_project_fwd(const void* qkv, const void* x_res, const void* wp,
                                        const void* bp, void* o, void* lse, void* xo, int batch,
                                        int n, int heads, int head_dim, int d_out, int n_valid,
                                        float sm_scale, void* stream) {
  using namespace dcvit;
  if (head_dim != 64 || n % kFRows != 0 || d_out % kAPWTile != 0 || n_valid < 1 ||
      n_valid > n || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int d = heads * head_dim;
  const size_t smem = sizeof(__nv_bfloat16) * ap_smem_elems<64>(d);
  auto kernel = attend_project_fwd_kernel<64>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / kFRows, batch);
  kernel<<<grid, kFThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(x_res),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const __nv_bfloat16*>(bp),
      static_cast<__nv_bfloat16*>(o), o == nullptr ? nullptr : static_cast<float*>(lse),
      static_cast<__nv_bfloat16*>(xo), n, heads, d_out, n_valid, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
