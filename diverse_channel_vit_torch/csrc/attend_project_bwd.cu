// attend_project backward: given dxo, the gradients of the packed qkv
// ([dq | dk | dv]), of the output projection (dWp, dbp) and of the qkv bias,
// for the forward in attend_project.cu.
//
// Replaces the TPU kernel `_ap_bwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:713), reached through
// `_ap_bwd_impl` (:869) and `_apa_vjp_bwd` (:948).
//
// What bounds it on an H100: operations, of two kinds. Per image and layer
// at the DiChaViT-S flagship (1569 real rows and keys, D = 384, 6 heads of
// 64) the function needs 10 * rows * keys * D + 4 * rows * D^2 = 10.4 GFLOP
// of bf16 products (6.6e11 at B = 64: 0.67 ms at 989 TFLOP/s) against about
// 11 MB of compulsory traffic; and, with P recomputed in each of its two
// attention passes, 2 x 6 x 1569^2 exponentials per image (1.9e9 at B = 64:
// about 0.48 ms at the special-function units' ~3.9 T exp2/s).
//
// Design (flash_wgmma.cuh on wgmma_core.cuh), and what differs from the TPU
// kernel:
// - The TPU ran grid (b, q-block) with the whole K/V row resident in VMEM and
//   accumulated dk, dv, dWp, dbp and the bias sums in VMEM scratch across a
//   sequential q axis. Here K+V of one head (400 KB at N = 1600) does not fit
//   a block's shared memory, and blocks run in no order. So the work splits
//   FlashAttention-2 style into passes, every product a `wgmma` on tiles
//   brought in by TMA, every reduction in a fixed order and none through
//   atomics (two calls on the same inputs agree bit for bit):
//   (a) `ap_bwd_pre_kernel`, per 128 rows: do = dxo Wp (rounded to bf16, as
//       the TPU rounded it) in chunks of two heads, di = rowsum(o_h * do_h)
//       per head in f32, and the per-64-row column sums of dxo (dbp);
//   (b) `flash_bwd_kv_kernel` (flash_wgmma.cuh, shared with the
//       flash_packed backward B6, which skips the bias sums), one block per
//       (64 keys, head, image), K and V resident, the (Q, dO, lse, di) tiles
//       of 64 queries streamed through a three-stage ring: S^T = K Q^T and
//       dP^T = V dO^T from shared memory,
//       P^T = exp2(S^T scale log2e - lse log2e) (lse from the forward
//       kernel), dS^T = P^T (dP^T - di) * scale, then dV += P^T dO and
//       dK += dS^T Q with P^T and dS^T packed to bf16 as the register A
//       operands. dk and dv stay in f32 registers and are written once, with
//       their column sums (the k and v bias gradients);
//   (c) `flash_bwd_q_kernel` (flash_wgmma.cuh, shared in the same way), one
//       block per (64 queries, head, image), Q and dO resident, the (K, V)
//       tiles of 64 keys below `n_valid` streamed:
//       S = Q K^T and dP = dO V^T recomputed, dQ += dS K with dS from
//       registers, issued with the next tile's S and dP; and the column sums
//       of the rounded dq (the q bias gradient, as the TPU summed its
//       rounded dq). Recomputing S and dP in a second pass costs 40% more
//       products than one pass that adds dq across key blocks, but needs no
//       ordering across blocks;
//   (d) `ap_wgrad_kernel`: dWp = dxo^T o over every row, split-row partials
//       on 128 x 128 output tiles, both operands MN-major (wgmma's transposed
//       layout, straight from the row-major tensors);
//   (e) the per-block bias partials and dWp partials summed in a fixed order
//       (reduce.cuh).
//   (b) and (c) run three blocks of one warpgroup on each SM, so one block's
//   exponentials run while another's products do. (Blocks of 128 rows, two
//   consumer warpgroups taking turns issuing their products, were slower on
//   an H100; free-running warpgroups in such blocks, slower still.)
// - Keys at or past `n_valid` get P = 0 exactly, so their dk and dv rows come
//   out exactly 0: dW_qkv = y^T [dq | dk | dv] sums over all N rows, and a
//   stray value in a padded key row would reach a weight gradient that no
//   output check sees. Key tiles wholly past `n_valid` are written as zeros.
// - P and dS are rounded to bf16 before their products, as on the TPU; all
//   accumulators are f32. Rows past the end (the ragged last 128-row block
//   of (a)) load as zeros and are skipped or clipped by the stores.
#include "flash_wgmma.cuh"
#include "reduce.cuh"

namespace dcvit {

constexpr int kBRows = 64;  // rows per tile of the bias partials
// (a) and (d): blocks of two consumer warpgroups (128 rows or output rows)
// and one producer warp
constexpr int kGemmRows = 2 * fw::kWgRows;
constexpr int kGemmThreads = 2 * 128 + 32;

// (a): a stage holds dxo rows [128][64 of D_out] (K-major) and Wp rows [64
// of D_out] x 128 columns of D (two MN-major [64][64] boxes)
constexpr int kPreStages = 4;
constexpr int kPreStageBytes = 4 * wg::kBoxBytes;
constexpr int kPreSmem = kPreStages * kPreStageBytes + 2 * kPreStages * 8 + wg::kAlign;
// (d): a stage holds 64 rows of dxo (two [64][64] boxes, 128 columns of
// D_out) and of o (two, 128 columns of D), both MN-major
constexpr int kWgStages = 4;
constexpr int kWgStageBytes = 4 * wg::kBoxBytes;
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

// (a) do = dxo Wp (rounded to bf16), di = rowsum(o_h do_h) per head (f32),
// and the dbp partials (column sums of dxo per 64-row tile). Grid
// (ceil(B N / 128)); the block walks D in chunks of 128 columns (two heads
// of width 64, or one of 128), each a K loop over D_out.
template <int HD>
__global__ void __launch_bounds__(kGemmThreads, 1)
    ap_bwd_pre_kernel(const __grid_constant__ CUtensorMap dxo128,
                      const __grid_constant__ CUtensorMap wp64, const __nv_bfloat16* __restrict__ o,
                      __nv_bfloat16* __restrict__ do_out, float* __restrict__ di,
                      float* __restrict__ bias_part, int rows, int n, int heads, int d_out,
                      int bias_stride) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPreStages * kPreStageBytes);
  uint64_t* empty = full + kPreStages;
  const int wgi = wg::warpgroup(), t = threadIdx.x & 127;
  constexpr int kChunkHeads = 2 * wg::kBox / HD;
  const int d = heads * HD, r0 = blockIdx.x * kGemmRows;
  const int n_kc = d_out / wg::kBox, n_chunks = (d + 2 * wg::kBox - 1) / (2 * wg::kBox);
  init_ring(full, empty, kPreStages);

  if (wgi == wg::kConsumers) {
    if (t == 0) {
      int it = 0;
      for (int c = 0; c < n_chunks; ++c)
        for (int kc = 0; kc < n_kc; ++kc, ++it) {
          const int s = it % kPreStages;
          wg::bar_wait(&empty[s], ((it / kPreStages) & 1) ^ 1);
          wg::bar_expect_tx(&full[s], kPreStageBytes);
          uint8_t* st = ring + s * kPreStageBytes;
          wg::tma_load(st, &dxo128, &full[s], kc * wg::kBox, r0);
          wg::tma_load(st + 2 * wg::kBoxBytes, &wp64, &full[s], 2 * wg::kBox * c, kc * wg::kBox);
          wg::tma_load(st + 3 * wg::kBoxBytes, &wp64, &full[s], 2 * wg::kBox * c + wg::kBox,
                       kc * wg::kBox);
        }
    }
  } else {
    const uint32_t ring_s = smem_addr(ring);
    const int rw = r0 + fw::kWgRows * wgi;  // this warpgroup's first row
    const int row_a = rw + wg::acc_row(t, 0), row_b = row_a + 8;
    int it = 0;
    for (int c = 0; c < n_chunks; ++c) {
      float acc[64];  // do: 64 rows x 128 columns (heads 2c and 2c + 1)
      for (int kc = 0; kc < n_kc; ++kc, ++it) {
        const int s = it % kPreStages;
        wg::bar_wait(&full[s], (it / kPreStages) & 1);
        const uint32_t st = wg::opaque(ring_s) + s * kPreStageBytes;
        wg::mma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          wg::mma_m64n128<0, 1>(acc, wg::desc_k(st + wgi * fw::kHalfBox, k4),
                                wg::desc_mn(st + 2 * wg::kBoxBytes, k4, wg::kBoxBytes),
                                kc + k4 > 0);
        wg::mma_commit();
        if (c == 0 && t < wg::kBox && rw < rows) {
          // dbp partial: this warpgroup's 64 rows of dxo column 64 kc + t
          const uint8_t* box = ring + s * kPreStageBytes + wgi * fw::kHalfBox;
          float sum = 0.f;
          for (int r = 0; r < fw::kWgRows; ++r)
            sum += bf(*reinterpret_cast<const __nv_bfloat16*>(box + wg::swz(r, t)));
          bias_part[(long long)(rw / kBRows) * bias_stride + kc * wg::kBox + t] = sum;
        }
        wg::mma_wait<0>();
        if (t == 0) wg::bar_arrive(&empty[s]);
      }
      wg::acc_fence(acc);
      // round do to bf16; di = sum over each head's columns of o * do (f32)
#pragma unroll
      for (int hh = 0; hh < kChunkHeads; ++hh) {
        const int h = kChunkHeads * c + hh;
        float di_a = 0.f, di_b = 0.f;
#pragma unroll
        for (int i = HD / 2 * hh; i < HD / 2 * (hh + 1); i += 2) {
          const bool rb = (i >> 1) & 1;
          const int row = rb ? row_b : row_a;
          const int col = 2 * wg::kBox * c + wg::acc_col(t, i);
          if (h < heads && row < rows) {
            const long long g = (long long)row * d + col;
            const uint32_t v = pack_bf16(acc[i], acc[i + 1]);
            *reinterpret_cast<uint32_t*>(do_out + g) = v;
            const float2 f = unpack_bf16(v);
            const float2 ov = unpack_bf16(*reinterpret_cast<const uint32_t*>(o + g));
            (rb ? di_b : di_a) += f.x * ov.x + f.y * ov.y;
          }
        }
        di_a = sum_over_quad(di_a);
        di_b = sum_over_quad(di_b);
        if (h < heads && (t & 3) == 0) {
          if (row_a < rows) di[((long long)(row_a / n) * heads + h) * n + row_a % n] = di_a;
          if (row_b < rows) di[((long long)(row_b / n) * heads + h) * n + row_b % n] = di_b;
        }
      }
    }
  }
}

// (d) dWp = dxo^T o over every row: block (128 x 128 output tile, split z)
// writes part[z] = the sum over the rows of split z, in order; rows past the
// end load as zeros. Grid (ceil(D_out / 128) ceil(D / 128), splits).
__global__ void __launch_bounds__(kGemmThreads, 1)
    ap_wgrad_kernel(const __grid_constant__ CUtensorMap dxo64, const __grid_constant__ CUtensorMap o64,
                    float* __restrict__ part, int rows, int d_out, int d, int rows_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int wgi = wg::warpgroup(), t = threadIdx.x & 127;
  const int tiles_n = (d + 2 * wg::kBox - 1) / (2 * wg::kBox);
  const int i1 = (blockIdx.x / tiles_n) * 2 * wg::kBox, i2 = (blockIdx.x % tiles_n) * 2 * wg::kBox;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = r_begin + rows_per_split < rows ? r_begin + rows_per_split : rows;
  const int n_steps = r_end > r_begin ? (r_end - r_begin + wg::kBox - 1) / wg::kBox : 0;
  init_ring(full, empty, kWgStages);

  if (wgi == wg::kConsumers) {
    if (t == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kWgStages, r = r_begin + i * wg::kBox;
        wg::bar_wait(&empty[s], ((i / kWgStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kWgStageBytes);
        uint8_t* st = ring + s * kWgStageBytes;
        for (int b = 0; b < 2; ++b) {
          wg::tma_load(st + b * wg::kBoxBytes, &dxo64, &full[s], i1 + b * wg::kBox, r);
          wg::tma_load(st + (2 + b) * wg::kBoxBytes, &o64, &full[s], i2 + b * wg::kBox, r);
        }
      }
    }
  } else {
    float acc[64];  // dWp rows [i1 + 64 wgi, + 64) x columns [i2, i2 + 128)
    wg::acc_zero(acc);
    const uint32_t ring_s = smem_addr(ring);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kWgStages;
      wg::bar_wait(&full[s], (i / kWgStages) & 1);
      const uint32_t st = wg::opaque(ring_s) + s * kWgStageBytes;
      wg::mma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wg::mma_m64n128<1, 1>(acc, wg::desc_mn(st + wgi * wg::kBoxBytes, k4, wg::kBoxBytes),
                              wg::desc_mn(st + 2 * wg::kBoxBytes, k4, wg::kBoxBytes), 1);
      wg::mma_commit();
      wg::mma_wait<0>();
      if (t == 0) wg::bar_arrive(&empty[s]);
    }
    wg::acc_fence(acc);
    float* out = part + (long long)blockIdx.y * d_out * d;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = i1 + fw::kWgRows * wgi + wg::acc_row(t, i), c = i2 + wg::acc_col(t, i);
      if (r < d_out && c < d)
        *reinterpret_cast<float2*>(out + (long long)r * d + c) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

template <int HD>
cudaError_t ap_bwd(const void* qkv, const void* o, const void* lse, const void* wp,
                   const void* dxo, void* dqkv, void* dwp, void* bias_out, void* do_buf,
                   void* di, void* bias_part, void* wgrad_part, int batch, int n, int heads,
                   int d_out, int n_valid, float sm_scale, int splits, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const int d = heads * HD, tiles = n / kBRows, stride = d_out + 3 * d;
  const float scale_log2 = sm_scale * fw::kLog2e;
  cudaError_t err;

  const int rows = batch * n;
  CUtensorMap qkv64, do64, dqkv64, dxo128, dxo64, wp64, o64;
  if ((err = tensor_map(&dxo128, dxo, rows, d_out, kGemmRows)) != cudaSuccess ||
      (err = tensor_map(&dxo64, dxo, rows, d_out, wg::kBox)) != cudaSuccess ||
      (err = tensor_map(&wp64, wp, d_out, d, wg::kBox)) != cudaSuccess ||
      (err = tensor_map(&o64, o, rows, d, wg::kBox)) != cudaSuccess ||
      (err = tensor_map3(&qkv64, qkv, batch, n, 3 * d, fw::kWgRows, 3 * d)) != cudaSuccess ||
      (err = tensor_map3(&do64, do_buf, batch, n, d, fw::kWgRows, d)) != cudaSuccess ||
      (err = tensor_map3(&dqkv64, dqkv, batch, n, 3 * d, fw::kWgRows, 3 * d)) != cudaSuccess)
    return err;
  constexpr int kv_bytes = kv_smem(HD, 1), q_bytes = q_smem(HD, 1);
  const struct {
    const void* fn;
    int smem;
  } attrs[] = {{(const void*)ap_bwd_pre_kernel<HD>, kPreSmem},
               {(const void*)ap_wgrad_kernel, kWgSmem},
               {(const void*)flash_bwd_kv_kernel<true, HD>, kv_bytes},
               {(const void*)flash_bwd_q_kernel<true, HD>, q_bytes}};
  for (const auto& a : attrs)
    if ((err = cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    a.smem)) != cudaSuccess)
      return err;

  ap_bwd_pre_kernel<HD><<<(rows + kGemmRows - 1) / kGemmRows, kGemmThreads, kPreSmem, st>>>(
      dxo128, wp64, static_cast<const bf16*>(o), static_cast<bf16*>(do_buf),
      static_cast<float*>(di), static_cast<float*>(bias_part), rows, n, heads, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // q, k and v: the packed qkv's columns 0, D and 2D
  const dim3 grid(tiles, heads, batch);
  flash_bwd_kv_kernel<true, HD><<<grid, kFlashThreads, kv_bytes, st>>>(
      qkv64, qkv64, qkv64, do64, dqkv64, 0, d, 2 * d, static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dqkv), static_cast<float*>(bias_part), n,
      n_valid, heads, scale_log2, sm_scale, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_q_kernel<true, HD><<<grid, kFlashThreads, q_bytes, st>>>(
      qkv64, qkv64, qkv64, do64, dqkv64, 0, d, 2 * d, static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(bias_part), n, n_valid, heads,
      scale_log2, sm_scale, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // dWp = dxo^T o over all B * N rows, then the fixed-order sums
  const int per = (rows + splits - 1) / splits;
  const int rows_per_split = (per + wg::kBox - 1) / wg::kBox * wg::kBox;
  const int wg_tiles = ((d_out + 127) / 128) * ((d + 127) / 128);
  ap_wgrad_kernel<<<dim3(wg_tiles, splits), kGemmThreads, kWgSmem, st>>>(
      dxo64, o64, static_cast<float*>(wgrad_part), rows, d_out, d, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_reduce(static_cast<const float*>(wgrad_part), static_cast<float*>(dwp), splits,
                      (long long)d_out * d, st);
  if (err != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(bias_part), static_cast<float*>(bias_out),
                       batch * tiles, stride, st);
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Head width 64 or 128. Shapes:
// qkv and dqkv (B, N, 3D) packed [q | k | v], o and do_buf (B, N, D), dxo
// (B, N, D_out), all bf16;
// wp (D_out, D) bf16 in nn.Linear layout; lse and di (B, H, N) f32; dwp
// (D_out, D) f32; bias_out (D_out + 3D) f32 = [dbp | dbq | dbk | dbv];
// bias_part (B * N / 64, D_out + 3D) f32 and wgrad_part (splits, D_out, D)
// f32 scratch. All contiguous. Returns a cudaError_t: the first failed
// launch's (or TMA descriptor's), or cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int dcvit_attend_project_bwd(const void* qkv, const void* o, const void* lse,
                                        const void* wp, const void* dxo, void* dqkv, void* dwp,
                                        void* bias_out, void* do_buf, void* di, void* bias_part,
                                        void* wgrad_part, int batch, int n, int heads,
                                        int head_dim, int d_out, int n_valid, float sm_scale,
                                        int splits, void* stream) {
  using namespace dcvit;
  if (!fw::head_width_built(head_dim) || n % kBRows != 0 || d_out % 64 != 0 || n_valid < 1 ||
      n_valid > n || batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || splits < 1 ||
      (long long)batch * n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  auto run = head_dim == 64 ? ap_bwd<64> : ap_bwd<128>;
  return (int)run(qkv, o, lse, wp, dxo, dqkv, dwp, bias_out, do_buf, di, bias_part, wgrad_part,
                  batch, n, heads, d_out, n_valid, sm_scale, splits,
                  static_cast<cudaStream_t>(stream));
}
