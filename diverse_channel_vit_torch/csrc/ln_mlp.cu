// ln_mlp forward: LayerNorm, fc1, tanh-GELU, fc2, bias and optional residual
// in one launch; the hidden activation never goes to device memory.
//
// Replaces the TPU kernel `_ln_mlp_fwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:152), reached through
// `_ln_mlp_fwd_impl` and `ln_mlp`.
//
// What bounds it on an H100: operations, and behind them the weight stream.
// Per image and layer at the DiChaViT-S flagship (1600 rows, D = 384, hidden
// 1536) it does about 3.8 GFLOP of bf16 products against about 4.8 MB of
// compulsory traffic (x and out once, W1 and W2 once), some 790 FLOP per
// byte, above the card's ~295 FLOP/byte ridge. The traffic that would make it
// memory-bound is the (rows x 1536) hidden activation, 4.9 MB per image in
// bf16 each way, which this kernel keeps on chip as the TPU kernel kept it in
// VMEM. What is left is the weight stream: every 64-row block reads W1 and
// W2 (2.36 MB) from L2 into shared memory, 3.8 GB of L2 reads per call at
// B = 64 and N = 1600.
//
// Design (wgmma_core.cuh), and what differs from the TPU kernel:
// - The TPU held W1 and W2 resident in VMEM. Here a block owns 64 rows and
//   one producer thread streams the weights by TMA, a hidden chunk of 64 as
//   four 24 KB stages (W1's 64 rows over half of D, then W2's 64 columns
//   over half of D) through a six-stage ring; each stage has one reader
//   warpgroup. All blocks walk the chunks in the same order. Two variants
//   were slower on an H100: blocks starting at different chunks (so that
//   the SMs would not read the same weight rows at once), and pairs of
//   blocks in a cluster each loading half of every stage and multicasting
//   it to both (half the L2 reads, but every stage then waits for the
//   slower of four readers).
// - LayerNorm runs once per row tile, in f32 with a two-pass mean and
//   variance (eps 1e-6), and its bf16 output y stays in shared memory as six
//   swizzled K-major boxes, the A operand of every fc1.
// - The two consumer warpgroups take turns at fc1 and share fc2. Warpgroup
//   c % 2 computes chunk c's h_pre^T (64 hidden x 64 rows) = W1_c y^T by
//   `wgmma` m64n64 (K = 384, W1's rows the A operand), then GELU_tanh(h_pre
//   + b1) in f32 registers (tanh from the SFU's exp and reciprocal,
//   wgmma_core.cuh), rounded to bf16 into one of two h boxes as an MN-major
//   tile. Each warpgroup then adds its half of the output, out[:, 192w :
//   192w + 192] += h W2_c^T by `wgmma` m64n192 with h as the transposed A
//   operand (K = 64). The h boxes pass between the warpgroups through full
//   and empty mbarriers, so one warpgroup's GELU overlaps the other's
//   products, and each holds a 64 x 192 f32 output accumulator (96
//   registers a thread): one warpgroup holding all 384 columns (192
//   registers) beside an fc1 accumulator left ptxas too few registers, and
//   it spilled the output.
// - The epilogue adds b2 and, with `residual`, x in f32, rounds to bf16
//   once, writes the tile into the (now free) y boxes and stores it by TMA,
//   which clips the rows past the end of a ragged last tile.
//
// ln_mlp_fwd_kernel is built for D = 384: a block owns all 384 model
// columns of its rows (96 + 32 accumulator registers a thread). Shared
// memory: y 48 KB, h 16 KB, a ring of 6 stages of 24 KB, barriers:
// 214,144 of the 232,448 bytes a block may take. ptxas (nvcc 12.9, sm_90a):
// 168 registers, no stack frame, no spill.
//
// D = 768 is not fused. A 64 x 768 output tile would take 192 accumulator
// registers a thread, so the fused kernel used to split each 64-row tile
// over a cluster pair that exchanged 16 KB of h_pre partials per 64 hidden
// units and streamed W1 and W2 from L2 once per 64 rows (15.1 GB a call at
// B = 64, N = 1600): 4.51 ms on an H100 80GB HBM3 at 700 W, 2.2x one cuBLAS
// composition. At 768 the forward is three launches (ln_mlp_gemm.cuh), at
// the rounding points above:
//   (a) `ln_rows_kernel<768>`: y (bf16) into scratch;
//   (b) `gemm_kernel<EpiGelu>`: h = GELU_tanh(y W1^T + b1), bf16, into
//       scratch;
//   (c) `gemm_kernel<EpiBiasResidual>`: out = h W2^T + b2 (+ x) in f32,
//       rounded once;
// the GEMMs persistent on 128 x 256 tiles, clusters of two row tiles
// multicasting the weight tile; fc2's epilogue loads its tile of x by TMA.
// Shared memory: the ring, four stages of 48 KB, and its and the
// epilogues' barriers, 197,712 bytes. ptxas (nvcc 12.9, sm_90a): 168
// registers for both GEMMs, with 44 (fc1) and 68 (fc2) bytes of spill
// stores; 48 for the row pass. On an H100 80GB HBM3 at 700 W, B = 64, N =
// 1600: 1.96 ms (row pass 0.07-0.10, fc1 1.11, fc2 0.71), 7% below the
// same composition in PyTorch (2.11 ms); fc2 took 0.89-0.90 ms while its
// epilogue read x from device memory a bf16 pair a thread at a time. The
// GEMMs' 64-deep k-steps take about 0.8-0.95 us against 0.56 at the card's
// peak rate, and fc1's GELU epilogue (two SFU operations an element) is not
// hidden behind the products. The scratch is B * N * (768 + 3072) bf16
// (0.79 GB at B = 64 and N = 1600).
#include "ln_mlp_gemm.cuh"

namespace dcvit {

constexpr int kLMW = 384;                                // model columns
constexpr int kLMRows = 64;                              // rows per block
constexpr int kLMChunk = 64;                             // hidden columns per chunk
constexpr int kLMStageBytes = 3 * wg::kBoxBytes;         // a quarter chunk: 24 KB
constexpr int kLMYBytes = (kLMW / wg::kBox) * wg::kBoxBytes;  // y: 48 KB
constexpr int kLMStages = 6;
constexpr int kLMSmem = kLMYBytes + 2 * wg::kBoxBytes + kLMStages * kLMStageBytes +
                        (2 * kLMStages + 4) * 8 + wg::kAlign;
static_assert(kLMSmem <= 232448, "ln_mlp: shared memory past 227 KB");

__global__ void __launch_bounds__(wg::kThreads, 1)
    ln_mlp_fwd_kernel(const __grid_constant__ CUtensorMap w1_map,
                      const __grid_constant__ CUtensorMap w2_map,
                      const __grid_constant__ CUtensorMap out_map,
                      const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ b2, long long m, int hid, int residual) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sY = wg::align(smem_raw);       // 6 boxes of 64 x 64
  uint8_t* sH = sY + kLMYBytes;            // 2 boxes of 64 x 64, used in turn
  uint8_t* ring = sH + 2 * wg::kBoxBytes;  // [stages][24 KB]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kLMStages * kLMStageBytes);
  uint64_t* empty = full + kLMStages;
  uint64_t* hfull = empty + kLMStages;  // [2]: h box written (one arrival)
  uint64_t* hempty = hfull + 2;         // [2]: h box read by both warpgroups' fc2

  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const long long m0 = (long long)blockIdx.x * kLMRows;
  const int n_chunks = hid / kLMChunk;

  if (tid == 0) {
    for (int s = 0; s < kLMStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 1);  // its one reader warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      wg::bar_init(&hfull[b], 1);
      wg::bar_init(&hempty[b], wg::kConsumers);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (wgi == wg::kConsumers) {
    // producer: item 4c + q of chunk c holds, for q = 0, 1, W1 rows [64c,
    // 64c + 64) x columns [192q, 192q + 192) (three [64][64] boxes) and, for
    // q = 2, 3, W2 rows [192 (q - 2), + 192) x columns [64c, 64c + 64) (one
    // [192][64] box)
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int i = 0; i < 4 * n_chunks; ++i) {
        const int s = i % kLMStages, c = i >> 2, q = i & 3;
        wg::bar_wait(&empty[s], ((i / kLMStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kLMStageBytes);
        uint8_t* dst = ring + s * kLMStageBytes;
        if (q < 2) {
          for (int b = 0; b < 3; ++b)
            wg::tma_load(dst + b * wg::kBoxBytes, &w1_map, &full[s], (3 * q + b) * wg::kBox,
                         c * kLMChunk);
        } else {
          wg::tma_load(dst, &w2_map, &full[s], c * kLMChunk, (q - 2) * (kLMW / 2));
        }
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    const int warp = t >> 5, lane = t & 31;
    const int cw = 4 * wgi + warp;  // consumer warp, 0 .. 7

    // LayerNorm: consumer warp cw normalises rows [8 cw, 8 cw + 8); lane
    // `lane` holds columns 2 (lane + 32 i) and the next, i < 6, which lie in
    // box i at column 2 lane
    float sc[12], sh[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int col = 2 * (lane + 32 * i);
      sc[2 * i] = ln_scale[col];
      sc[2 * i + 1] = ln_scale[col + 1];
      sh[2 * i] = ln_bias[col];
      sh[2 * i + 1] = ln_bias[col + 1];
    }
    for (int rr = 0; rr < 8; ++rr) {
      const int r = 8 * cw + rr;
      float2 v[6];
      if (m0 + r < m) {
        const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x + (m0 + r) * kLMW);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          v[i] = unpack_bf16(xrow[lane + 32 * i]);
          sum += v[i].x + v[i].y;
        }
        const float mean = warp_sum(sum) / kLMW;
        float sq = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float a = v[i].x - mean, b = v[i].y - mean;
          sq += a * a + b * b;
        }
        const float rstd = rsqrtf(warp_sum(sq) / kLMW + 1e-6f);
#pragma unroll
        for (int i = 0; i < 6; ++i)
          v[i] = make_float2((v[i].x - mean) * rstd * sc[2 * i] + sh[2 * i],
                             (v[i].y - mean) * rstd * sc[2 * i + 1] + sh[2 * i + 1]);
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) v[i] = make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
        wg::st_pair(sY + i * wg::kBoxBytes, r, 2 * lane, v[i].x, v[i].y);
    }
    wg::fence_async_smem();
    wg::sync_named(3, 256);  // all of y is written

    // fc1 of chunk c, by warpgroup c % 2: h_pre^T (64 hidden x 64 rows) =
    // W1_c y^T, W1's chunk rows the A operand and y the B operand (both
    // K-major, K = 384 over the chunk's two W1 stages), then
    // GELU_tanh(h_pre + b1) in f32, rounded to bf16 into h box c & 1 as an
    // MN-major [hidden][rows] tile, fc2's transposed A operand.
    float acc[96];  // out[:, 192 wgi : + 192]
    float hacc[32];
    wg::acc_zero(acc);
    const uint32_t y_s = smem_addr(sY), h_s = smem_addr(sH), ring_s = smem_addr(ring);
    auto fc1 = [&](int c) {
      const uint32_t ya = wg::opaque(y_s), ra = wg::opaque(ring_s);
      uint8_t* hbox = sH + (c & 1) * wg::kBoxBytes;
      wg::bar_wait(&hempty[c & 1], ((c >> 1) & 1) ^ 1);  // both fc2 of chunk c - 2 are done
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int item = 4 * c + q, s = item % kLMStages;
        wg::bar_wait(&full[s], (item / kLMStages) & 1);
        const uint32_t w1a = ra + s * kLMStageBytes;
        wg::mma_fence();
#pragma unroll
        for (int ks = 0; ks < 12; ++ks)
          wg::mma_m64n64<0, 0>(hacc, wg::desc_k(w1a + (ks >> 2) * wg::kBoxBytes, ks & 3),
                               wg::desc_k(ya + (3 * q + (ks >> 2)) * wg::kBoxBytes, ks & 3),
                               q + ks > 0);
        wg::mma_commit();
      }
      wg::mma_wait<0>();
      wg::acc_fence(hacc);
      if (t == 0) {
        wg::bar_arrive(&empty[(4 * c) % kLMStages]);
        wg::bar_arrive(&empty[(4 * c + 1) % kLMStages]);
      }
      const int hr = wg::acc_row(t, 0);  // this thread's hidden rows: hr and hr + 8
      const float bb0 = bf(b1[c * kLMChunk + hr]), bb1 = bf(b1[c * kLMChunk + hr + 8]);
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const float bb = (j & 2) ? bb1 : bb0;
        wg::st_pair(hbox, wg::acc_row(t, j), wg::acc_col(t, j), wg::gelu(hacc[j] + bb),
                    wg::gelu(hacc[j + 1] + bb));
      }
      wg::fence_async_smem();
      wg::sync_named(1 + wgi, 128);
      if (t == 0) wg::bar_arrive(&hfull[c & 1]);
    };

    // Warpgroup w runs fc1 of chunks w, w + 2, ... and fc2 of every chunk:
    // fc1(w), then for each chunk c: fc2(c), and after fc2(c) of its own
    // chunk c, fc1(c + 2). One warpgroup's GELU runs while the other's
    // products do; h boxes pass between them through hfull and hempty.
    if (wgi < n_chunks) fc1(wgi);
    for (int c = 0; c < n_chunks; ++c) {
      const uint32_t ra = wg::opaque(ring_s), ha = wg::opaque(h_s);
      // fc2: out[:, 192 wgi : + 192] += h W2_c^T, K = 64, from h box c & 1
      // and this warpgroup's W2 stage
      wg::bar_wait(&hfull[c & 1], (c >> 1) & 1);
      const int own = 4 * c + 2 + wgi, s2 = own % kLMStages;
      wg::bar_wait(&full[s2], (own / kLMStages) & 1);
      const uint32_t hb = ha + (c & 1) * wg::kBoxBytes, w2a = ra + s2 * kLMStageBytes;
      wg::mma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg::mma_m64n192<1, 0>(acc, wg::desc_mn(hb, ks, wg::kBoxBytes), wg::desc_k(w2a, ks), 1);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::acc_fence(acc);
      if (t == 0) {
        wg::bar_arrive(&empty[s2]);
        wg::bar_arrive(&hempty[c & 1]);
      }
      if ((c & 1) == wgi && c + 2 < n_chunks) fc1(c + 2);
    }

    // out = acc + b2 (+ x), rounded once, through this warpgroup's three y
    // boxes (free: both warpgroups' last fc1 came before the last barrier)
    // to TMA stores
#pragma unroll
    for (int j = 0; j < 96; j += 2) {
      const int row = wg::acc_row(t, j), lc = wg::acc_col(t, j), col = (kLMW / 2) * wgi + lc;
      const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b2 + col));
      float v0 = acc[j] + bb.x, v1 = acc[j + 1] + bb.y;
      if (residual && m0 + row < m) {
        const float2 xr =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(x + (m0 + row) * kLMW + col));
        v0 += xr.x;
        v1 += xr.y;
      }
      wg::st_pair(sY + (col >> 6) * wg::kBoxBytes, row, col & 63, v0, v1);
    }
    wg::fence_async_smem();
    wg::sync_named(1 + wgi, 128);
    if (t == 0) {
      for (int b = 3 * wgi; b < 3 * wgi + 3; ++b)
        wg::tma_store(&out_map, sY + b * wg::kBoxBytes, b * wg::kBox, (int)m0);
      wg::tma_store_commit();
      wg::tma_store_wait();
    }
  }
}

// D = 384: one fused launch, a block per 64 rows.
inline cudaError_t launch_ln_mlp_fwd_384(const void* x, const void* ln_scale, const void* ln_bias,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, void* out, long long m, int hid,
                                         int residual, cudaStream_t stream) {
  CUtensorMap w1_map, w2_map, out_map;
  cudaError_t err;
  if ((err = tensor_map(&w1_map, w1, hid, kLMW, wg::kBox)) != cudaSuccess) return err;
  if ((err = tensor_map(&w2_map, w2, kLMW, hid, kLMW / 2)) != cudaSuccess) return err;
  if ((err = tensor_map(&out_map, out, m, kLMW, wg::kBox)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ln_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kLMSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (m + kLMRows - 1) / kLMRows;
  ln_mlp_fwd_kernel<<<(unsigned)blocks, wg::kThreads, kLMSmem, stream>>>(
      w1_map, w2_map, out_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(b2), m, hid,
      residual);
  return cudaGetLastError();
}

// D = 768: the row pass, then fc1 and fc2 as GEMMs on clusters of two row
// tiles that multicast the weight tile; y_buf (M, 768) and h_buf (M, hid)
// bf16 and stats (M, 2) f32 are scratch.
inline cudaError_t launch_ln_mlp_fwd_768(const void* x, const void* ln_scale, const void* ln_bias,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, void* out, void* y_buf, void* stats,
                                         void* h_buf, long long m, int hid, int residual,
                                         cudaStream_t stream) {
  constexpr int D = 768;
  cudaError_t err;
  CUtensorMap y128, w1_128, h64, h128, w2_128, out64, x64;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    long long rows;
    int cols, box_rows;
  } maps[] = {
      {&y128, y_buf, m, D, gm::kTileM},      {&w1_128, w1, hid, D, gm::kTileN / 2},
      {&h64, h_buf, m, hid, wg::kBox},       {&h128, h_buf, m, hid, gm::kTileM},
      {&w2_128, w2, D, hid, gm::kTileN / 2}, {&out64, out, m, D, wg::kBox},
      {&x64, x, m, D, wg::kBox},
  };
  for (const auto& mp : maps)
    if ((err = tensor_map(mp.map, mp.ptr, mp.rows, mp.cols, mp.box_rows)) != cudaSuccess)
      return err;
  if ((err = launch_ln_rows<D>(x, ln_scale, ln_bias, y_buf, stats, m, stream)) != cudaSuccess)
    return err;
  const EpiGelu::Params p1 = {static_cast<const __nv_bfloat16*>(b1), hid};
  if ((err = launch_gemm<EpiGelu, false>(y128, w1_128, h64, p1, m, hid, D, stream)) !=
      cudaSuccess)
    return err;
  const EpiBiasResidual::Params p2 = {x64, static_cast<const __nv_bfloat16*>(b2), D, residual};
  return launch_gemm<EpiBiasResidual, false>(h128, w2_128, out64, p2, m, D, hid, stream);
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: x and out (M, D) bf16,
// D = 384 or 768, ln_scale and ln_bias (D,) f32, w1 (HID, D) and w2 (D, HID)
// in nn.Linear layout (HID a multiple of 64), b1 (HID,) and b2 (D,), all
// bf16 unless stated and contiguous; at D = 768 the scratch y_buf (M, D) and
// h_buf (M, HID) bf16 and stats (M, 2) f32 (unused at 384). Returns a
// cudaError_t: the first failed launch's (or TMA descriptor's), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int dcvit_ln_mlp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* out, void* y_buf, void* stats, void* h_buf, long long m,
                                int d, int hid, int residual, void* stream) {
  using namespace dcvit;
  if ((d != 384 && d != 768) || hid % kLMChunk != 0 || hid < kLMChunk || m < 1 ||
      m > 2147483647LL || (d == 768 && (y_buf == nullptr || stats == nullptr || h_buf == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d == 384 ? launch_ln_mlp_fwd_384(x, ln_scale, ln_bias, w1, b1, w2, b2, out, m, hid,
                                                residual, st)
                        : launch_ln_mlp_fwd_768(x, ln_scale, ln_bias, w1, b1, w2, b2, out, y_buf,
                                                stats, h_buf, m, hid, residual, st));
}
