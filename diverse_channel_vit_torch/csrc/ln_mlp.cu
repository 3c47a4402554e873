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
// D is a template parameter, 384 or 768; a block always owns 384 model
// columns, so its accumulators stay at 96 + 32 registers a thread (a 64 x
// 768 output would take 192 a warpgroup, past the 168 ptxas allows here).
// At D = 768 two blocks in a cluster share each 64-row tile, block r owning
// columns [384 r, 384 r + 384):
// - LayerNorm: each block sums its half of every row and hands the sums to
//   the other block through distributed shared memory (wgmma_core.cuh),
//   first for the mean, then for the centred squares; both add the same
//   two f32 terms, so both normalise with the same statistics. Each keeps
//   its half of y.
// - fc1's K is split across the pair: each block multiplies its half of y
//   by the matching 384 columns of W1's chunk rows, stores the f32 64 x 64
//   h_pre partial into the other block's shared memory (double-buffered,
//   one buffer per warpgroup and parity), waits for the other's partial,
//   and adds the two before the GELU, so h is the same in both blocks and
//   no product is done twice.
// - fc2 and the epilogue cover the block's 384 output columns and its rows
//   of W2, as at D = 384.
// Shared memory at D = 768: y 48 KB, h 16 KB, a ring of 4 stages (6 at D =
// 384) of 24 KB, the partial buffers 64 KB, barriers and the two row-sum
// arrays: 231,056 of the 232,448 bytes a block may take. ptxas (nvcc 12.9,
// sm_90a): 168 registers, no stack frame, no spill, for both widths. At D
// = 768 a call reads W1 and W2 from L2 once per block (15.1 GB at B = 64,
// N = 1600): that weight stream, and the pair's per-chunk exchange, hold
// it above its bound.
#include "wgmma_core.cuh"

namespace dcvit {

constexpr int kLMW = 384;                                // model columns a block owns
constexpr int kLMRows = 64;                              // rows per block
constexpr int kLMChunk = 64;                             // hidden columns per chunk
constexpr int kLMStageBytes = 3 * wg::kBoxBytes;         // a quarter chunk: 24 KB
constexpr int kLMYBytes = (kLMW / wg::kBox) * wg::kBoxBytes;  // y: 48 KB
// D = 768: the h_pre partials one warpgroup sends the other block for two
// chunks in turn ([2 warpgroups][2][8][128 threads][4] f32)
constexpr int kLMXBytes = 2 * 2 * 128 * 32 * 4;

// D / 384 blocks a cluster; the ring's stages and the shared memory a block takes
template <int D>
struct LnMlpShape {
  static_assert(D == 384 || D == 768, "ln_mlp: D = 384 or 768");
  static constexpr int kPair = D / kLMW;
  static constexpr int kStages = kPair == 1 ? 6 : 4;
  static constexpr int kSmem =
      kLMYBytes + 2 * wg::kBoxBytes + kStages * kLMStageBytes + (2 * kStages + 4) * 8 +
      wg::kAlign + (kPair == 1 ? 0 : (4 + 2) * 8 + 2 * kLMRows * 4 + kLMXBytes);
  static_assert(kSmem <= 232448, "ln_mlp: shared memory past 227 KB");
};

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
    ln_mlp_fwd_kernel(const __grid_constant__ CUtensorMap w1_map,
                      const __grid_constant__ CUtensorMap w2_map,
                      const __grid_constant__ CUtensorMap out_map,
                      const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ b2, long long m, int hid, int residual) {
  constexpr int kPair = LnMlpShape<D>::kPair;
  constexpr int kLMStages = LnMlpShape<D>::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sY = wg::align(smem_raw);       // 6 boxes of 64 x 64
  uint8_t* sH = sY + kLMYBytes;            // 2 boxes of 64 x 64, used in turn
  uint8_t* ring = sH + 2 * wg::kBoxBytes;  // [stages][24 KB]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kLMStages * kLMStageBytes);
  uint64_t* empty = full + kLMStages;
  uint64_t* hfull = empty + kLMStages;  // [2]: h box written (one arrival)
  uint64_t* hempty = hfull + 2;         // [2]: h box read by both warpgroups' fc2
  // D = 768 only: the other block's h_pre partials and LayerNorm row sums
  uint64_t* xfull = hempty + 2;  // [2 warpgroups][2]: its 128 threads' partials stored
  uint64_t* lnbar = xfull + 4;   // [2]: its row sums, then sums of squares, stored
  float* lnx = reinterpret_cast<float*>(lnbar + 2);  // [2][64]: those sums
  float* xbuf = lnx + 2 * kLMRows;  // [2 warpgroups][2][8][128][4]: those partials

  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const long long m0 = (long long)(blockIdx.x / kPair) * kLMRows;
  const int n_chunks = hid / kLMChunk;
  // this block's model columns [col0, col0 + 384): its half of y, of fc1's K,
  // of W2's rows and of the output
  int col0 = 0;
  uint32_t peer = 0;
  if constexpr (kPair == 2) {
    peer = wg::cluster_rank() ^ 1;
    col0 = kLMW * (int)(peer ^ 1);
  }

  if (tid == 0) {
    for (int s = 0; s < kLMStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 1);  // its one reader warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      wg::bar_init(&hfull[b], 1);
      wg::bar_init(&hempty[b], wg::kConsumers);
    }
    if constexpr (kPair == 2) {
      for (int b = 0; b < 4; ++b) wg::bar_init(&xfull[b], 128);
      for (int b = 0; b < 2; ++b) wg::bar_init(&lnbar[b], kLMRows);
    }
    wg::bar_init_fence();
  }
  if constexpr (kPair == 2)
    wg::cluster_sync();  // both blocks' barriers are initialised
  else
    __syncthreads();

  if (wgi == wg::kConsumers) {
    // producer: item 4c + q of chunk c holds, for q = 0, 1, W1 rows [64c,
    // 64c + 64) x columns col0 + [192q, 192q + 192) (three [64][64] boxes)
    // and, for q = 2, 3, W2 rows col0 + [192 (q - 2), + 192) x columns [64c,
    // 64c + 64) (one [192][64] box)
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int i = 0; i < 4 * n_chunks; ++i) {
        const int s = i % kLMStages, c = i >> 2, q = i & 3;
        wg::bar_wait(&empty[s], ((i / kLMStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kLMStageBytes);
        uint8_t* dst = ring + s * kLMStageBytes;
        if (q < 2) {
          for (int b = 0; b < 3; ++b)
            wg::tma_load(dst + b * wg::kBoxBytes, &w1_map, &full[s],
                         col0 + (3 * q + b) * wg::kBox, c * kLMChunk);
        } else {
          wg::tma_load(dst, &w2_map, &full[s], c * kLMChunk, col0 + (q - 2) * (kLMW / 2));
        }
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    const int warp = t >> 5, lane = t & 31;
    const int cw = 4 * wgi + warp;  // consumer warp, 0 .. 7

    // LayerNorm: consumer warp cw normalises rows [8 cw, 8 cw + 8); lane
    // `lane` holds columns col0 + 2 (lane + 32 i) and the next, i < 6, which
    // lie in box i at column 2 lane
    float sc[12], sh[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int col = col0 + 2 * (lane + 32 * i);
      sc[2 * i] = ln_scale[col];
      sc[2 * i + 1] = ln_scale[col + 1];
      sh[2 * i] = ln_bias[col];
      sh[2 * i + 1] = ln_bias[col + 1];
    }
    if constexpr (kPair == 1) {
      for (int rr = 0; rr < 8; ++rr) {
        const int r = 8 * cw + rr;
        float2 v[6];
        if (m0 + r < m) {
          const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x + (m0 + r) * D);
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            v[i] = unpack_bf16(xrow[lane + 32 * i]);
            sum += v[i].x + v[i].y;
          }
          const float mean = warp_sum(sum) / D;
          float sq = 0.f;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const float a = v[i].x - mean, b = v[i].y - mean;
            sq += a * a + b * b;
          }
          const float rstd = rsqrtf(warp_sum(sq) / D + 1e-6f);
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
    } else {
      // The pair's rows span both blocks' columns: each block sums its half
      // of each row, hands the sum to the other block and adds the two
      // (in either block the same f32 sum of the same two terms), first for
      // the mean, then for the centred sum of squares. Lane rr < 8 keeps row
      // 8 cw + rr's statistic.
      auto row = [&](int rr, float2 (&v)[6]) {
        const int r = 8 * cw + rr;
        const bool valid = m0 + r < m;
        const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x + (m0 + r) * D + col0);
#pragma unroll
        for (int i = 0; i < 6; ++i)
          v[i] = valid ? unpack_bf16(xrow[lane + 32 * i]) : make_float2(0.f, 0.f);
        return valid;
      };
      auto exchange = [&](int k, float own) {
        if (lane < 8) {
          wg::st_peer(wg::peer_addr(&lnx[k * kLMRows + 8 * cw + lane], peer), own);
          wg::bar_arrive_peer(wg::peer_addr(&lnbar[k], peer));
        }
        wg::bar_wait_cluster(&lnbar[k], 0);
        return lane < 8 ? own + lnx[k * kLMRows + 8 * cw + lane] : 0.f;
      };
      float own = 0.f;
      for (int rr = 0; rr < 8; ++rr) {
        float2 v[6];
        row(rr, v);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) sum += v[i].x + v[i].y;
        sum = warp_sum(sum);
        if (lane == rr) own = sum;
      }
      const float mean_l = exchange(0, own) / D;
      for (int rr = 0; rr < 8; ++rr) {
        float2 v[6];
        const float mean = __shfl_sync(0xffffffffu, mean_l, rr);
        float sq = 0.f;
        if (row(rr, v)) {
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const float a = v[i].x - mean, b = v[i].y - mean;
            sq += a * a + b * b;
          }
        }
        sq = warp_sum(sq);
        if (lane == rr) own = sq;
      }
      const float rstd_l = rsqrtf(exchange(1, own) / D + 1e-6f);
      for (int rr = 0; rr < 8; ++rr) {
        float2 v[6];
        const float mean = __shfl_sync(0xffffffffu, mean_l, rr);
        const float rstd = __shfl_sync(0xffffffffu, rstd_l, rr);
        if (row(rr, v)) {
#pragma unroll
          for (int i = 0; i < 6; ++i)
            v[i] = make_float2((v[i].x - mean) * rstd * sc[2 * i] + sh[2 * i],
                               (v[i].y - mean) * rstd * sc[2 * i + 1] + sh[2 * i + 1]);
        }
#pragma unroll
        for (int i = 0; i < 6; ++i)
          wg::st_pair(sY + i * wg::kBoxBytes, 8 * cw + rr, 2 * lane, v[i].x, v[i].y);
      }
    }
    wg::fence_async_smem();
    wg::sync_named(3, 256);  // all of y is written

    // fc1 of chunk c, by warpgroup c % 2: h_pre^T (64 hidden x 64 rows) =
    // W1_c y^T, W1's chunk rows the A operand and y the B operand (both
    // K-major, K = 384 over the chunk's two W1 stages), then
    // GELU_tanh(h_pre + b1) in f32, rounded to bf16 into h box c & 1 as an
    // MN-major [hidden][rows] tile, fc2's transposed A operand. At D = 768
    // the products cover this block's half of K: the warpgroup stores its
    // f32 partial into the other block's xbuf, waits for the other block's
    // partial in its own, and adds the two (the same sum in both blocks)
    // before the GELU.
    float acc[96];  // out[:, col0 + 192 wgi : + 192]
    float hacc[32];
    wg::acc_zero(acc);
    uint32_t y_s = smem_addr(sY), h_s = smem_addr(sH), ring_s = smem_addr(ring);
    if constexpr (kPair == 2) {
      y_s = wg::desc_addr(y_s);
      h_s = wg::desc_addr(h_s);
      ring_s = wg::desc_addr(ring_s);
    }
    auto fc1 = [&](int c) {
      const uint32_t ya = wg::opaque(y_s), ra = wg::opaque(ring_s);
      uint8_t* hbox = sH + (c & 1) * wg::kBoxBytes;
      wg::bar_wait(&hempty[c & 1], ((c >> 1) & 1) ^ 1);  // both fc2 of chunk c - 2 are done
      if constexpr (kPair == 2) {
        // Four stages put item q of every chunk in stage q, used by the two
        // warpgroups in turn, so a parity wait for chunk c's stage must
        // know that chunk c - 1's load has landed. For c >= 2 the wait above
        // says so (the other warpgroup ran fc1(c - 1) before its fc2(c -
        // 2)); for chunk 1, wait until warpgroup 0 has released chunk 0's
        // stages (the phase after that is this warpgroup's own release).
        if (c == 1) {
          wg::bar_wait(&empty[0], 0);
          wg::bar_wait(&empty[1], 0);
        }
      }
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
      if constexpr (kPair == 2) {
        // this warpgroup's j-th fc1 uses buffer j & 1; the other block read
        // that buffer's previous contents (chunk c - 4) before it stored its
        // partial of chunk c - 2, which this warpgroup has waited for
        const int j = c >> 1, b = 2 * wgi + (j & 1);
        float* xb = xbuf + b * (128 * 32) + 4 * t;
        const uint32_t dst = wg::peer_addr(xb, peer);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          wg::st_peer4(dst + i * 128 * 16, hacc[4 * i], hacc[4 * i + 1], hacc[4 * i + 2],
                       hacc[4 * i + 3]);
        wg::bar_arrive_peer(wg::peer_addr(&xfull[b], peer));
        wg::bar_wait_cluster(&xfull[b], (j >> 1) & 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 o = *reinterpret_cast<const float4*>(xb + i * 128 * 4);
          hacc[4 * i] += o.x;
          hacc[4 * i + 1] += o.y;
          hacc[4 * i + 2] += o.z;
          hacc[4 * i + 3] += o.w;
        }
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
      // fc2: out[:, col0 + 192 wgi : + 192] += h W2_c^T, K = 64, from h box
      // c & 1 and this warpgroup's W2 stage
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
      const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b2 + col0 + col));
      float v0 = acc[j] + bb.x, v1 = acc[j + 1] + bb.y;
      if (residual && m0 + row < m) {
        const float2 xr =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(x + (m0 + row) * D + col0 + col));
        v0 += xr.x;
        v1 += xr.y;
      }
      wg::st_pair(sY + (col >> 6) * wg::kBoxBytes, row, col & 63, v0, v1);
    }
    wg::fence_async_smem();
    wg::sync_named(1 + wgi, 128);
    if (t == 0) {
      for (int b = 3 * wgi; b < 3 * wgi + 3; ++b)
        wg::tma_store(&out_map, sY + b * wg::kBoxBytes, col0 + b * wg::kBox, (int)m0);
      wg::tma_store_commit();
      wg::tma_store_wait();
    }
  }
}

// Launches the D-wide kernel: one block per 64 rows at D = 384, a cluster
// of two per 64 rows at D = 768.
template <int D>
cudaError_t launch_ln_mlp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              void* out, long long m, int hid, int residual,
                              cudaStream_t stream) {
  using S = LnMlpShape<D>;
  CUtensorMap w1_map, w2_map, out_map;
  cudaError_t err;
  if ((err = tensor_map(&w1_map, w1, hid, D, wg::kBox)) != cudaSuccess) return err;
  if ((err = tensor_map(&w2_map, w2, D, hid, kLMW / 2)) != cudaSuccess) return err;
  if ((err = tensor_map(&out_map, out, m, D, wg::kBox)) != cudaSuccess) return err;
  auto kernel = ln_mlp_fwd_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (m + kLMRows - 1) / kLMRows;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sc = static_cast<const float*>(ln_scale);
  const auto* sh = static_cast<const float*>(ln_bias);
  const auto* b1b = static_cast<const __nv_bfloat16*>(b1);
  const auto* b2b = static_cast<const __nv_bfloat16*>(b2);
  if constexpr (S::kPair == 1) {
    kernel<<<(unsigned)blocks, wg::kThreads, S::kSmem, stream>>>(
        w1_map, w2_map, out_map, xb, sc, sh, b1b, b2b, m, hid, residual);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(S::kPair * blocks));
    cfg.blockDim = dim3(wg::kThreads);
    cfg.dynamicSmemBytes = S::kSmem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S::kPair;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, w1_map, w2_map, out_map, xb, sc, sh, b1b, b2b, m, hid,
                             residual);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: x and out (M, D) bf16,
// D = 384 or 768, ln_scale and ln_bias (D,) f32, w1 (HID, D) and w2 (D, HID)
// in nn.Linear layout, b1 (HID,) and b2 (D,), all bf16 unless stated and
// contiguous. Returns a cudaError_t: the launch's (or a TMA descriptor's), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int dcvit_ln_mlp_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* out, long long m, int d, int hid, int residual,
                                void* stream) {
  using namespace dcvit;
  if ((d != 384 && d != 768) || hid % kLMChunk != 0 || hid < kLMChunk || m < 1 ||
      m > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d == 384 ? launch_ln_mlp_fwd<384>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, m,
                                                 hid, residual, st)
                        : launch_ln_mlp_fwd<768>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, m,
                                                 hid, residual, st));
}
