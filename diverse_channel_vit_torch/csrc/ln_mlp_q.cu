// int8 ln_mlp forward: LayerNorm, int8 fc1, tanh-GELU, int8 fc2, bias and
// optional residual in one launch (`model.quantization = int8`).
//
// Replaces the TPU kernel `_ln_mlp_q_fwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:474), reached through
// `_ln_mlp_q_fwd_impl` (:490) and `ln_mlp(..., quantized=True)`.
//
// Arithmetic, as the TPU kernel's: y = LayerNorm(x) in f32 (eps 1e-6); y is
// quantised per row to int8 (scale max(max|y| / 127, 1e-8), codes
// round-half-even(y / s)); acc = yq W1q^T in int32; h_pre = (acc * ys) * s1c
// + b1 in f32; h = GELU_tanh(h_pre); h quantised per row the same way;
// out = (float(hq W2q^T) * hs) * s2c + b2 (+ x), rounded to bf16 once. W1q
// (HID, D) and W2q (D, HID) are per-output-unit int8 copies of the bf16
// weights, k-major as nn.Linear holds them. The rounding steps are int8.cuh's
// exact helpers (tanhf, IEEE division), as in S3 (int8_ln_mlp.cu) and B8, so
// the three write the same codes.
//
// What bounds it on an H100. The products: 4 M D HID int8 operations, 0.12
// ms at the dense int8 peak for B = 64, N = 1600 (1569 real rows), D = 384,
// HID = 1536, against 0.16 GB of compulsory traffic (0.05 ms). Behind them
// an epilogue on the FP32 pipes that the bound does not count: a GELU with
// tanhf and a quantisation by IEEE division per hidden element in pass 2
// (below), and pass 1's dequantisation and row max (chip_smoke.py counts
// their instructions from the SASS and prints an estimate of their issue
// time, about twice the products'). So the design drops every GELU of
// pass 1 it can prove unneeded, keeps the epilogue's instructions issuing
// and hides the products under them.
//
// Design (wgmma_core.cuh), and what differs from the TPU kernel:
// - Quantising h needs each row's max|h| over all HID hidden units before
//   fc2's first product. The TPU held a row block's h in VMEM; 64 rows of f32
//   h would take 384 KB here. So fc1 runs twice: pass 1 keeps each row's
//   running max|h|; pass 2 recomputes h with the same instructions (the int32
//   sums are exact and order-free), quantises it with the now-known scale and
//   feeds fc2. (S3 computes h once on 16-row blocks of `mma.sync`.)
// - B3's block shape (ln_mlp.cu): 64 rows, two consumer warpgroups and a
//   producer warpgroup whose one thread streams the int8 weights by TMA
//   through a six-stage ring of 24 KB stages (a W1q chunk: 64 hidden units
//   over all of D; or a W2q half: 192 rows of D over 128 hidden units), each
//   read by one warpgroup; 1.8 MB a block, from L2.
// - LayerNorm and y's row quantisation (`ln_row`, `quant_pairs`, one warp a
//   row as in S3 and B8) write yq into three swizzled K-major [64][128 B]
//   boxes, the A operand of every fc1 (8-bit wgmma takes both operands
//   K-major, so the product is rows x hidden, where B3's is hidden x rows).
// - fc1 of a 64-unit chunk is one warpgroup's m64n64 s32 product (K = 384),
//   the warpgroups taking alternate chunks. Pass 1 needs only each row's
//   max|h|. Since gelu_tanh_rn is non-decreasing on [0, inf) and small
//   below 0 (int8.cuh, kGeluPosDominates; checked on every float), that is
//   GELU at the row's largest h_pre once this passes 0.3, so pass 1 keeps
//   the largest h_pre and evaluates GELU on every element of a warpgroup's
//   first chunk only (and of a row still below 0.3): the max stays exact
//   and nearly all of pass 1's GELUs go. The two warpgroups' maxima meet in
//   shared memory at the pass boundary.
// - Pass 2 walks pairs of chunks (128 hidden units, one 128-byte row of an
//   hq box): warpgroup w computes chunk 2p + w and quantises it into columns
//   [64 w, + 64) of hq box p % 2; both then add out[:, 192 w : + 192] +=
//   hq_p W2q_p^T (m64n192, K = 128, 96 s32 registers; 128 a thread with
//   fc1's 32, as in B3). A warpgroup issues fc1 of pair p + 1 and fc2 of
//   pair p together, then quantises pair p + 1 while fc2 of pair p runs.
//   The hq boxes pass between the warpgroups through full and empty
//   mbarriers.
// - The epilogue dequantises, adds b2 (and x) and rounds to bf16 once, in
//   the plain version's order, stages the tile in the warpgroup's last W2q
//   stage and stores it by TMA, which clips a ragged last tile.
// On an H100 it runs at about 9x its bound: besides the epilogue, a block
// normalises its 64 rows before its first product, and its ring waits on
// TMA round trips rather than bytes (a third of the weight bytes changed
// little; PERF.md). Slower there: skipping pass-1 GELUs element by element
// (warp divergence), prefetching the LayerNorm's rows, issuing fc2 before
// fc1; a seventh ring stage gained nothing.
// With `codes` set the kernel also writes hq (M, HID), the codes fc2 read,
// and with `h_out` h rounded to bf16 (M, HID): outputs for checks only.
// h is stored where pass 2 quantises it, in the instantiation kH = true,
// which the launch picks only for `h_out`: the same source as the main
// path's kH = false apart from that store, whose two registers would make
// the main path's pass 2 spill (ptxas caps a consumer at 168 registers).
// kH = true spills 32 bytes instead; its output and codes equal kH =
// false's bit for bit (the gpu tests and chip_smoke.py check it).
#include "int8.cuh"
#include "wgmma_core.cuh"

namespace dcvit {

constexpr int kQFD = 384;                          // model width (the one built)
constexpr int kQFRows = 64;                        // rows per block
constexpr int kQFChunk = 64;                       // hidden units of one fc1 product
constexpr int kQFStages = 6;                       // ring stages
constexpr int kQFStageBytes = 3 * wg::kBoxBytes;   // 24 KB: a W1q chunk or a W2q half
constexpr int kQFYBytes = (kQFD / 128) * wg::kBoxBytes;  // yq: three [64][128 B] boxes
constexpr int kQFSmem = kQFYBytes + 2 * wg::kBoxBytes + kQFStages * kQFStageBytes +
                        4 * 3 * kQFRows + (2 * kQFStages + 4) * 8 + wg::kAlign;

template <bool kH>
__global__ void __launch_bounds__(wg::kThreads, 1)
    ln_mlp_q_fwd_kernel(const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ CUtensorMap out_map,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                        const float* __restrict__ ln_bias, const float* __restrict__ s1c,
                        const __nv_bfloat16* __restrict__ b1, const float* __restrict__ s2c,
                        const __nv_bfloat16* __restrict__ b2, int8_t* __restrict__ codes,
                        __nv_bfloat16* __restrict__ h_out, long long m, int hid, int residual) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sY = wg::align(smem_raw);              // yq: 3 boxes of [64][128 B]
  uint8_t* sH = sY + kQFYBytes;                   // hq: 2 boxes of [64][128 B], used in turn
  uint8_t* ring = sH + 2 * wg::kBoxBytes;         // [6 stages][24 KB]
  float* sYs = reinterpret_cast<float*>(ring + kQFStages * kQFStageBytes);  // y's row scales
  float* sMax = sYs + kQFRows;                    // [2 warpgroups][64 rows]: pass 1's max|h|
  uint64_t* full = reinterpret_cast<uint64_t*>(sMax + 2 * kQFRows);
  uint64_t* empty = full + kQFStages;
  uint64_t* hfull = empty + kQFStages;  // [2]: both halves of an hq box written
  uint64_t* hempty = hfull + 2;         // [2]: an hq box read by both warpgroups' fc2

  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const long long m0 = (long long)blockIdx.x * kQFRows;
  const int n_chunks = hid / kQFChunk, n_pairs = n_chunks / 2;

  if (tid == 0) {
    for (int s = 0; s < kQFStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 1);  // its one reader warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      wg::bar_init(&hfull[b], wg::kConsumers);
      wg::bar_init(&hempty[b], wg::kConsumers);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (wgi == wg::kConsumers) {
    // producer: item i < n_chunks is pass 1's W1q chunk i (rows [64 i, + 64),
    // three [64][128] boxes); item n_chunks + 4p + q is pass 2's W1q chunk
    // 2p + q for q = 0, 1, and for q = 2, 3 W2q rows [192 (q - 2), + 192) x
    // hidden [128 p, + 128). Item i's reader is warpgroup i % 2 (n_chunks is
    // even).
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      for (int i = 0; i < 3 * n_chunks; ++i) {
        const int s = i % kQFStages, j = i - n_chunks;
        wg::bar_wait(&empty[s], ((i / kQFStages) & 1) ^ 1);
        wg::bar_expect_tx(&full[s], kQFStageBytes);
        uint8_t* dst = ring + s * kQFStageBytes;
        if (j < 0 || (j & 3) < 2) {
          const int c = j < 0 ? i : 2 * (j >> 2) + (j & 3);
          for (int b = 0; b < 3; ++b)
            wg::tma_load(dst + b * wg::kBoxBytes, &w1_map, &full[s], 128 * b, c * kQFChunk);
        } else {
          wg::tma_load(dst, &w2_map, &full[s], 128 * (j >> 2), ((j & 3) - 2) * (kQFD / 2));
        }
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    const int warp = t >> 5, lane = t & 31;
    const int cw = 4 * wgi + warp;  // consumer warp, 0 .. 7

    // LayerNorm and y's row quantisation: consumer warp cw takes rows
    // [8 cw, 8 cw + 8); lane `lane` holds the code pairs at byte columns
    // 2 lane + 64 i, i < 6, which lie in box i / 2 at column 2 lane + 64 (i % 2)
    for (int rr = 0; rr < 8; ++rr) {
      const int r = 8 * cw + rr;
      char2 q[kQFD / 64];
      float ys = 1.f;
      if (m0 + r < m) {
        float2 v[kQFD / 64];
        float mean, rstd;
        ln_row<kQFD>(x + (m0 + r) * kQFD, ln_scale, ln_bias, lane, v, mean, rstd);
        ys = quant_pairs(v, q);
      } else {
#pragma unroll
        for (int i = 0; i < kQFD / 64; ++i) q[i] = make_char2(0, 0);
      }
#pragma unroll
      for (int i = 0; i < kQFD / 64; ++i)
        *reinterpret_cast<char2*>(sY + (i >> 1) * wg::kBoxBytes +
                                  wg::swz_b(r, 2 * lane + 64 * (i & 1))) = q[i];
      if (lane == 0) sYs[r] = ys;
    }
    wg::fence_async_smem();
    wg::sync_named(3, 256);  // all of yq and its scales are written

    const int hr = wg::acc_row(t, 0);  // this thread's rows: hr and hr + 8
    const float ys_a = sYs[hr], ys_b = sYs[hr + 8];
    const uint32_t y_s = smem_addr(sY), h_s = smem_addr(sH), ring_s = smem_addr(ring);
    int hacc[32];  // fc1: 64 rows x the chunk's 64 hidden units
    int acc[96];   // fc2: out[:, 192 wgi : 192 wgi + 192]

    // the shared address of the W1q chunk in ring item `item`, once loaded
    auto w1_stage = [&](int item) {
      const int s = item % kQFStages;
      wg::bar_wait(&full[s], (item / kQFStages) & 1);
      return wg::opaque(ring_s) + s * kQFStageBytes;
    };
    // fc1 of the chunk at `wa`: hacc = yq W1q_c^T (K = 384)
    auto fc1 = [&](uint32_t wa) {
      const uint32_t ya = wg::opaque(y_s);
#pragma unroll
      for (int ks = 0; ks < 12; ++ks)
        wg::mma_s8_m64n64(hacc, wg::desc_k(ya + (ks >> 2) * wg::kBoxBytes, ks & 3),
                          wg::desc_k(wa + (ks >> 2) * wg::kBoxBytes, ks & 3), ks > 0);
    };
    // h_pre of hacc's elements i, i + 1 (one row, two adjacent units) of chunk c
    auto h_pre = [&](int c, int i, float& p0, float& p1) {
      const int hc = c * kQFChunk + wg::acc_col(t, i);
      const float ys = (i & 2) ? ys_b : ys_a;
      const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + hc));
      p0 = __fadd_rn(dequant(hacc[i], ys, s1c[hc]), bb.x);
      p1 = __fadd_rn(dequant(hacc[i + 1], ys, s1c[hc + 1]), bb.y);
    };

    // pass 1: chunks wgi, wgi + 2, ...; each row's exact max|h|, with GELU
    // evaluated only where it can matter: gelu_tanh_rn is non-decreasing on
    // [0, inf), so the positive inputs need it at their max alone, and the
    // negative ones (|GELU| < 0.171) only while the row's max input is below
    // kGeluPosDominates (int8.cuh). So a thread keeps its rows' max h_pre
    // (shared by the quad after each chunk) and evaluates GELU on every
    // element only in its warpgroup's first chunk and in a row still below
    // that bound (rare, and warp-divergent).
    float rmax_a = 0.f, rmax_b = 0.f, pmax_a = 0.f, pmax_b = 0.f;
    for (int c = wgi; c < n_chunks; c += 2) {
      const uint32_t wa = w1_stage(c);
      wg::mma_fence();
      fc1(wa);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::acc_fence(hacc);
      if (t == 0) wg::bar_arrive(&empty[c % kQFStages]);
      const bool all = c == wgi;
      const bool low_a = pmax_a < kGeluPosDominates, low_b = pmax_b < kGeluPosDominates;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float p0, p1;
        h_pre(c, i, p0, p1);
        const bool lower = i & 2;
        if (all || ((lower ? low_b : low_a) && fminf(p0, p1) < 0.f)) {
          const float h0 = gelu_tanh_rn(p0), h1 = gelu_tanh_rn(p1);
          const float a = fmaxf(fabsf(h0), fabsf(h1));
          if (lower)
            rmax_b = fmaxf(rmax_b, a);
          else
            rmax_a = fmaxf(rmax_a, a);
        }
        if (lower)
          pmax_b = fmaxf(pmax_b, fmaxf(p0, p1));
        else
          pmax_a = fmaxf(pmax_a, fmaxf(p0, p1));
      }
      pmax_a = quad_max(pmax_a);
      pmax_b = quad_max(pmax_b);
    }
    rmax_a = quad_max(fmaxf(rmax_a, gelu_tanh_rn(pmax_a)));
    rmax_b = quad_max(fmaxf(rmax_b, gelu_tanh_rn(pmax_b)));
    if ((t & 3) == 0) {
      sMax[wgi * kQFRows + hr] = rmax_a;
      sMax[wgi * kQFRows + hr + 8] = rmax_b;
    }
    wg::sync_named(3, 256);
    const float hs_a = row_scale(fmaxf(sMax[hr], sMax[kQFRows + hr]));
    const float hs_b = row_scale(fmaxf(sMax[hr + 8], sMax[kQFRows + hr + 8]));

    // pass 2. hq of pair p: this warpgroup's chunk 2p + wgi (in hacc),
    // quantised into columns [64 wgi, + 64) of hq box p % 2 (with kH, h is
    // stored too, and with `codes` the codes are copied from the box)
    auto quantise = [&](int p) {
      const int c = 2 * p + wgi;
      uint8_t* box = sH + (p & 1) * wg::kBoxBytes;
      wg::bar_wait(&hempty[p & 1], ((p >> 1) & 1) ^ 1);  // both fc2 of pair p - 2 are done
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float p0, p1;
        h_pre(c, i, p0, p1);
        const float hs = (i & 2) ? hs_b : hs_a;
        const float h0 = gelu_tanh_rn(p0), h1 = gelu_tanh_rn(p1);
        const int row = wg::acc_row(t, i), col = wg::acc_col(t, i);
        *reinterpret_cast<char2*>(box + wg::swz_b(row, 64 * wgi + col)) =
            make_char2(quant_s8(h0, hs), quant_s8(h1, hs));
        if (kH && m0 + row < m)
          *reinterpret_cast<uint32_t*>(h_out + (m0 + row) * hid + c * kQFChunk + col) =
              pack_bf16(h0, h1);
      }
      wg::fence_async_smem();
      wg::sync_named(1 + wgi, 128);
      if (t == 0) wg::bar_arrive(&hfull[p & 1]);
      if (codes != nullptr) {
        for (int k = t; k < 4 * kQFRows; k += 128) {  // 16-byte pieces of the half
          const int row = k >> 2, piece = 4 * wgi + (k & 3);
          if (m0 + row < m)
            *reinterpret_cast<uint4*>(codes + (m0 + row) * hid + 128 * p + 16 * piece) =
                *reinterpret_cast<const uint4*>(box + wg::swz_b(row, 16 * piece));
        }
      }
    };
    // the shared address of pair p's hq box and this warpgroup's W2q stage,
    // once both are ready
    auto fc2_stage = [&](int p) {
      wg::bar_wait(&hfull[p & 1], (p >> 1) & 1);
      const int item = n_chunks + 4 * p + 2 + wgi, s = item % kQFStages;
      wg::bar_wait(&full[s], (item / kQFStages) & 1);
      return wg::opaque(ring_s) + s * kQFStageBytes;
    };
    // fc2 of pair p: acc += hq_p W2q_p^T over this warpgroup's 192 columns
    auto fc2 = [&](int p, uint32_t wa) {
      const uint32_t hb = wg::opaque(h_s) + (p & 1) * wg::kBoxBytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wg::mma_s8_m64n192(acc, wg::desc_k(hb, ks), wg::desc_k(wa, ks), 1);
    };
    auto fc2_done = [&](int p) {
      if (t == 0) {
        wg::bar_arrive(&empty[(n_chunks + 4 * p + 2 + wgi) % kQFStages]);
        wg::bar_arrive(&hempty[p & 1]);
      }
    };
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0;
    uint32_t wa = w1_stage(n_chunks + wgi);
    wg::mma_fence();
    fc1(wa);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(hacc);
    if (t == 0) wg::bar_arrive(&empty[(n_chunks + wgi) % kQFStages]);
    quantise(0);
    // fc1 of pair p + 1 and fc2 of pair p in flight together; pair p + 1's
    // GELU and quantisation run while fc2 of pair p is on the tensor cores
    for (int p = 0; p + 1 < n_pairs; ++p) {
      const int item = n_chunks + 4 * (p + 1) + wgi;
      wa = w1_stage(item);
      wg::mma_fence();
      fc1(wa);
      wg::mma_commit();
      wa = fc2_stage(p);
      wg::mma_fence();
      fc2(p, wa);
      wg::mma_commit();
      wg::mma_wait<1>();
      wg::acc_fence(hacc);
      if (t == 0) wg::bar_arrive(&empty[item % kQFStages]);
      quantise(p + 1);
      wg::mma_wait<0>();
      wg::acc_fence(acc);
      fc2_done(p);
    }
    wa = fc2_stage(n_pairs - 1);
    wg::mma_fence();
    fc2(n_pairs - 1, wa);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(acc);
    fc2_done(n_pairs - 1);

    // out = (acc * hs) * s2c + b2 (+ x), rounded once, staged in this
    // warpgroup's last W2q stage (its last fc2 is done and the producer has
    // nothing left to load), then stored by TMA
    uint8_t* stO =
        ring + ((n_chunks + 4 * (n_pairs - 1) + 2 + wgi) % kQFStages) * kQFStageBytes;
#pragma unroll
    for (int j = 0; j < 96; j += 2) {
      const int row = wg::acc_row(t, j), lc = wg::acc_col(t, j), col = (kQFD / 2) * wgi + lc;
      const float hs = (j & 2) ? hs_b : hs_a;
      const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b2 + col));
      float v0 = __fadd_rn(dequant(acc[j], hs, s2c[col]), bb.x);
      float v1 = __fadd_rn(dequant(acc[j + 1], hs, s2c[col + 1]), bb.y);
      if (residual && m0 + row < m) {
        const float2 xr =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(x + (m0 + row) * kQFD + col));
        v0 = __fadd_rn(v0, xr.x);
        v1 = __fadd_rn(v1, xr.y);
      }
      wg::st_pair(stO + (lc >> 6) * wg::kBoxBytes, row, lc & 63, v0, v1);
    }
    wg::fence_async_smem();
    wg::sync_named(1 + wgi, 128);
    if (t == 0) {
      for (int b = 0; b < 3; ++b)
        wg::tma_store(&out_map, stO + b * wg::kBoxBytes, (kQFD / 2) * wgi + b * wg::kBox,
                      (int)m0);
      wg::tma_store_commit();
      wg::tma_store_wait();
    }
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: x and out (M, D) bf16;
// ln_scale, ln_bias (D,) f32; w1q (HID, D) int8 with s1c (HID,) f32; b1
// (HID,) bf16; w2q (D, HID) int8 with s2c (D,) f32; b2 (D,) bf16; codes
// (M, HID) int8 or null; h_out (M, HID) bf16 or null. All contiguous.
// Returns a cudaError_t: the launch's (or a TMA descriptor's), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int dcvit_ln_mlp_q_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1q, const void* s1c, const void* b1,
                                  const void* w2q, const void* s2c, const void* b2, void* out,
                                  void* codes, void* h_out, long long m, int d, int hid,
                                  int residual, void* stream) {
  using namespace dcvit;
  if (d != kQFD || hid % (2 * kQFChunk) != 0 || hid < 2 * kQFChunk || m < 1 ||
      m > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap w1_map, w2_map, out_map;
  cudaError_t err;
  if ((err = tensor_map(&w1_map, w1q, hid, kQFD, kQFChunk, s8)) != cudaSuccess) return (int)err;
  if ((err = tensor_map(&w2_map, w2q, kQFD, hid, kQFD / 2, s8)) != cudaSuccess) return (int)err;
  if ((err = tensor_map(&out_map, out, m, kQFD, wg::kBox)) != cudaSuccess) return (int)err;
  auto kernel = h_out != nullptr ? ln_mlp_q_fwd_kernel<true> : ln_mlp_q_fwd_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQFSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (m + kQFRows - 1) / kQFRows;
  kernel<<<(unsigned)blocks, wg::kThreads, kQFSmem, static_cast<cudaStream_t>(stream)>>>(
      w1_map, w2_map, out_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const float*>(s1c), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const float*>(s2c), static_cast<const __nv_bfloat16*>(b2),
      static_cast<int8_t*>(codes), static_cast<__nv_bfloat16*>(h_out), m, hid, residual);
  return (int)cudaGetLastError();
}

// gelu_tanh_rn as ln_mlp_q_fwd_kernel evaluates it, of the n floats whose
// bit patterns follow lo: out[i] = gelu_tanh_rn(bits lo + i). For checking
// the facts pass 1 relies on (int8.cuh, kGeluPosDominates) on every float.
namespace dcvit {
__global__ void gelu_table_kernel(float* __restrict__ out, unsigned lo, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = gelu_tanh_rn(__uint_as_float(lo + (unsigned)i));
}
}  // namespace dcvit

extern "C" int dcvit_gelu_tanh_rn_table(void* out, unsigned lo, long long n, void* stream) {
  if (n < 1 || n > (1LL << 32)) return (int)cudaErrorInvalidValue;
  dcvit::gelu_table_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), lo,
                                                                  n);
  return (int)cudaGetLastError();
}
