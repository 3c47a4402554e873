// The D = 768 ln_mlp kernels' building blocks (ln_mlp.cu's B3 and
// ln_mlp_bwd.cu's B4): the LayerNorm row pass and one `wgmma` + TMA GEMM on
// 128 x 256 output tiles with its element-wise work in the epilogue. The
// GEMM is also attend_project.cu's projection (B1).
//
// `ln_rows_kernel<D>`: LayerNorm in f32 (two-pass, eps 1e-6), one warp a
// row, -> y (bf16) and each row's mean and rstd (f32). B4 runs it at both
// widths, B3 at 768.
//
// `gemm_kernel<Epi, kBmn>`: C (M x N) = A (M x K) B^T, A row-major
// (K-major), B K-major ([N][K], an nn.Linear weight) or, with kBmn, MN-major
// ([K][N]); f32 sums in registers. `Epi` turns a tile's accumulators into
// bf16 in shared memory, which TMA stores (clipping rows and columns past
// the ends), or (kDirect) stores them from registers itself.
// - A block owns a 128 x 256 tile: two consumer warpgroups, each the
//   `wgmma` m64n256k16 of its 64 rows (128 accumulator registers a thread),
//   and one producer thread keeping a four-stage TMA ring full: per 64-deep
//   k-step an A box [128][64] (16 KB) and B's 256 columns (32 KB), 192 KB in
//   all. Three stages, with the output tiles in a buffer of their own, ran
//   slower: the ring's depth covers the loads' latency.
// - The blocks of two adjacent row tiles form a cluster and share the B
//   tile: each loads half of it and multicasts it to both. Every
//   block's full barrier expects the whole stage; a stage is refilled only
//   once the consumers of both blocks have released it (each consumer
//   warpgroup arrives on both blocks' empty barriers, with the default
//   CTA-scope release: a cluster-scope one on that path made fc2 1.8x
//   slower). A block then loads 32 KB from L2 per 4.2 MFLOP k-step, 128
//   FLOP a byte (85 alone); on B3's fc2 that measured 10% faster than
//   without the cluster, on fc1 no faster.
// - ptxas (nvcc 12.9, sm_90a): 168 registers a thread, 44-68 bytes of
//   spill stores in each instantiation; a 64-deep k-step takes about 0.8-0.95
//   us on an H100 80GB HBM3 at 700 W (0.56 at the peak rate).
// - Persistent: as many pairs as fit on the card at once (a block an SM),
//   each walking its tiles column-fastest, so the blocks in flight share
//   a few A row tiles and B stays in L2. The producer runs on into the next
//   tile while the consumers finish this one: the stages of a tile's last
//   two k-steps stay held, warpgroup w writing its 64 x 256 output tile (32
//   KB) into the w-th, until the next tile's first products are issued and
//   the TMA store has read them. (Storing the bf16 tiles from registers
//   instead, without holding stages, made fc1 about 20% slower.)
//   A K of 64 runs a second k-step of zeros (TMA's out-of-bounds fill) so
//   that there are two stages to hold.
// - Row tiles are padded to the pair; a padded block loads zeros, takes its
//   part in the pair's loads and stores nothing.
#pragma once

#include "wgmma_core.cuh"

namespace dcvit {

// ---- LayerNorm rows -------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
    ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ stats, long long m) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= m) return;
  const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x + r * D);
  uint32_t* yrow = reinterpret_cast<uint32_t*>(y + r * D);
  float2 v[D / 64];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    v[i] = unpack_bf16(xrow[lane + 32 * i]);
    sum += v[i].x + v[i].y;
  }
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const float a = v[i].x - mean, c = v[i].y - mean;
    sq += a * a + c * c;
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + 1e-6f);
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    const int col = 2 * (lane + 32 * i);
    yrow[lane + 32 * i] = pack_bf16((v[i].x - mean) * rstd * ln_scale[col] + ln_bias[col],
                                    (v[i].y - mean) * rstd * ln_scale[col + 1] + ln_bias[col + 1]);
  }
  if (lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = rstd;
  }
}

template <int D>
inline cudaError_t launch_ln_rows(const void* x, const void* ln_scale, const void* ln_bias,
                                  void* y, void* stats, long long m, cudaStream_t st) {
  ln_rows_kernel<D><<<(unsigned)((m + 7) / 8), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(stats), m);
  return cudaGetLastError();
}

// ---- the GEMM -----------------------------------------------------------------------

namespace gm {

constexpr int kTileM = 128, kTileN = 256;
constexpr int kABytes = kTileM * 128;   // A [128 rows][64 k]
constexpr int kBBytes = kTileN * 128;   // B: [256][64 k] K-major, or four [64 k][64] MN-major
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 4;
constexpr int kOutBytes = 4 * wg::kBoxBytes;  // a warpgroup's 64 x 256 bf16 output tile
// the ring, its barriers and the epilogues' two (one a consumer warpgroup)
constexpr int kSmem = kStages * kStageBytes + (2 * kStages + 2) * 8 + wg::kAlign;

// The element (row, col) of a warpgroup's m64n256 accumulators: acc_row /
// acc_col of wgmma_core.cuh hold for every width (the m64n64 pattern
// repeats every 8 columns). Writes the bf16 pair (col even) of a
// warpgroup's 64 x 256 output tile, four swizzled [64][64] boxes at `out`.
DEV void st_out(uint8_t* out, int row, int col, float lo, float hi) {
  wg::st_pair(out + (col >> 6) * wg::kBoxBytes, row, col & 63, lo, hi);
}

}  // namespace gm

// The B3 epilogues run over their accumulators in four chunks of 32, a
// memory barrier for the compiler after each, so that it does not hoist
// every chunk's loads ahead of the first and run out of registers.
DEV void chunk_barrier() { asm volatile("" ::: "memory"); }

// fc1 of the forward: h = GELU_tanh(acc + b1) (b1 bf16; columns past n get 0).
struct EpiGelu {
  struct Params {
    const __nv_bfloat16* b1;
    int n;
  };
  static constexpr bool kDirect = false;
  DEV static void apply(float (&acc)[128], const Params& p, uint8_t* const (&held)[2], int t,
                        int wgi, int, int n0, long long, uint64_t*, int) {
    uint8_t* out = held[wgi];
#pragma unroll
    for (int c = 0; c < 128; c += 32) {
#pragma unroll
      for (int i = c; i < c + 32; i += 2) {
        const int lc = wg::acc_col(t, i), col = n0 + lc;
        const float2 bb = col < p.n
                              ? unpack_bf16(*reinterpret_cast<const uint32_t*>(p.b1 + col))
                              : make_float2(0.f, 0.f);
        gm::st_out(out, wg::acc_row(t, i), lc, wg::gelu(acc[i] + bb.x),
                   wg::gelu(acc[i + 1] + bb.y));
      }
      chunk_barrier();
    }
  }
};

// fc2 of the forward, and B1's projection: out = acc + b2
// (+ x), in f32, rounded once (x and the output (M, n) row-major, n a
// multiple of 64; where n is no multiple of 256, the last tile's chunks of
// 64 columns past n read neither b2 nor x, and their stores are clipped).
// The warpgroup's 64 x 256 tile of x comes by TMA into its held stage,
// where its output then overwrites it in place: one bulk load a tile. Read
// from device memory a bf16 pair a thread at a time, x kept the tensor
// cores idle for about as long as a 768-deep tile's products (B1's
// projection at D = 768: 0.46 ms against 0.27 on an H100; B3's fc2: 0.89
// against 0.71).
struct EpiBiasResidual {
  struct Params {
    CUtensorMap x_map;  // x in [64][64] boxes, read when residual
    const __nv_bfloat16* b2;
    int n, residual;
  };
  static constexpr bool kDirect = false;
  DEV static void apply(float (&acc)[128], const Params& p, uint8_t* const (&held)[2], int t,
                        int wgi, int m0, int n0, long long m, uint64_t* bar, int phase) {
    uint8_t* out = held[wgi];
    const int r0 = m0 + 64 * wgi;  // the warpgroup's first row
    const bool res = p.residual && r0 < m;
    if (t == 0) {
      if (res) {
        const int boxes = min(gm::kTileN, p.n - n0) / wg::kBox;
        wg::bar_expect_tx(bar, boxes * wg::kBoxBytes);
        for (int j = 0; j < boxes; ++j)
          wg::tma_load(out + j * wg::kBoxBytes, &p.x_map, bar, n0 + j * wg::kBox, r0);
      } else {
        wg::bar_arrive(bar);
      }
    }
    wg::bar_wait(bar, phase);
    const int ra = wg::acc_row(t, 0);  // this thread's rows: ra and ra + 8
#pragma unroll
    for (int c = 0; c < 128; c += 32) {
      if (n0 + 2 * c >= p.n) break;  // chunk c: the tile's columns 2c .. 2c + 63
#pragma unroll
      for (int i = c; i < c + 32; i += 2) {
        const int lc = wg::acc_col(t, i), row = ra + 8 * ((i >> 1) & 1);
        const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(p.b2 + n0 + lc));
        float v0 = acc[i] + bb.x, v1 = acc[i + 1] + bb.y;
        uint8_t* box = out + (lc >> 6) * wg::kBoxBytes;
        if (res) {
          const float2 xr =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(box + wg::swz(row, lc & 63)));
          v0 += xr.x;
          v1 += xr.y;
        }
        wg::st_pair(box, row, lc & 63, v0, v1);
      }
      chunk_barrier();
    }
  }
};

// dy of the backward: the f32 sums as they are, stored from registers (a
// quad's four lanes write 32 contiguous bytes of a row); (M, n) row-major.
struct EpiStoreF32 {
  struct Params {
    float* c;
    int n;
  };
  static constexpr bool kDirect = true;
  DEV static void apply(float (&acc)[128], const Params& p, uint8_t* const (&)[2], int t,
                        int wgi, int m0, int n0, long long m, uint64_t*, int) {
    const int ra = wg::acc_row(t, 0);
    const long long r0 = (long long)m0 + 64 * wgi + ra;
    float* ca = p.c + r0 * p.n + n0;
    float* cb = ca + 8LL * p.n;
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int b = (i >> 1) & 1;
      if (r0 + 8 * b < m)
        *reinterpret_cast<float2*>((b ? cb : ca) + wg::acc_col(t, i)) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
};

template <class Epi, bool kBmn>
__global__ void __launch_bounds__(wg::kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                const __grid_constant__ CUtensorMap c_map,
                const __grid_constant__ typename Epi::Params p,
                long long m, int n_tiles, int n_steps, int pair_tiles) {
  using namespace gm;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* epi_bar = empty + kStages;  // one a consumer warpgroup
  const int tid = threadIdx.x, wgi = wg::warpgroup(), t = tid & 127;
  const int rank = (int)wg::cluster_rank();
  // pair tile ct (two row tiles, one column tile): pairs walk the column
  // tiles first; this pair's are blockIdx.x / 2, + gridDim.x / 2, ...
  // (tile counts and row offsets fit an int: m < 2^31)
  const int ct0 = blockIdx.x / 2, ct_step = gridDim.x / 2;
  auto tile = [&](int ct, int& m0, int& n0) {
    n0 = ct % n_tiles * kTileN;
    m0 = (ct / n_tiles * 2 + rank) * kTileM;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 2 * wg::kConsumers);
    }
    for (int w = 0; w < wg::kConsumers; ++w) wg::bar_init(&epi_bar[w], 1);
    wg::bar_init_fence();
  }
  wg::cluster_sync();  // both blocks' barriers are initialised

  if (wgi == wg::kConsumers) {
    // producer: every tile's k-steps in turn, running ahead into the next
    // tile while the consumers finish this one
    wg::regs_dealloc<wg::kProducerRegs>();
    if (t == 0) {
      int s = 0, phase = 0;  // the next stage to fill and its parity
      for (int ct = ct0; ct < pair_tiles; ct += ct_step) {
        int m0, n0;
        tile(ct, m0, n0);
        for (int ks = 0; ks < n_steps; ++ks, s = (s + 1) % kStages, phase ^= s == 0) {
          wg::bar_wait(&empty[s], phase ^ 1);
          wg::bar_expect_tx(&full[s], kStageBytes);
          uint8_t* st = ring + s * kStageBytes;
          wg::tma_load(st, &a_map, &full[s], ks * wg::kBox, m0);
          // B: [128][64] halves (K-major) or [64][64] quarters (MN-major),
          // each block loading half of them into both
          constexpr int kParts = kBmn ? kTileN / wg::kBox : 2;
          for (int j = rank * kParts / 2; j < (rank + 1) * kParts / 2; ++j)
            wg::tma_load_multicast(st + kABytes + j * (kBBytes / kParts), &b_map, &full[s],
                                   kBmn ? n0 + j * wg::kBox : ks * wg::kBox,
                                   kBmn ? ks * wg::kBox : n0 + j * (kTileN / 2), (uint16_t)3);
        }
      }
    }
  } else {
    wg::regs_alloc<wg::kConsumerRegs>();
    // a stage is free once this warpgroup of both blocks is done with it
    auto release = [&](int s) {
      if (t != 0) return;
      for (int r = 0; r < 2; ++r) wg::bar_arrive_remote(wg::peer_addr(&empty[s], r));
    };
    const uint32_t ring_s = wg::desc_addr(smem_addr(ring));
    int s = 0, phase = 0;  // the next stage to consume and its parity
    int epi_phase = 0;     // the parity of this warpgroup's epilogue barrier
    int held_a = -1, held_b = -1;  // the stages the last tile's stores may still read
    auto release_held = [&] {
      if (held_a < 0) return;
      if (t == 0) wg::tma_store_wait_read();
      release(held_a);
      release(held_b);
      held_a = -1;
    };
    for (int ct = ct0; ct < pair_tiles; ct += ct_step) {
      int m0, n0;
      tile(ct, m0, n0);
      float acc[128];
      for (int ks = 0; ks < n_steps; ++ks, s = (s + 1) % kStages, phase ^= s == 0) {
        wg::bar_wait(&full[s], phase);
        const uint32_t st = wg::opaque(ring_s) + s * kStageBytes;
        wg::mma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const uint64_t db = kBmn ? wg::desc_mn(st + kABytes, k4, wg::kBoxBytes)
                                   : wg::desc_k(st + kABytes, k4);
          wg::mma_m64n256<0, kBmn ? 1 : 0>(acc, wg::desc_k(st + wgi * (kABytes / 2), k4), db,
                                           ks + k4 > 0);
        }
        wg::mma_commit();
        wg::mma_wait<1>();
        if (ks == 0) release_held();  // the products run meanwhile
        if (ks > 0 && ks < n_steps - 1) release((s + kStages - 1) % kStages);
      }
      wg::mma_wait<0>();
      wg::acc_fence(acc);
      // The stages of the last two k-steps stay held: warpgroup w writes its
      // output tile into held[w] and its store reads it from there until the
      // next tile's first products; the producer meanwhile fills the other
      // two stages with the next tile's k-steps.
      const int s_a = (s + kStages - 2) % kStages, s_b = (s + kStages - 1) % kStages;
      uint8_t* const held[2] = {ring + s_a * kStageBytes, ring + s_b * kStageBytes};
      wg::sync_named(3, 256);  // both warpgroups' products are done with them
      if constexpr (Epi::kDirect) {  // it stores from registers: nothing to hold
        release(s_a);
        release(s_b);
        Epi::apply(acc, p, held, t, wgi, m0, n0, m, &epi_bar[wgi], epi_phase);
        continue;
      }
      Epi::apply(acc, p, held, t, wgi, m0, n0, m, &epi_bar[wgi], epi_phase);
      epi_phase ^= 1;
      wg::fence_async_smem();
      wg::sync_named(1 + wgi, 128);
      if (t == 0 && m0 + 64 * wgi < m) {
        for (int j = 0; j < kTileN / wg::kBox; ++j)
          wg::tma_store(&c_map, held[wgi] + j * wg::kBoxBytes, n0 + j * wg::kBox,
                        m0 + 64 * wgi);
        wg::tma_store_commit();
      }
      held_a = s_a;
      held_b = s_b;
    }
    release_held();
    if (t == 0) wg::tma_store_wait();
  }
  // no block leaves while the other may still arrive on its barriers
  wg::cluster_sync();
}

// C = A B^T through `Epi` on `st`: a_map (M, K) in [128][64] boxes, b_map
// in [128][64] boxes ((N, K), K-major) or [64][64] ((K, N), kBmn), c_map
// (M, N) in [64][64] boxes; K a multiple of 64. As many pairs as the card
// holds at once, each walking its share of the tiles. Returns the first
// error.
template <class Epi, bool kBmn>
inline cudaError_t launch_gemm(const CUtensorMap& a_map, const CUtensorMap& b_map,
                               const CUtensorMap& c_map, const typename Epi::Params& p,
                               long long m, int n, int k, cudaStream_t st) {
  auto kernel = gemm_kernel<Epi, kBmn>;
  static_assert(gm::kSmem <= 232448, "gemm_kernel: shared memory past 227 KB");
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gm::kSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + gm::kTileN - 1) / gm::kTileN;
  // tiles of two row tiles (the row tiles padded to the pair)
  const long long pair_tiles = (m + 2 * gm::kTileM - 1) / (2 * gm::kTileM) * n_tiles;
  if (pair_tiles > 2147483647LL / 2) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(wg::kThreads);
  cfg.dynamicSmemBytes = gm::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int pairs = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&pairs, kernel, &cfg)) != cudaSuccess) return err;
  if (pairs < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(2 * (pair_tiles < pairs ? pair_tiles : pairs)));
  // at least two k-steps (a K of 64 gets a second one of zeros, past the
  // ends of A and B): a tile's epilogue holds the stages of its last two
  const int n_steps = k / wg::kBox > 2 ? k / wg::kBox : 2;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, a_map, b_map, c_map, p, m, n_tiles, n_steps,
                                (int)pair_tiles)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace dcvit
