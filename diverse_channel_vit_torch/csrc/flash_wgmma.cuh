// The Hopper flash-attention core of every attention kernel of the port, on
// top of wgmma_core.cuh's mbarrier ring, TMA and `wgmma` helpers: the
// attend_project kernels (attend_project.cu, B1; attend_project_bwd.cu, B2),
// the flash_packed kernels (flash_packed.cu, B5; flash_packed_bwd.cu, B6) and
// the benchmark scripts' two (qkv_flash.cu, S2; bench_attn_bwd.cu, S1). B1,
// B5 and S2 run one forward kernel (`attend_tiles`), S1's statistics
// pass its online max and sum; B2, B6 and S1 share the backward's two
// attention passes (`flash_bwd_kv_kernel`, `flash_bwd_q_kernel`; B2's with
// its bias partials, S1's also with two heads a block).
//
// What bounds attention at head width 64 on an H100 is two floors of about
// the same height: the bf16 products, and the exponentials. The SM's
// special-function units give about 3.9 T exp2/s per card against 989
// TFLOP/s of bf16 products (FlashAttention-3, Shah et al. 2024, §3.1). At
// the DiChaViT-S flagship (B = 64, 6 heads, 1569 real rows and keys) the
// forward takes 64 x 6 x 1569^2 = 9.45e8 exponentials, about 0.24 ms, beside
// its 0.27 ms tensor-core bound; the backward takes them twice (its dk/dv and
// dq passes each recompute P). A warpgroup that alternates products and
// softmax cannot go below the sum of the two. What this core does about it:
// - every product is `wgmma` on 64-row tiles of one warpgroup, with the
//   operands brought into shared memory by TMA: head slices of (B, N, *)
//   tensors through rank-3 tensor maps (columns, rows, images) with a row
//   stride of their own, so q, k and v may be the thirds of one packed qkv
//   or tensors of their own, a row box never runs into the next image, and
//   TMA's zero fill and clipped stores take the ragged last tile;
// - P and dS go from the f32 accumulator of one product into the A operand
//   of the next as packed bf16 registers (`wgmma` with A from registers):
//   the accumulator layout of an m64nN product is the A-fragment layout of
//   an m64k16 one, so no tile goes through shared memory on the way;
// - the exponentials of one warpgroup run while another's products do: each
//   block is one consumer warpgroup of 64 rows, and several blocks share an
//   SM: the forward's (with a producer warp, 160 threads) three, two at head
//   width 128; the backward's attention passes' (thread 0 issuing the loads, 128 threads) three. On
//   an H100 that beat blocks of two consumer warpgroups that take turns
//   issuing their products (FlashAttention-3's ping-pong, named barriers,
//   one block an SM), in the forward and in the backward, where dropping
//   the producer warp for a third block an SM gained more. (ptxas
//   holds consumer code to 168 registers a thread in every one of these
//   shapes, `setmaxnreg` notwithstanding, so none can hold a deeper
//   pipeline in the dk/dv pass.) The forward and the backward's dq
//   pass also issue each tile's first products together with the previous
//   tile's last, in a pipeline stage of its own;
// - the softmax scale is folded into the exponent (exp2 of s * scale * log2 e
//   minus the row's max or log-sum-exp in the log2 domain), one `ex2` each.
//
// One box of a head slice serves both operand majors: a [rows][64] box of
// Q, K, V or dO (64 bf16 columns, 128-byte swizzle) is the K-major operand
// of a product that reduces over the head width (S = Q K^T, dP = dO V^T) and
// the MN-major operand of one that reduces over the rows (P V, P^T dO, dS^T
// Q, dS K); only the descriptor differs (wgmma_core.cuh).
//
// Every kernel and tile loop takes the head width HD as a template
// parameter, 64 or 128 (the TPU kernels take any multiple of 64; the
// DiChaViT-S flagship has 6 heads of 64, the `small_tpu` preset 3 of 128).
// A head slice of width 128 is two [rows][64] boxes, kBoxBytes apart: the
// products that reduce over the head width take eight k16 steps over the
// two, those that produce it one m64n128 product on both (the second box is
// the first's next 64 columns, the descriptor's leading byte offset), and
// the accumulators of width HD (O, dq, dk, dv) double to 64 registers a
// thread. What that costs in shared memory and registers, each kernel's
// shape (stages, blocks an SM) answers per width below.
#pragma once

#include "wgmma_core.cuh"

namespace dcvit {
namespace fw {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWgRows = 64;           // rows of one warpgroup's tile
constexpr int kHalfBox = kWgRows * 128;  // bytes of a warpgroup's 64 rows in a box

// The head widths built, and the [rows][64] boxes of one head slice.
__host__ __device__ constexpr bool head_width_built(int hd) { return hd == 64 || hd == 128; }
__host__ __device__ constexpr int head_boxes(int hd) { return hd / wg::kBox; }

DEV float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- TMA on rank-3 maps (columns, rows, images), bulk copies ------------------

DEV void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row, int img) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(img)
      : "memory");
}
DEV void tma_store3(const CUtensorMap* map, const void* src, int col, int row, int img) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row), "r"(img)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
DEV void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- wgmma with A from registers --------------------------------------------------

// d[0:32] (+)= A(64 x 16, four packed bf16 pairs a thread) B(16 x 64)
template <int TB>
DEV void mma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d[0:64] (+)= A(64 x 16, four packed bf16 pairs a thread) B(16 x 128)
template <int TB>
DEV void mma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d += A B with A from registers and B MN-major, N = R / 2 columns: one
// m64n64 (R = 32) or m64n128 (R = 64) product
template <int R>
DEV void mma_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t db) {
  static_assert(R == 32 || R == 64, "head width 64 or 128");
  if constexpr (R == 32)
    mma_rs_m64n64<1>(d, a, db, 1);
  else
    mma_rs_m64n128<1>(d, a, db, 1);
}

// The A fragments of the next product from an f32 accumulator of R
// registers (a 64 x R/2 tile whose columns are that product's reduction
// axis), rounded to bf16: k-step ks takes accumulator registers 8 ks .. 8 ks
// + 7, which hold columns 16 ks .. 16 ks + 15 of the thread's two rows in
// exactly the order of an m64k16 A fragment.
template <int R>
DEV void pack_a(uint32_t (&a)[R / 8][4], const float (&c)[R]) {
#pragma unroll
  for (int ks = 0; ks < R / 8; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[ks][j] = pack_bf16(c[8 * ks + 2 * j], c[8 * ks + 2 * j + 1]);
}
// keep packed A fragments live until the products that read them have ended
template <int K>
DEV void frag_fence(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[k][j])::"memory");
}

// Store a warpgroup's 64 x R/2 f32 accumulator, rounded to bf16, into its 64
// rows of R/32 swizzled boxes kBoxBytes apart (`box` at those rows of the
// first).
template <int R>
DEV void store_tile(uint8_t* box, const float (&c)[R], int t) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int col = wg::acc_col(t, i);
    wg::st_pair(box + (col >> 6) * wg::kBoxBytes, wg::acc_row(t, i), col & 63, c[i], c[i + 1]);
  }
}

// ---- the forward's tile loop (B5, which B1 and S2 launch) and S1's statistics pass -----
//
// Blocks of one consumer warpgroup (64 query rows) and one producer warp,
// several an SM. The producer streams one head's K and V tiles of 64 keys by TMA
// through a ring of S stages; the consumer runs an online softmax
// over them (running max and sum in f32 registers, quad shuffles), keys at
// or past n_valid masked, key tiles wholly past it skipped.

constexpr int kFwdStages = 3;                      // the ring's depth unless a kernel says
constexpr int kFwdThreads = 128 + 32;              // a consumer warpgroup and a producer warp
// a stage of the forward's ring: the K and the V tile of one head
__host__ __device__ constexpr int fwd_stage_bytes(int hd) {
  return 2 * head_boxes(hd) * wg::kBoxBytes;
}

// S = Q_h K^T: 64 rows x 64 keys, the K-major Q boxes at `qa`, the K tile's
// at `kt_box`, over the head width (four k16 steps a box).
template <int HD>
DEV void scores(float (&sc)[32], uint32_t qa, uint32_t kt_box) {
#pragma unroll
  for (int j = 0; j < head_boxes(HD); ++j)
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
      wg::mma_m64n64<0, 0>(sc, wg::desc_k(qa + j * wg::kBoxBytes, k4),
                           wg::desc_k(kt_box + j * wg::kBoxBytes, k4), j + k4 > 0);
}

// The row maxima of the raw scores of keys kv0 .. kv0 + 64, in the log2
// domain (times scale_log2 > 0), into mx_a / mx_b (quad shuffles); in the
// ragged last tile, keys at or past n_valid get -1e30 first.
DEV void row_max(float (&sc)[32], int kv0, int n_valid, float scale_log2, int t, float& mx_a,
                 float& mx_b) {
  if (kv0 + kWgRows > n_valid) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (kv0 + wg::acc_col(t, i) >= n_valid) sc[i] = -1e30f;
  }
  // two chains a row, to halve the dependent fmax latency
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int k = ((i >> 1) & 1) + 2 * ((i >> 2) & 1);  // row b: odd k
    m[k] = fmaxf(m[k], sc[i]);
  }
  float ra = fmaxf(m[0], m[2]), rb = fmaxf(m[1], m[3]);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    ra = fmaxf(ra, __shfl_xor_sync(0xffffffffu, ra, off));
    rb = fmaxf(rb, __shfl_xor_sync(0xffffffffu, rb, off));
  }
  mx_a = fmaxf(mx_a, ra * scale_log2);
  mx_b = fmaxf(mx_b, rb * scale_log2);
}

// P = exp2(S scale_log2 - m) in place, one FMA and one ex2 each (f32, for
// the row sums added to l_a / l_b; packed to bf16 for P V by the caller)
DEV void exp_scores(float (&sc)[32], float scale_log2, float m_a, float m_b, float& l_a,
                    float& l_b) {
  float l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool rb = (i >> 1) & 1;
    sc[i] = ex2(fmaf(sc[i], scale_log2, rb ? -m_b : -m_a));
    l[(rb ? 1 : 0) + 2 * ((i >> 2) & 1)] += sc[i];
  }
  l_a += l[0] + l[2];
  l_b += l[1] + l[3];
}

// The online softmax's step for the key tile at kv0: the running row maxima
// m_a / m_b (log2 domain) take the tile's (row_max), and alpha_a / alpha_b
// get the factors ex2(old - new) that rescale what was summed against the
// old maxima.
DEV void update_max(float (&sc)[32], int kv0, int n_valid, float scale_log2, int t, float& m_a,
                    float& m_b, float& alpha_a, float& alpha_b) {
  float mx_a = m_a, mx_b = m_b;
  row_max(sc, kv0, n_valid, scale_log2, t, mx_a, mx_b);
  alpha_a = ex2(m_a - mx_a);
  alpha_b = ex2(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
}

// The producer: K and V tiles 0 .. n_kt of one head of image `img`, each
// into the next of the ring's S stages (the K boxes, then the V boxes),
// from columns k_col / v_col of k_map / v_map. `it` counts the ring's fills
// across calls.
template <int HD, int S>
DEV void load_kv_tiles(uint8_t* ring, uint64_t* full, uint64_t* empty, int& it,
                       const CUtensorMap* k_map, int k_col, const CUtensorMap* v_map, int v_col,
                       int n_kt, int img) {
  constexpr int nb = head_boxes(HD);
  for (int kt = 0; kt < n_kt; ++kt, ++it) {
    const int s = it % S;
    wg::bar_wait(&empty[s], ((it / S) & 1) ^ 1);
    wg::bar_expect_tx(&full[s], fwd_stage_bytes(HD));
    uint8_t* st = ring + s * fwd_stage_bytes(HD);
    for (int j = 0; j < nb; ++j) {
      tma_load3(st + j * wg::kBoxBytes, k_map, &full[s], k_col + j * wg::kBox, kt * kWgRows, img);
      tma_load3(st + (nb + j) * wg::kBoxBytes, v_map, &full[s], v_col + j * wg::kBox,
                kt * kWgRows, img);
    }
  }
}

// The K tiles alone (the statistics pass's ring: stages of one head's K
// boxes), as load_kv_tiles.
template <int HD, int S>
DEV void load_k_tiles(uint8_t* ring, uint64_t* full, uint64_t* empty, int& it,
                      const CUtensorMap* k_map, int k_col, int n_kt, int img) {
  constexpr int nb = head_boxes(HD);
  for (int kt = 0; kt < n_kt; ++kt, ++it) {
    const int s = it % S;
    wg::bar_wait(&empty[s], ((it / S) & 1) ^ 1);
    wg::bar_expect_tx(&full[s], nb * wg::kBoxBytes);
    for (int j = 0; j < nb; ++j)
      tma_load3(ring + (s * nb + j) * wg::kBoxBytes, k_map, &full[s], k_col + j * wg::kBox,
                kt * kWgRows, img);
  }
}

// The consumer: o = P V unnormalised (64 rows x HD), with the running row
// max (log2 domain) and row sums of the thread's two rows, for the 64 query
// rows of one head whose K-major Q boxes are at `qa`, over the n_kt key tiles that
// load_kv_tiles puts into the ring at shared address `ring_s`; `it` as
// there. Tile kt > 0 issues S_kt = Q K_kt^T together with O += P_{kt-1}
// V_{kt-1}, then takes S_kt's row maxima while that P V runs. Tile 0 is
// peeled off, so that the loop body issues the same products and waits every
// time: ptxas serialises every product of a loop whose groups and waits
// depend on a branch.
template <int HD, int S>
DEV void attend_tiles(float (&o)[HD / 2], float& m_a, float& m_b, float& l_a, float& l_b,
                      uint32_t qa, uint32_t ring_s, uint64_t* full, uint64_t* empty, int& it,
                      int n_kt, int n_valid, float scale_log2, int t) {
  constexpr int kStage = fwd_stage_bytes(HD), kV = head_boxes(HD) * wg::kBoxBytes;
  wg::acc_zero(o);
  m_a = -INFINITY;
  m_b = -INFINITY;
  l_a = 0.f;
  l_b = 0.f;
  uint32_t p[4][4];  // P of the previous tile, bf16
  float sc[32];
  int s = it % S;
  wg::bar_wait(&full[s], (it / S) & 1);
  uint32_t st = wg::opaque(ring_s) + s * kStage;
  wg::mma_fence();
  scores<HD>(sc, wg::opaque(qa), st);
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::acc_fence(sc);
  row_max(sc, 0, n_valid, scale_log2, t, m_a, m_b);
  exp_scores(sc, scale_log2, m_a, m_b, l_a, l_b);
  pack_a(p, sc);
  for (int kt = 1; kt < n_kt; ++kt) {
    const int s_prev = s;
    const uint32_t v_prev = st + kV;
    ++it;
    s = it % S;
    wg::bar_wait(&full[s], (it / S) & 1);
    st = wg::opaque(ring_s) + s * kStage;
    wg::mma_fence();
    scores<HD>(sc, wg::opaque(qa), st);
    wg::mma_commit();
    // a pipeline stage of its own, so that S_kt's registers may change
    // while this product runs
    wg::mma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rs(o, p[ks], wg::desc_mn(v_prev, ks, wg::kBoxBytes));
    wg::mma_commit();
    wg::mma_wait<1>();
    wg::acc_fence(sc);
    float alpha_a, alpha_b;
    update_max(sc, kt * kWgRows, n_valid, scale_log2, t, m_a, m_b, alpha_a, alpha_b);
    wg::mma_wait<0>();  // the previous tile's P V has ended: its stage is free
    wg::acc_fence(o);
    frag_fence(p);
    if (t == 0) wg::bar_arrive(&empty[s_prev]);
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= ((i >> 1) & 1) ? alpha_b : alpha_a;
    exp_scores(sc, scale_log2, m_a, m_b, l_a, l_b);
    pack_a(p, sc);
  }
  // the last tile's P V
  wg::mma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) mma_rs(o, p[ks], wg::desc_mn(st + kV, ks, wg::kBoxBytes));
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::acc_fence(o);
  frag_fence(p);
  if (t == 0) wg::bar_arrive(&empty[s]);
  ++it;
}

// The statistics pass's loop (S1): the running row max (log2 domain) and
// row sums of the 64 query rows of one head whose K-major Q boxes are at `qa`,
// over the n_kt key tiles that load_k_tiles puts into the ring at `ring_s`,
// `it` as there. The same products, maxima, rescaling and sums, in the same
// order, as attend_tiles, without P V: so its statistics, and the
// log-sum-exp that row_sums writes from them, equal the forward's bit for
// bit. (At tile 0 update_max's alpha is ex2(-inf) = 0 and l is 0, so the
// one body serves every tile.)
template <int HD, int S>
DEV void stat_tiles(float& m_a, float& m_b, float& l_a, float& l_b, uint32_t qa, uint32_t ring_s,
                    uint64_t* full, uint64_t* empty, int& it, int n_kt, int n_valid,
                    float scale_log2, int t) {
  m_a = -INFINITY;
  m_b = -INFINITY;
  l_a = 0.f;
  l_b = 0.f;
  float sc[32];
  for (int kt = 0; kt < n_kt; ++kt, ++it) {
    const int s = it % S;
    wg::bar_wait(&full[s], (it / S) & 1);
    wg::mma_fence();
    scores<HD>(sc, wg::opaque(qa), wg::opaque(ring_s) + s * head_boxes(HD) * wg::kBoxBytes);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(sc);
    if (t == 0) wg::bar_arrive(&empty[s]);
    float alpha_a, alpha_b;
    update_max(sc, kt * kWgRows, n_valid, scale_log2, t, m_a, m_b, alpha_a, alpha_b);
    l_a *= alpha_a;
    l_b *= alpha_b;
    exp_scores(sc, scale_log2, m_a, m_b, l_a, l_b);
  }
}

// The row sums over the quad, into l_a / l_b; with `lrow` (the head's (N,)
// f32 log-sum-exp row) each row's log-sum-exp of the scaled scores, rows
// row_a and row_b if below n.
DEV void row_sums(float& l_a, float& l_b, float m_a, float m_b, float* lrow, int row_a,
                  int row_b, int n, int t) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  if (lrow != nullptr && (t & 3) == 0) {
    if (row_a < n) lrow[row_a] = (m_a + log2f(l_a)) * kLn2;  // m in the log2 domain
    if (row_b < n) lrow[row_b] = (m_b + log2f(l_b)) * kLn2;
  }
}

// attend_tiles' epilogue: row_sums; o normalised, rounded to bf16 into the
// warpgroup's 64-row boxes at `obox` (R/32 of them, kBoxBytes apart), made
// visible to TMA, and the warpgroup synchronised, so that thread 0 may
// store them.
template <int R>
DEV void finish_rows(float (&o)[R], float m_a, float m_b, float l_a, float l_b, float* lrow,
                     int row_a, int row_b, int n, uint8_t* obox, int t) {
  row_sums(l_a, l_b, m_a, m_b, lrow, row_a, row_b, n, t);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] *= ((i >> 1) & 1) ? inv_b : inv_a;
  store_tile(obox, o, t);
  wg::fence_async_smem();
  wg::sync_named(1, 128);
}

}  // namespace fw

// ---- the backward's attention passes (B2, B6, S1) ---------------------------------
//
// Blocks of one warpgroup (128 threads), three an SM at head width 64, two
// at 128. Thread 0 issues the TMA loads: a stage is refilled as soon as the
// warpgroup has finished with it. (A producer warp beside the warpgroup, 160
// threads and two blocks an SM within the 168 registers a thread that the
// dk/dv pass needs at head width 64, was slower on an H100.) The dk/dv pass
// holds K and V of the block's 64 keys; a stage holds the (Q, dO) boxes of
// 64 queries and their 64 lse and 64 di values. The dq pass holds Q and dO
// of the block's 64 queries; a stage holds the (K, V) boxes of 64 keys.
//
// Head width 128 doubles every box and every accumulator of width HD: dk
// and dv alone take 128 registers a thread, and with S^T and dP^T (32 + 32)
// the dk/dv pass peaks near 200, past the 168 that three blocks an SM
// allow. So at 128 both passes ask for two blocks an SM (255 registers a
// thread) and keep two stages, which fits two blocks' shared memory (103
// KiB dk/dv, 99 KiB dq).
//
// q, k and v come through maps of their own, each head's columns at
// q_col + HD h, k_col + HD h, v_col + HD h (B2: one packed qkv map three
// times, columns 0, D and 2D; B6: three maps, columns 0); dO through a
// (B, N, D) map. dq, dk and dv leave by TMA into one (B, N, 3D) map,
// [dq | dk | dv]. With kBias (B2) each block also writes the column sums of
// its dq, or of its dk and dv, as the bias partials of its 64-row tile:
// bias_part row (image * N / 64 + tile), columns d_out + [0, 3D).
//
// HP = 2 (S1's "pair_batched" schedule) gives a block a head pair: two
// warpgroups of 128 threads, warpgroup g taking head 2 blockIdx.y + g with
// the very instructions a one-head block runs. Resident boxes and ring stages
// hold both heads' boxes (head g's at the same offsets within its half), each
// stage filled under one barrier, refilled once all 256 threads are done
// with it. At head width 64, 137 KiB (dk/dv) and 130 KiB (dq) of shared
// memory, at 128 201 and 195 KiB: one such block fits an SM. With an odd
// head count the last block carries one head: its second warpgroup loads
// nothing, runs the same instructions on whatever its half of shared memory
// holds, and writes nothing.

constexpr int kFlashThreads = 128;
// the dk/dv pass's stages: (Q, dO) boxes, then lse and di (512 bytes),
// padded to keep the next stage on the swizzle atom
__host__ __device__ constexpr int kv_stages(int hd) { return hd == 64 ? 3 : 2; }
__host__ __device__ constexpr int kv_stage_bytes(int hd) {
  return 2 * fw::head_boxes(hd) * wg::kBoxBytes + 1024;
}
__host__ __device__ constexpr int kv_smem(int hd, int hp) {
  return hp * (2 * fw::head_boxes(hd) * wg::kBoxBytes + kv_stages(hd) * kv_stage_bytes(hd)) +
         4 * 2 * hd * 4 + (kv_stages(hd) + 1) * 8 + wg::kAlign;
}
// the dq pass's stages: (K, V) boxes
__host__ __device__ constexpr int q_stages(int hd) { return hd == 64 ? 3 : 2; }
__host__ __device__ constexpr int q_stage_bytes(int hd) {
  return 2 * fw::head_boxes(hd) * wg::kBoxBytes;
}
__host__ __device__ constexpr int q_smem(int hd, int hp) {
  return hp * (2 * fw::head_boxes(hd) * wg::kBoxBytes + q_stages(hd) * q_stage_bytes(hd)) +
         4 * hd * 4 + (q_stages(hd) + 1) * 8 + wg::kAlign;
}
// blocks an SM that the launch bounds ask for
__host__ __device__ constexpr int bwd_blocks(int hd, int hp) {
  return hp == 1 ? (hd == 64 ? 3 : 2) : 1;
}

// The thread's index in its warpgroup and the warpgroup's head within the
// block (0 with one head a block).
template <int HP>
DEV int wg_thread() {
  return HP == 1 ? (int)threadIdx.x : (int)threadIdx.x & 127;
}
template <int HP>
DEV int wg_head() {
  return HP == 1 ? 0 : wg::warpgroup();
}
// The named barrier of a warpgroup's own epilogue (id 1 is the block's).
template <int HP>
DEV void wg_sync(int g) {
  wg::sync_named(HP == 1 ? 1 : 2 + g, 128);
}

// The stages' full barriers and one more for the resident boxes, initialised
// by thread 0 before any load.
DEV void init_bars(uint64_t* full, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s <= stages; ++s) wg::bar_init(&full[s], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
}

// dk, dv (and with kBias their column sums). Grid (N / 64, ceil(heads / HP),
// B).
template <bool kBias, int HD, int HP = 1>
__global__ void __launch_bounds__(kFlashThreads * HP, bwd_blocks(HD, HP))
    flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap dqkv_map, int q_col, int k_col,
                        int v_col, const float* __restrict__ lse, const float* __restrict__ di,
                        __nv_bfloat16* __restrict__ dqkv, float* __restrict__ bias_part, int n,
                        int n_valid, int heads, float scale_log2, float sm_scale, int d_out,
                        int bias_stride) {
  static_assert(HP == 1 || !kBias, "bias partials come from one-head blocks");
  constexpr int nb = fw::head_boxes(HD), kS = kv_stages(HD), kSB = kv_stage_bytes(HD);
  constexpr int kHead = 2 * nb * wg::kBoxBytes;  // a head's resident K and V boxes
  const int d = heads * HD, g = wg_head<HP>(), t = wg_thread<HP>();
  const int h0 = blockIdx.y * HP, h = h0 + g, b = blockIdx.z, k0 = blockIdx.x * fw::kWgRows,
            hc = h * HD;
  // the block's heads (the last block of an odd count carries one) and
  // whether this warpgroup's is one of them
  const int hp = HP == 1 ? 1 : min(HP, heads - h0);
  const bool live = HP == 1 || g < hp;
  [[maybe_unused]] float* part = nullptr;
  if constexpr (kBias)
    part = bias_part + ((long long)b * (n / fw::kWgRows) + blockIdx.x) * bias_stride + d_out;

  if (k0 >= n_valid) {  // wholly padded keys: exact zeros
    if (!live) return;
    const long long row3 = 3LL * d;
    __nv_bfloat16* dbase = dqkv + ((long long)b * n + k0) * row3 + hc;
    for (int i = t; i < fw::kWgRows * (HD / 2); i += kFlashThreads) {
      const long long off = (long long)(i / (HD / 2)) * row3 + (i % (HD / 2)) * 2;
      *reinterpret_cast<uint32_t*>(dbase + off + d) = 0u;
      *reinterpret_cast<uint32_t*>(dbase + off + 2 * d) = 0u;
    }
    if constexpr (kBias)
      for (int c = t; c < HD; c += kFlashThreads) {
        part[d + hc + c] = 0.f;
        part[2 * d + hc + c] = 0.f;
      }
    return;
  }

  // head j's K and V boxes at base + j kHead; stage s of head j at
  // ring + (s HP + j) kSB
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wg::align(smem_raw);
  uint8_t* sK = base + g * kHead;
  uint8_t* sV = sK + nb * wg::kBoxBytes;
  uint8_t* ring = base + HP * kHead;
  float* red = reinterpret_cast<float*>(ring + kS * HP * kSB);  // [4 warps][2][HD]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * 2 * HD);
  uint64_t* kvbar = full + kS;
  const int nq = n / fw::kWgRows;
  init_bars(full, kS);

  const float* lrow = lse + ((long long)b * heads + h0) * n;  // the block's first head's
  const float* drow = di + ((long long)b * heads + h0) * n;
  auto load_q = [&](int qt) {
    const int s = qt % kS;
    wg::bar_expect_tx(&full[s], hp * (2 * nb * wg::kBoxBytes + 2 * 256));
    for (int j = 0; j < hp; ++j) {
      uint8_t* st = ring + (s * HP + j) * kSB;
      const int cj = (h0 + j) * HD;
      for (int jj = 0; jj < nb; ++jj) {
        fw::tma_load3(st + jj * wg::kBoxBytes, &q_map, &full[s], q_col + cj + jj * wg::kBox,
                      qt * fw::kWgRows, b);
        fw::tma_load3(st + (nb + jj) * wg::kBoxBytes, &do_map, &full[s], cj + jj * wg::kBox,
                      qt * fw::kWgRows, b);
      }
      fw::bulk_load(st + 2 * nb * wg::kBoxBytes, lrow + j * n + qt * fw::kWgRows, 256, &full[s]);
      fw::bulk_load(st + 2 * nb * wg::kBoxBytes + 256, drow + j * n + qt * fw::kWgRows, 256,
                    &full[s]);
    }
  };
  if (threadIdx.x == 0) {
    wg::bar_expect_tx(kvbar, hp * kHead);
    for (int j = 0; j < hp; ++j) {
      const int cj = (h0 + j) * HD;
      for (int jj = 0; jj < nb; ++jj) {
        fw::tma_load3(base + j * kHead + jj * wg::kBoxBytes, &k_map, kvbar,
                      k_col + cj + jj * wg::kBox, k0, b);
        fw::tma_load3(base + j * kHead + (nb + jj) * wg::kBoxBytes, &v_map, kvbar,
                      v_col + cj + jj * wg::kBox, k0, b);
      }
    }
    for (int qt = 0; qt < kS && qt < nq; ++qt) load_q(qt);
  }
  float dk[HD / 2], dv[HD / 2];
  wg::acc_zero(dk);
  wg::acc_zero(dv);
  const int key_a = k0 + wg::acc_row(t, 0);
  const bool valid_a = key_a < n_valid, valid_b = key_a + 8 < n_valid;
  const uint32_t ring_s = smem_addr(ring), k_s = smem_addr(sK), v_s = smem_addr(sV);
  wg::bar_wait(kvbar, 0);
  // Two product groups a query tile, each waited in the same tile: issuing
  // a tile's dV and dK with the next tile's S^T and dP^T would hold dk, dv,
  // both score tiles and both packed operands live at once, past the
  // registers a thread that the blocks an SM allow.
  for (int qt = 0; qt < nq; ++qt) {
    const int s = qt % kS;
    wg::bar_wait(&full[s], (qt / kS) & 1);
    const uint32_t st = wg::opaque(ring_s) + (s * HP + g) * kSB;
    const float* l_t =
        reinterpret_cast<const float*>(ring + (s * HP + g) * kSB + 2 * nb * wg::kBoxBytes);
    const float* d_t = l_t + fw::kWgRows;
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, over the head width
    float sc[32], dp[32];
    wg::mma_fence();
#pragma unroll
    for (int jj = 0; jj < nb; ++jj)
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wg::mma_m64n64<0, 0>(sc, wg::desc_k(wg::opaque(k_s) + jj * wg::kBoxBytes, k4),
                             wg::desc_k(st + jj * wg::kBoxBytes, k4), jj + k4 > 0);
    wg::mma_commit();
#pragma unroll
    for (int jj = 0; jj < nb; ++jj)
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wg::mma_m64n64<0, 0>(dp, wg::desc_k(wg::opaque(v_s) + jj * wg::kBoxBytes, k4),
                             wg::desc_k(st + (nb + jj) * wg::kBoxBytes, k4), jj + k4 > 0);
    wg::mma_commit();
    // P^T = exp2(S^T scale log2e - lse log2e); padded keys exactly 0
    wg::mma_wait<1>();
    wg::acc_fence(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(l_t + wg::acc_col(t, 4 * j));
      const float la = l2.x * fw::kLog2e, lb = l2.y * fw::kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = (e & 2) ? valid_b : valid_a;
        const int i = 4 * j + e;
        sc[i] = valid ? fw::ex2(sc[i] * scale_log2 - ((e & 1) ? lb : la)) : 0.f;
      }
    }
    // dS^T = P^T (dP^T - di) * scale
    wg::mma_wait<0>();
    wg::acc_fence(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(d_t + wg::acc_col(t, 4 * j));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dp[i] = sc[i] * (dp[i] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
      }
    }
    uint32_t pp[4][4], dsp[4][4];
    fw::pack_a(pp, sc);
    fw::pack_a(dsp, dp);
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers
    wg::mma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      fw::mma_rs(dv, pp[ks], wg::desc_mn(st + nb * wg::kBoxBytes, ks, wg::kBoxBytes));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) fw::mma_rs(dk, dsp[ks], wg::desc_mn(st, ks, wg::kBoxBytes));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(dv);
    wg::acc_fence(dk);
    fw::frag_fence(pp);
    fw::frag_fence(dsp);
    wg::sync_named(1, kFlashThreads * HP);  // every warp is done with the stage
    if (threadIdx.x == 0 && qt + kS < nq) load_q(qt + kS);
  }

  // dk and dv (bf16) into the K and V boxes, then out by TMA
  fw::store_tile(sK, dk, t);
  fw::store_tile(sV, dv, t);
  wg::fence_async_smem();
  wg_sync<HP>(g);
  if (t == 0 && live) {
    for (int jj = 0; jj < nb; ++jj) {
      fw::tma_store3(&dqkv_map, sK + jj * wg::kBoxBytes, d + hc + jj * wg::kBox, k0, b);
      fw::tma_store3(&dqkv_map, sV + jj * wg::kBoxBytes, 2 * d + hc + jj * wg::kBox, k0, b);
    }
    wg::tma_store_commit();
  }
  if constexpr (kBias) {
    // column sums of the f32 accumulators, as the TPU summed its f32
    // scratch: over the thread's two rows, the warp's eight row groups, then
    // the four warps in order
    const int warp = t >> 5, lane = t & 31;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sk = sum_over_rows(dk[4 * j + e] + dk[4 * j + 2 + e]);
        const float sv = sum_over_rows(dv[4 * j + e] + dv[4 * j + 2 + e]);
        if (lane < 4) {
          red[(warp * 2) * HD + 8 * j + 2 * lane + e] = sk;
          red[(warp * 2 + 1) * HD + 8 * j + 2 * lane + e] = sv;
        }
      }
    wg::sync_named(1, 128);
    for (int i = t; i < 2 * HD; i += kFlashThreads) {
      const int which = i / HD, c = i % HD;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += red[(w * 2 + which) * HD + c];
      part[(1 + which) * d + hc + c] = sum;
    }
  }
  if (t == 0) wg::tma_store_wait();
}

// The dq pass's products S = Q K^T and dP = dO V^T: 64 queries x 64 keys,
// the Q and dO boxes at `qa` and `doa`, the (K, V) stage at `st`, over the
// head width.
template <int HD>
DEV void q_scores(float (&sc)[32], float (&dp)[32], uint32_t qa, uint32_t doa, uint32_t st) {
  constexpr int nb = fw::head_boxes(HD);
#pragma unroll
  for (int jj = 0; jj < nb; ++jj)
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
      wg::mma_m64n64<0, 0>(sc, wg::desc_k(qa + jj * wg::kBoxBytes, k4),
                           wg::desc_k(st + jj * wg::kBoxBytes, k4), jj + k4 > 0);
#pragma unroll
  for (int jj = 0; jj < nb; ++jj)
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
      wg::mma_m64n64<0, 0>(dp, wg::desc_k(doa + jj * wg::kBoxBytes, k4),
                           wg::desc_k(st + (nb + jj) * wg::kBoxBytes, k4), jj + k4 > 0);
}

// The dq pass's dS = P (dP - di) * scale into sc, P = exp2(S scale log2e -
// lse log2e), keys kv0 + column at or past n_valid 0; the thread's rows'
// lse (times log2e) and di in l2_* and di_*.
DEV void q_ds(float (&sc)[32], const float (&dp)[32], int kv0, int n_valid, float scale_log2,
              float sm_scale, float l2_a, float l2_b, float di_a, float di_b, int t) {
  const bool ragged = kv0 + fw::kWgRows > n_valid;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool rb = (i >> 1) & 1;
    const bool valid = !ragged || kv0 + wg::acc_col(t, i) < n_valid;
    const float p = valid ? fw::ex2(sc[i] * scale_log2 - (rb ? l2_b : l2_a)) : 0.f;
    sc[i] = p * (dp[i] - (rb ? di_b : di_a)) * sm_scale;
  }
}

// dq (and with kBias its column sums). Grid (N / 64, ceil(heads / HP), B).
template <bool kBias, int HD, int HP = 1>
__global__ void __launch_bounds__(kFlashThreads * HP, bwd_blocks(HD, HP))
    flash_bwd_q_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap dqkv_map, int q_col, int k_col,
                       int v_col, const float* __restrict__ lse, const float* __restrict__ di,
                       float* __restrict__ bias_part, int n, int n_valid, int heads,
                       float scale_log2, float sm_scale, int d_out, int bias_stride) {
  static_assert(HP == 1 || !kBias, "bias partials come from one-head blocks");
  constexpr int nb = fw::head_boxes(HD), kS = q_stages(HD), kSB = q_stage_bytes(HD);
  constexpr int kHead = 2 * nb * wg::kBoxBytes;  // a head's resident Q and dO boxes
  const int g = wg_head<HP>(), t = wg_thread<HP>();
  const int h0 = blockIdx.y * HP, h = h0 + g, b = blockIdx.z, q0 = blockIdx.x * fw::kWgRows,
            hc = h * HD;
  const int hp = HP == 1 ? 1 : min(HP, heads - h0);  // as in flash_bwd_kv_kernel
  const bool live = HP == 1 || g < hp;

  // head j's Q and dO boxes at base + j kHead; stage s of head j at
  // ring + (s HP + j) kSB
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wg::align(smem_raw);
  uint8_t* sQ = base + g * kHead;
  uint8_t* sDO = sQ + nb * wg::kBoxBytes;
  uint8_t* ring = base + HP * kHead;
  float* red = reinterpret_cast<float*>(ring + kS * HP * kSB);  // [4 warps][HD]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * HD);
  uint64_t* qbar = full + kS;
  const int n_kt = (n_valid + fw::kWgRows - 1) / fw::kWgRows;
  init_bars(full, kS);

  auto load_k = [&](int kt) {
    const int s = kt % kS;
    wg::bar_expect_tx(&full[s], hp * kSB);
    for (int j = 0; j < hp; ++j) {
      uint8_t* st = ring + (s * HP + j) * kSB;
      const int cj = (h0 + j) * HD;
      for (int jj = 0; jj < nb; ++jj) {
        fw::tma_load3(st + jj * wg::kBoxBytes, &k_map, &full[s], k_col + cj + jj * wg::kBox,
                      kt * fw::kWgRows, b);
        fw::tma_load3(st + (nb + jj) * wg::kBoxBytes, &v_map, &full[s],
                      v_col + cj + jj * wg::kBox, kt * fw::kWgRows, b);
      }
    }
  };
  if (threadIdx.x == 0) {
    wg::bar_expect_tx(qbar, hp * kHead);
    for (int j = 0; j < hp; ++j) {
      const int cj = (h0 + j) * HD;
      for (int jj = 0; jj < nb; ++jj) {
        fw::tma_load3(base + j * kHead + jj * wg::kBoxBytes, &q_map, qbar,
                      q_col + cj + jj * wg::kBox, q0, b);
        fw::tma_load3(base + j * kHead + (nb + jj) * wg::kBoxBytes, &do_map, qbar,
                      cj + jj * wg::kBox, q0, b);
      }
    }
    for (int kt = 0; kt < kS && kt < n_kt; ++kt) load_k(kt);
  }
  const int row_a = q0 + wg::acc_row(t, 0), row_b = row_a + 8;
  const long long stat = ((long long)b * heads + (live ? h : h0)) * n;
  const float l2_a = lse[stat + row_a] * fw::kLog2e, l2_b = lse[stat + row_b] * fw::kLog2e;
  const float di_a = di[stat + row_a], di_b = di[stat + row_b];
  float dq[HD / 2];
  wg::acc_zero(dq);
  const uint32_t ring_s = smem_addr(ring), q_s = smem_addr(sQ), do_s = smem_addr(sDO);
  wg::bar_wait(qbar, 0);
  // Key tile kt > 0 issues S_kt and dP_kt together with dQ += dS_{kt-1}
  // K_{kt-1}, and computes dS_kt while that product runs. Tile 0 is peeled
  // off, so that the loop body issues the same products and waits every
  // time (ptxas serialises the products of a loop whose groups and waits
  // depend on a branch).
  uint32_t dsp[4][4];  // dS of the previous tile, bf16
  float sc[32], dp[32];
  int s = 0;
  wg::bar_wait(&full[0], 0);
  uint32_t st = wg::opaque(ring_s) + g * kSB;
  wg::mma_fence();
  q_scores<HD>(sc, dp, wg::opaque(q_s), wg::opaque(do_s), st);
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::acc_fence(sc);
  wg::acc_fence(dp);
  q_ds(sc, dp, 0, n_valid, scale_log2, sm_scale, l2_a, l2_b, di_a, di_b, t);
  fw::pack_a(dsp, sc);
  for (int kt = 1; kt < n_kt; ++kt) {
    const uint32_t k_prev = st;
    s = kt % kS;
    wg::bar_wait(&full[s], (kt / kS) & 1);
    st = wg::opaque(ring_s) + (s * HP + g) * kSB;
    wg::mma_fence();
    q_scores<HD>(sc, dp, wg::opaque(q_s), wg::opaque(do_s), st);
    wg::mma_commit();
    // dQ += dS K of the previous tile, a pipeline stage of its own
    wg::mma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) fw::mma_rs(dq, dsp[ks], wg::desc_mn(k_prev, ks, wg::kBoxBytes));
    wg::mma_commit();
    wg::mma_wait<1>();
    wg::acc_fence(sc);
    wg::acc_fence(dp);
    q_ds(sc, dp, kt * fw::kWgRows, n_valid, scale_log2, sm_scale, l2_a, l2_b, di_a, di_b, t);
    wg::mma_wait<0>();  // the previous tile's product has ended: its stage is free
    wg::acc_fence(dq);
    fw::frag_fence(dsp);
    wg::sync_named(1, kFlashThreads * HP);  // every warp is done with the previous tile's stage
    if (threadIdx.x == 0 && kt - 1 + kS < n_kt) load_k(kt - 1 + kS);
    fw::pack_a(dsp, sc);
  }
  // the last tile's dQ
  wg::mma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) fw::mma_rs(dq, dsp[ks], wg::desc_mn(st, ks, wg::kBoxBytes));
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::acc_fence(dq);
  fw::frag_fence(dsp);

  // dq rounded to bf16 into the Q boxes, out by TMA; with kBias the column
  // sums of the rounded values
  [[maybe_unused]] float cs[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const uint32_t v = pack_bf16(dq[i], dq[i + 1]);
    const int col = wg::acc_col(t, i);
    *reinterpret_cast<uint32_t*>(sQ + (col >> 6) * wg::kBoxBytes +
                                 wg::swz(wg::acc_row(t, i), col & 63)) = v;
    if constexpr (kBias) {
      const float2 f = unpack_bf16(v);
      const int j = ((i >> 2) << 1);  // column pair (i / 4), element (i & 1)
      if ((i >> 1) & 1) {
        cs[j] += f.x;
        cs[j + 1] += f.y;
      } else {
        cs[j] = f.x;
        cs[j + 1] = f.y;
      }
    }
  }
  wg::fence_async_smem();
  wg_sync<HP>(g);
  if (t == 0 && live) {
    for (int jj = 0; jj < nb; ++jj)
      fw::tma_store3(&dqkv_map, sQ + jj * wg::kBoxBytes, hc + jj * wg::kBox, q0, b);
    wg::tma_store_commit();
  }
  if constexpr (kBias) {
    const int warp = t >> 5, lane = t & 31;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) {
      const float v = sum_over_rows(cs[j]);
      if (lane < 4) red[warp * HD + 8 * (j >> 1) + 2 * lane + (j & 1)] = v;
    }
    wg::sync_named(1, 128);
    for (int c = t; c < HD; c += kFlashThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += red[w * HD + c];
      bias_part[((long long)b * (n / fw::kWgRows) + blockIdx.x) * bias_stride + d_out + hc + c] =
          sum;
    }
  }
  if (t == 0) wg::tma_store_wait();
}

// ---- host: rank-3 TMA descriptors --------------------------------------------------

// An (imgs, rows, cols) bf16 tensor whose rows are contiguous and
// `row_stride` elements apart (>= cols; images rows * row_stride apart), read
// or written in boxes of box_rows x 64 columns of one image, 128-byte
// swizzle, zero fill past the ends (rows past `rows` belong to no image).
// TMA takes a 16-byte-aligned base and a row stride that is a multiple of 8
// elements; the encoding fails otherwise.
inline cudaError_t tensor_map3(CUtensorMap* map, const void* ptr, int imgs, int rows, int cols,
                               int box_rows, long long row_stride) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)imgs};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)rows * row_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)wg::kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dcvit
