// The f32 kernels of masked multi-head attention with no projection: the
// forward (flash_packed.cu's `dcvit_flash_packed_fwd_f32`, B5 in f32), the
// backward's three passes (flash_packed_bwd.cu's `dcvit_flash_packed_bwd_f32`,
// B6 in f32), head width HD 64 or 128.
//
// They replace the TPU kernels `_packed_fwd_kernel` and `_packed_bwd_kernel`
// (diverse_channel_vit_tpu/ops/attention.py:243, :297) where those run in
// f32: an f32 model's unfused attention (JAX `models/vit.py:168`, :203,
// :270, :297) reaches them, since `multi_head_attention_packed` picks the
// kernel by backend and not by dtype (:500-528). There every product is
// f32 x f32 with f32 accumulation, P stays in f32, and O is divided by the
// row sum at the end.
//
// What bounds them on an H100: operations. Hopper has no f32 tensor-core
// product; its TF32 products keep 10 mantissa bits of each operand, about
// 1e-3 of max|o| off, which the f32 tolerances refuse. So every product here
// is 3xTF32: each operand x splits into hi = tf32(x) and lo = tf32(x - hi)
// (`cvt.rna`: round to nearest, ties away from zero), and a product
// accumulates a_hi b_lo + a_lo b_hi + a_hi b_hi in f32, small terms first
// (the lo x lo term, 2^-22 of the product, is dropped), which keeps about 21
// of f32's 24 bits. That is three TF32 passes, so at best a third of the
// 494.7 TFLOP/s dense TF32 rate. At the DiChaViT-S flagship (B = 64, 6 heads
// of 64, n_valid = 1569) the forward's 4 B n_valid^2 D = 242 GFLOP are 0.49
// ms at one TF32 pass and 1.47 ms at three; its f32 traffic (q, k, v read
// once, o written once) 617 MB, 0.18 ms at 3.35 TB/s.
//
// Design: every product is `wgmma.mma_async ... .tf32` on 64-row warpgroup
// tiles, its shared-memory operands brought by TMA.
// - `.tf32` `wgmma` reads a shared-memory operand only K-major (the
//   reduction axis contiguous), and the hardware reads a TF32 operand's top
//   19 bits. So every operand a product reads from shared memory is there as
//   tf32 bit patterns, hi and lo: row-major for the products that reduce
//   over the head width (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V
//   dO^T), transposed for those that reduce over keys or queries (O += P V,
//   dV += P^T dO, dK += dS^T Q, dQ += dS K), whose B operand is V^T, dO^T,
//   Q^T or K^T.
// - The passes read q, k, v and do raw by TMA and split them in shared
//   memory, each streamed tile once for the two warpgroups of a block that
//   use it (below): no scratch, and no launch of its own.
// - P, P^T and dS go from one product's f32 accumulator to the next one's A
//   operand in registers, split there. The m64nN accumulator holds columns
//   (2t, 2t + 1) of rows (g, g + 8) of each 8-column step (g = lane / 4 +
//   16 warp, t = lane % 4), the m64k8 tf32 A fragment columns t and t + 4
//   (cute's ALayout_64x8). The order of keys inside an 8-key step is free in
//   a sum over keys, so A's column j is taken as key pi(j), pi = (0 2 4 6 1
//   3 5 7), and every transposed copy holds its rows in that order.
// - Where registers allow, the products over the head width take their A
//   operand's split fragments from registers too: Q's in S = Q K^T (the
//   forward at head width 64, the dq pass), dO's in dP = dO V^T (the dq
//   pass), K's in S^T = K Q^T (the dk/dv pass). A product of 32 columns
//   that reads its A tile from shared memory asks about 192 bytes a clock
//   of it, more than the SM's 128.
// - Sums over keys or queries (O, dV, dK, dQ) take each tile's products in
//   fresh accumulators, added to the running sums with f32 adds: the tensor
//   cores' f32 sums truncate where they align a product to the accumulator,
//   so a sum carried across every tile of a long row (50 tiles at N = 1600)
//   would drift by about an ulp of the running sum a tile.
// - The forward (FlashAttention-2's: online softmax in the log2 domain, O
//   divided by the row sum once at the end, each row's log-sum-exp written
//   for the backward) runs blocks of 128 query rows, Q's hi and lo
//   resident, on one stream of 32-key tiles (see fwd_kernel).
// - The backward at head width 64: di = rowsum(o do) per head; the
//   key-parallel dk/dv pass (blocks of 128 keys, K and V hi / lo resident,
//   128 KiB; stages of 32 queries) and the query-parallel dq pass (blocks of
//   128 queries, Q and dO hi / lo resident; stages of 32 keys), each block
//   two warpgroups of 64 rows on one stream of tiles (see kv_kernel). S and
//   dP are recomputed in both (seven products to the bound's five), which
//   buys a backward with no atomics: every sum in a fixed order, so two
//   calls on the same inputs agree bit for bit. Keys at or past `n_valid`
//   get P = 0, and their dk and dv rows are written as exact zeros.
// - At head width 128 a 64-key dk/dv block's resident hi / lo tiles (128
//   KiB) and one split 32-query tile (128 KiB) exceed a block's 227 KB (a
//   128-query dq block's are 128 KiB and 96 KiB), so
//   the backward there keeps the `mma.sync.m16n8k8` passes of the first f32
//   port (`legacy` below: fragments from `cp.async` tiles, split in the
//   product loop).
#pragma once

#include "flash_wgmma.cuh"

namespace dcvit {
namespace f32a {

constexpr int kRows = 64;     // rows of a warpgroup's wgmma tile
constexpr int kT = 32;        // keys (the dk/dv pass: queries) of a streamed tile
constexpr int kBoxCols = 32;  // f32 columns of a 128-byte swizzled box

// A row-major tile of `rows` x hd is boxes(hd) boxes of [rows][32] f32, each
// rows x 128 bytes (TMA's 128-byte swizzle, on 1024-byte boundaries); a
// transposed tile ([hd][32 keys]) is one box of hd rows.
__host__ __device__ constexpr int boxes(int hd) { return hd / kBoxCols; }
__host__ __device__ constexpr int box_bytes(int rows) { return rows * 128; }
__host__ __device__ constexpr int tile_bytes(int rows, int hd) {
  return boxes(hd) * box_bytes(rows);
}

// ---- the split -----------------------------------------------------------------

// tf32(x) as an f32 bit pattern: round to nearest, ties away from zero, on
// the 13 low mantissa bits, which come out zero
DEV uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
// x = hi + lo + (what tf32(x - hi) drops)
DEV void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
DEV void split4(const float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  split(x.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  split(x.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  split(x.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  split(x.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

// ---- TF32 wgmma ------------------------------------------------------------------
//
// `.tf32` `wgmma` is m64nNk8: eight tf32 values (32 bytes) of the reduction
// axis a step, so a k-step inside a 128-byte box row adds 32 bytes to the
// descriptor's start address, as bf16's k16 step does (wg::desc_k). It has
// no transpose immediates: both shared-memory operands are K-major.

// d[0:16] (+)= A(64 x 8) B(8 x 32), tf32 in, f32 accumulators in the m64n32
// layout; A and B from shared memory (K-major descriptors)
DEV void mma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:16] (+)= A(64 x 8, four tf32 registers a thread) B(8 x 32), B from
// shared memory (K-major descriptor)
DEV void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[0:32] (+)= A(64 x 8, four tf32 registers a thread) B(8 x 64), B from
// shared memory (K-major descriptor)
DEV void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[0:64] (+)= A(64 x 8, four tf32 registers a thread) B(8 x 128), B from
// shared memory (K-major descriptor)
DEV void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d = A B^T over the head width HD in 3xTF32, both from shared memory: A's
// 64 rows as boxes(HD) boxes [64][32] at a_hi / a_lo, B's kT rows as boxes
// [kT][32] at b_hi / b_lo. The products that reduce over the head width: S =
// Q K^T, dP = dO V^T and, in the dk/dv pass, S^T = K Q^T, dP^T = V dO^T. d
// is written, not added to (the first product's scale-d is 0).
template <int HD, int AROWS = kRows>
DEV void mma3_ss(float (&d)[kT / 2], uint32_t a_hi, uint32_t a_lo, uint32_t b_hi,
                 uint32_t b_lo) {
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc) {
    const int box = kc >> 2, ks = kc & 3;
    const uint32_t ah = a_hi + box * box_bytes(AROWS), al = a_lo + box * box_bytes(AROWS);
    const uint32_t bh = b_hi + box * box_bytes(kT), bl = b_lo + box * box_bytes(kT);
    mma_ss_n32(d, wg::desc_k(ah, ks), wg::desc_k(bl, ks), kc > 0);
    mma_ss_n32(d, wg::desc_k(al, ks), wg::desc_k(bh, ks), 1);
    mma_ss_n32(d, wg::desc_k(ah, ks), wg::desc_k(bh, ks), 1);
  }
}

// The A fragments of S = Q K^T (or dP = dO V^T) over the head width, split
// into hi and lo, read once from the warpgroup's 64 rows of hi / lo tiles at
// a_hi / a_lo (boxes(HD) boxes [AROWS][32], the warpgroup's rows from row0):
// k-step kc takes columns 8 kc .. 8 kc + 7, a[0] (g, t), a[1] (g + 8, t),
// a[2] (g, t + 4), a[3] (g + 8, t + 4) of the warp's 16 rows.
template <int HD, int AROWS>
DEV void row_frags(uint32_t (&hi)[HD / 8][4], uint32_t (&lo)[HD / 8][4], const uint8_t* a_hi,
                   const uint8_t* a_lo, int row0, int t) {
  const int r = row0 + 16 * (t >> 5) + ((t & 31) >> 2), tq = t & 3;
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r + 8 * (j & 1), col = 8 * kc + tq + 4 * (j >> 1);
      const uint32_t off = (col >> 5) * box_bytes(AROWS) + wg::swz_b(row, 4 * (col & 31));
      hi[kc][j] = *reinterpret_cast<const uint32_t*>(a_hi + off);
      lo[kc][j] = *reinterpret_cast<const uint32_t*>(a_lo + off);
    }
}

// mma3_ss with A from registers (row_frags): no shared-memory reads of A,
// which at N = 32 would ask more of shared memory than the products take.
template <int HD>
DEV void mma3_rs_rows(float (&d)[kT / 2], const uint32_t (&a_hi)[HD / 8][4],
                      const uint32_t (&a_lo)[HD / 8][4], uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc) {
    const int box = kc >> 2, ks = kc & 3;
    const uint32_t bh = b_hi + box * box_bytes(kT), bl = b_lo + box * box_bytes(kT);
    mma_rs_n32(d, a_hi[kc], wg::desc_k(bl, ks), kc > 0);
    mma_rs_n32(d, a_lo[kc], wg::desc_k(bh, ks), 1);
    mma_rs_n32(d, a_hi[kc], wg::desc_k(bh, ks), 1);
  }
}

// The A fragments of a product that reduces over a tile's kT columns, from
// the f32 accumulator c (64 x kT) of the product before, split into hi and
// lo: k-step ks takes columns 8 ks .. 8 ks + 7, A's column j as column
// pi(j): a[0] (g, 2t), a[1] (g + 8, 2t), a[2] (g, 2t + 1), a[3] (g + 8,
// 2t + 1).
DEV void frags(uint32_t (&hi)[kT / 8][4], uint32_t (&lo)[kT / 8][4], const float (&c)[kT / 2]) {
#pragma unroll
  for (int ks = 0; ks < kT / 8; ++ks) {
    split(c[4 * ks], hi[ks][0], lo[ks][0]);
    split(c[4 * ks + 2], hi[ks][1], lo[ks][1]);
    split(c[4 * ks + 1], hi[ks][2], lo[ks][2]);
    split(c[4 * ks + 3], hi[ks][3], lo[ks][3]);
  }
}

template <int HD>
DEV void mma_rs(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  static_assert(HD == 64 || HD == 128, "head width 64 or 128");
  if constexpr (HD == 64)
    mma_rs_n64(d, a, db, accumulate);
  else
    mma_rs_n128(d, a, db, accumulate);
}

// d = A B over one tile's kT keys (or queries) in 3xTF32: A from frags, B
// the transposed tile (HD x kT, one [HD][32] box, K-major, pi order) at
// b_hi / b_lo. One tile of the products that reduce over keys or queries: O
// = P V, dV = P^T dO, dK = dS^T Q, dQ = dS K. d is written, not added to.
template <int HD>
DEV void mma3_rs(float (&d)[HD / 2], const uint32_t (&hi)[kT / 8][4],
                 const uint32_t (&lo)[kT / 8][4], uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int ks = 0; ks < kT / 8; ++ks) {
    mma_rs<HD>(d, hi[ks], wg::desc_k(b_lo, ks), ks > 0);
    mma_rs<HD>(d, lo[ks], wg::desc_k(b_hi, ks), 1);
    mma_rs<HD>(d, hi[ks], wg::desc_k(b_hi, ks), 1);
  }
}

// ---- tiles split in shared memory ------------------------------------------------
//
// Every pass runs blocks of two warpgroups (256 threads, one block an SM):
// 128 resident rows (64 a warpgroup) and one stream of 32-row tiles shared
// by both. The streamed tiles arrive raw (TMA, a ring of stages that thread
// 0 refills), and the block splits each in shared memory into the hi / lo
// tiles and transposed copies its products read, then both warpgroups run
// their products on them. The resident tiles arrive raw too, through the
// same space, and are split once. Raw f32 is a quarter of the bytes of hi /
// lo rows and transposes, and a tile shared by two warpgroups halves them
// again.
constexpr int kWgs = 2;
constexpr int kBlockThreads = 128 * kWgs;
constexpr int kBlockRows = kRows * kWgs;

// The f32 tensors a pass reads, raw, each a TMA map over B images of (N, D)
// rows (q, k and v with their own row strides), boxes [32][32]; the forward
// reads no dO.
struct RawMaps {
  CUtensorMap q, k, v, dO;
};

// Where the position-p element of an 8-row group's transposed copy comes
// from is row pi(p); row r goes to position pos(r) = r / 2 + 4 (r % 2).
DEV int pos_of(int r) { return (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1); }

// A raw f32 tile of 32 rows x HD (boxes(HD) boxes [32][32] at `raw`) and
// where its split goes: where hi is set, hi and lo with the same layout;
// where thi is set, the transposed copies (one [HD][32] box each at thi,
// tlo, the rows in pi order).
struct SplitTile {
  const uint8_t* raw;
  uint8_t *hi, *lo, *thi, *tlo;
};

// Split two raw tiles `a` and `b` (the streamed operands of a pass's
// products) into tf32 hi and lo and, where asked, their transposed copies,
// all WARPS warps of the block. Lane l takes row l, the warps the row's
// 16-byte chunks in turn: each warp reads and writes whole 128-byte rows, and
// its transposed stores fill one box row (no bank conflicts). Every load is
// issued before the first split, as the block has few warps to hide their
// latency with.
template <int HD, int WARPS>
DEV void convert_tiles(const SplitTile& a, const SplitTile& b, int warp, int lane) {
  constexpr int kIt = HD / 4 / WARPS;  // chunks a warp takes from a tile
  static_assert(kIt * WARPS * 4 == HD, "the warps share a row's chunks evenly");
  const int p = pos_of(lane);
  float4 x[2][kIt];
  uint32_t off[kIt];
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int c4 = (warp + i * WARPS) * 4;
    off[i] = (c4 >> 5) * box_bytes(kT) + wg::swz_b(lane, 4 * (c4 & 31));
    x[0][i] = *reinterpret_cast<const float4*>(a.raw + off[i]);
    x[1][i] = *reinterpret_cast<const float4*>(b.raw + off[i]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const SplitTile& tile = u == 0 ? a : b;
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      float4 h, l;
      split4(x[u][i], h, l);
      if (tile.hi != nullptr) {
        *reinterpret_cast<float4*>(tile.hi + off[i]) = h;
        *reinterpret_cast<float4*>(tile.lo + off[i]) = l;
      }
      if (tile.thi != nullptr) {
        const int c4 = (warp + i * WARPS) * 4;
        const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t toff = wg::swz_b(c4 + e, 4 * p);
          *reinterpret_cast<float*>(tile.thi + toff) = hv[e];
          *reinterpret_cast<float*>(tile.tlo + toff) = lv[e];
        }
      }
    }
  }
}

// Split `bytes` of raw f32 at `raw` into hi and lo at the same offsets (a
// pass's resident tiles, whatever their layout), all threads of the block.
DEV void convert_flat(const uint8_t* raw, uint8_t* hi, uint8_t* lo, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) {
    float4 h, l;
    split4(*reinterpret_cast<const float4*>(raw + i), h, l);
    *reinterpret_cast<float4*>(hi + i) = h;
    *reinterpret_cast<float4*>(lo + i) = l;
  }
}

// Rows r0 .. r0 + 128 of image b's head columns hc .. hc + HD of `map` into
// `dst` as boxes(HD) boxes [128][32] (each as four [32][32] boxes, the map's
// box: the same bytes, a box's swizzle following its rows modulo 8).
template <int HD>
DEV void load_rows128(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int hc, int r0,
                      int b) {
  for (int j = 0; j < boxes(HD); ++j)
    for (int r = 0; r < kBlockRows; r += kT)
      fw::tma_load3(dst + j * box_bytes(kBlockRows) + r * 128, map, bar, hc + j * kBoxCols,
                    r0 + r, b);
}

// ---- the forward --------------------------------------------------------------------

// The query-parallel forward: o and lse of 128 query rows of one head.
// Grid (N / 128 rounded up, heads, B). Shared memory: Q hi, Q lo resident
// ([128][HD] each); the split tile of 32 keys below n_valid: K hi, K lo
// ([32][HD]), V^T hi, V^T lo ([HD][32]); the raw ring (K, V). Q arrives raw
// through the split tile's and the ring's space. At head width 64 the
// split tile is double-buffered and the ring has two stages: the next
// tile is split while this tile's S = Q K^T runs, one barrier a tile. At
// 128 two buffers or two stages would pass 227 KB: one of each, the split
// between two barriers, the next tile's load still under this tile's
// products.
template <int HD>
constexpr int kFwdStages = HD == 64 ? 2 : 1;
template <int HD>
constexpr int kFwdBufs = HD == 64 ? 2 : 1;
template <int HD>
constexpr int kFwdSplitBytes = 2 * tile_bytes(kT, HD) + 2 * box_bytes(HD);
template <int HD>
constexpr int kFwdRawBytes = 2 * tile_bytes(kT, HD);
template <int HD>
constexpr int kFwdSmem = 2 * tile_bytes(kBlockRows, HD) + kFwdBufs<HD> * kFwdSplitBytes<HD> +
                         kFwdStages<HD> * kFwdRawBytes<HD> + (kFwdStages<HD> + 1) * 8 +
                         wg::kAlign;

// o (B, N, heads * HD) contiguous; lse (B, heads, N) or null.
template <int HD>
__global__ void __launch_bounds__(kBlockThreads, 1)
    fwd_kernel(const __grid_constant__ RawMaps maps, float* __restrict__ o,
               float* __restrict__ lse, int n, int n_valid, float scale_log2) {
  constexpr int kS = kFwdStages<HD>, nb = boxes(HD), kRes = tile_bytes(kBlockRows, HD);
  constexpr int kK = tile_bytes(kT, HD), kX = box_bytes(HD), kRaw = kFwdRawBytes<HD>;
  constexpr int kB = kFwdBufs<HD>, kSB = kFwdSplitBytes<HD>;
  static_assert(kFwdSplitBytes<HD> + kS * kRaw >= kRes,
                "Q arrives raw through the split tile's and the ring's space");
  extern __shared__ uint8_t smem_raw[];
  const int g = wg::warpgroup(), t = threadIdx.x & 127;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* res = wg::align(smem_raw);  // Q hi, Q lo
  uint8_t* cvt = res + 2 * kRes;       // buffer u: K hi, K lo, V^T hi, V^T lo
  uint8_t* ring = cvt + kB * kSB;      // stage s: K raw, V raw
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kS * kRaw);
  uint64_t* resbar = full + kS;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int hc = h * HD, n_kt = (n_valid + kT - 1) / kT, qw = q0 + g * kRows;
  init_bars(full, kS);

  auto load = [&](int kt) {
    const int s = kt % kS;
    uint8_t* st = ring + s * kRaw;
    wg::bar_expect_tx(&full[s], kRaw);
    for (int j = 0; j < nb; ++j) {
      fw::tma_load3(st + j * box_bytes(kT), &maps.k, &full[s], hc + j * kBoxCols, kt * kT, b);
      fw::tma_load3(st + kK + j * box_bytes(kT), &maps.v, &full[s], hc + j * kBoxCols,
                    kt * kT, b);
    }
  };
  if (threadIdx.x == 0) {
    wg::bar_expect_tx(resbar, kRes);
    load_rows128<HD>(cvt, &maps.q, resbar, hc, q0, b);
  }
  wg::bar_wait(resbar, 0);
  convert_flat(cvt, res, res + kRes, kRes);
  __syncthreads();  // the raw Q is read: the ring may be filled
  if (threadIdx.x == 0)
    for (int kt = 0; kt < kS && kt < n_kt; ++kt) load(kt);
  // at head width 64 Q's split fragments stay in registers for S = Q K^T
  constexpr bool kQRegs = HD == 64;
  uint32_t qf_hi[kQRegs ? HD / 8 : 1][4], qf_lo[kQRegs ? HD / 8 : 1][4];
  if constexpr (kQRegs) row_frags<HD, kBlockRows>(qf_hi, qf_lo, res, res + kRes, g * kRows, t);

  float acc[HD / 2];
  wg::acc_zero(acc);
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g + 8 (log2)
  // this warpgroup's 64 rows of each resident box
  const uint32_t res_s = smem_addr(res) + g * kRows * 128, cvt_s = smem_addr(cvt);
  auto convert = [&](int kt) {
    const int s = kt % kS;
    wg::bar_wait(&full[s], (kt / kS) & 1);
    const uint8_t* st = ring + s * kRaw;
    uint8_t* c = cvt + (kt % kB) * kSB;
    convert_tiles<HD, kBlockThreads / 32>({st, c, c + kK, nullptr, nullptr},
                                          {st + kK, nullptr, nullptr, c + 2 * kK,
                                           c + 2 * kK + kX},
                                          warp, lane);
  };
  if constexpr (kB == 2) {
    convert(0);
    wg::fence_async_smem();
    __syncthreads();  // the first split tile is ready, its raw stage read
    if (threadIdx.x == 0 && kS < n_kt) load(kS);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    if constexpr (kB == 1) {
      convert(kt);
      wg::fence_async_smem();
      __syncthreads();  // the split tile is ready, the raw stage read
      if (threadIdx.x == 0 && kt + kS < n_kt) load(kt + kS);
    }
    const uint32_t sp = wg::opaque(cvt_s) + (kt % kB) * kSB;
    float sc[kT / 2];
    wg::mma_fence();
    if constexpr (kQRegs) {
      mma3_rs_rows<HD>(sc, qf_hi, qf_lo, sp, sp + kK);
    } else {
      const uint32_t qs = wg::opaque(res_s);
      mma3_ss<HD, kBlockRows>(sc, qs, qs + kRes, sp, sp + kK);
    }
    wg::mma_commit();
    if constexpr (kB == 2)
      if (kt + 1 < n_kt) convert(kt + 1);  // under the products of this tile
    wg::mma_wait<0>();
    wg::acc_fence(sc);
    // keys at or past n_valid: -inf, so P = 0
    const int key0 = kt * kT;
    if (key0 + kT > n_valid) {
#pragma unroll
      for (int i = 0; i < kT / 2; ++i)
        if (key0 + wg::acc_col(t, i) >= n_valid) sc[i] = -INFINITY;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < kT / 2; i += 4) {
      mx_a = fmaxf(mx_a, fmaxf(sc[i], sc[i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[i + 2], sc[i + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // the running max in the log2 domain (scale_log2 > 0 keeps the order)
    const float nm_a = fmaxf(m_a, mx_a * scale_log2), nm_b = fmaxf(m_b, mx_b * scale_log2);
    const float alpha_a = fw::ex2(m_a - nm_a), alpha_b = fw::ex2(m_b - nm_b);
    m_a = nm_a;
    m_b = nm_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int i = 0; i < kT / 2; i += 4) {
      sc[i] = fw::ex2(fmaf(sc[i], scale_log2, -m_a));
      sc[i + 1] = fw::ex2(fmaf(sc[i + 1], scale_log2, -m_a));
      sc[i + 2] = fw::ex2(fmaf(sc[i + 2], scale_log2, -m_b));
      sc[i + 3] = fw::ex2(fmaf(sc[i + 3], scale_log2, -m_b));
      rs_a += sc[i] + sc[i + 1];
      rs_b += sc[i + 2] + sc[i + 3];
    }
    l_a = l_a * alpha_a + rs_a;  // this thread's columns; summed over the quad at the end
    l_b = l_b * alpha_b + rs_b;
    uint32_t p_hi[kT / 8][4], p_lo[kT / 8][4];
    frags(p_hi, p_lo, sc);
    // this tile's P V in fresh registers, then added with f32 adds
    float pv[HD / 2];
    wg::mma_fence();
    mma3_rs<HD>(pv, p_hi, p_lo, sp + 2 * kK, sp + 2 * kK + kX);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(pv);
    fw::frag_fence(p_hi);
    fw::frag_fence(p_lo);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = fmaf(acc[i], (i & 2) ? alpha_b : alpha_a, pv[i]);
    if constexpr (kB == 2) {
      wg::fence_async_smem();
      __syncthreads();  // the next split tile is ready, this one and the raw stage read
      if (threadIdx.x == 0 && kt + 1 + kS < n_kt) load(kt + 1 + kS);
    } else {
      __syncthreads();  // both warpgroups are done with the split tile
    }
  }

  if (qw >= n) return;  // the last block's second warpgroup may have no rows
  l_a = sum_over_quad(l_a);
  l_b = sum_over_quad(l_b);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  const int row_a = qw + wg::acc_row(t, 0);
  const long long d = (long long)heads * HD;
  float* oa = o + ((long long)b * n + row_a) * d + hc;
  float* ob = oa + 8 * d;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 4) {
    const int col = wg::acc_col(t, i);
    *reinterpret_cast<float2*>(oa + col) = make_float2(acc[i] * inv_a, acc[i + 1] * inv_a);
    *reinterpret_cast<float2*>(ob + col) = make_float2(acc[i + 2] * inv_b, acc[i + 3] * inv_b);
  }
  if (lse != nullptr && (t & 3) == 0) {
    float* lrow = lse + ((long long)b * heads + h) * n;
    lrow[row_a] = (m_a + log2f(l_a)) * fw::kLn2;
    lrow[row_a + 8] = (m_b + log2f(l_b)) * fw::kLn2;
  }
}

template <int HD>
cudaError_t launch_fwd(const RawMaps& maps, float* o, float* lse, int batch, int n, int heads,
                       int n_valid, float sm_scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFwdSmem<HD>);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, heads, batch);
  fwd_kernel<HD><<<grid, kBlockThreads, kFwdSmem<HD>, st>>>(maps, o, lse, n, n_valid,
                                                            sm_scale * fw::kLog2e);
  return cudaGetLastError();
}

// ---- the backward ---------------------------------------------------------------------

// di[b, h, r] = sum over the head's columns of o * do, f32: one warp a row,
// HD / 32 columns of each head a lane. Grid (B * N / 8), 256 threads.
template <int HD>
__global__ void __launch_bounds__(256)
    di_kernel(const float* __restrict__ o, const float* __restrict__ dO, float* __restrict__ di,
              int n, int heads) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * 8 + warp;  // b * n + r
  const long long b = row / n, r = row - b * n;
  const long long d = (long long)heads * HD;
  for (int h = 0; h < heads; ++h) {
    const long long off = row * d + h * HD + lane * (HD / 32);
    float s;
    if constexpr (HD == 64) {
      const float2 x = *reinterpret_cast<const float2*>(o + off);
      const float2 y = *reinterpret_cast<const float2*>(dO + off);
      s = x.x * y.x + x.y * y.y;
    } else {
      const float4 x = *reinterpret_cast<const float4*>(o + off);
      const float4 y = *reinterpret_cast<const float4*>(dO + off);
      s = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
    s = warp_sum(s);
    if (lane == 0) di[(b * heads + h) * n + r] = s;
  }
}

// The head-width-64 passes' raw ring: two stages.
constexpr int kRawStages = 2;

// The key-parallel pass: dk and dv of 128 keys of one head. Grid (N / 128
// rounded up, heads, B). Shared memory: K hi, K lo, V hi, V lo resident
// ([128][HD] each); the split tile of 32 queries: Q hi, Q lo, dO hi, dO lo
// ([32][HD]), Q^T hi, Q^T lo, dO^T hi, dO^T lo ([HD][32]), its lse and di;
// the raw ring (Q, dO; lse and di). Every query row is streamed, padded ones
// too (the plain version sums them). dk and dv go to grads (B, N, 3D) at
// columns D and 2D.
template <int HD>
constexpr int kKvSplitBytes = 4 * tile_bytes(kT, HD) + 4 * box_bytes(HD);
template <int HD>
constexpr int kKvRawBytes = 2 * tile_bytes(kT, HD);
template <int HD>
constexpr int kKvSmem = 4 * tile_bytes(kBlockRows, HD) + kKvSplitBytes<HD> +
                        kRawStages * kKvRawBytes<HD> + (kRawStages + 1) * 2 * kT * 4 +
                        (kRawStages + 1) * 8 + wg::kAlign;

template <int HD>
__global__ void __launch_bounds__(kBlockThreads, 1)
    kv_kernel(const __grid_constant__ RawMaps maps, const float* __restrict__ lse,
              const float* __restrict__ di, float* __restrict__ grads, int n, int n_valid,
              float scale_log2, float sm_scale) {
  static_assert(HD == 64, "the resident tiles of 128 keys fit shared memory at head width 64");
  constexpr int nb = boxes(HD), kRes = tile_bytes(kBlockRows, HD), kQ = tile_bytes(kT, HD);
  constexpr int kX = box_bytes(HD), kRaw = kKvRawBytes<HD>;
  const int g = wg::warpgroup(), t = threadIdx.x & 127;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int hc = h * HD, kw = k0 + g * kRows;  // this warpgroup's first key
  const long long d = (long long)heads * HD;
  const int key_a = kw + wg::acc_row(t, 0);
  float* dka = grads + ((long long)b * n + key_a) * 3 * d + d + hc;
  float* dkb = dka + 8 * 3 * d;
  const bool valid_a = key_a < n_valid, valid_b = key_a + 8 < n_valid;

  if (k0 >= n_valid) {  // every key of the block masked: dk = dv = 0
    if (kw >= n) return;
    const float2 z = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < HD / 2; i += 4) {
      const int col = wg::acc_col(t, i);
      *reinterpret_cast<float2*>(dka + col) = z;
      *reinterpret_cast<float2*>(dkb + col) = z;
      *reinterpret_cast<float2*>(dka + d + col) = z;
      *reinterpret_cast<float2*>(dkb + d + col) = z;
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res = wg::align(smem_raw);  // K hi, K lo, V hi, V lo
  uint8_t* cvt = res + 4 * kRes;       // Q hi, Q lo, dO hi, dO lo, Q^T hi, lo, dO^T hi, lo
  uint8_t* ring = cvt + kKvSplitBytes<HD>;  // stage s: Q raw, dO raw
  float* stats = reinterpret_cast<float*>(ring + kRawStages * kRaw);  // stage s: lse, di; then the split tile's
  float* tstats = stats + kRawStages * 2 * kT;
  uint64_t* full = reinterpret_cast<uint64_t*>(tstats + 2 * kT);
  uint64_t* resbar = full + kRawStages;
  const int nq = n / kT;
  init_bars(full, kRawStages);

  const float* lrow = lse + ((long long)b * heads + h) * n;
  const float* drow = di + ((long long)b * heads + h) * n;
  auto load = [&](int qt) {
    const int s = qt % kRawStages;
    uint8_t* st = ring + s * kRaw;
    wg::bar_expect_tx(&full[s], kRaw + 2 * kT * 4);
    for (int j = 0; j < nb; ++j) {
      fw::tma_load3(st + j * box_bytes(kT), &maps.q, &full[s], hc + j * kBoxCols, qt * kT, b);
      fw::tma_load3(st + kQ + j * box_bytes(kT), &maps.dO, &full[s], hc + j * kBoxCols,
                    qt * kT, b);
    }
    fw::bulk_load(stats + s * 2 * kT, lrow + qt * kT, kT * 4, &full[s]);
    fw::bulk_load(stats + s * 2 * kT + kT, drow + qt * kT, kT * 4, &full[s]);
  };
  if (threadIdx.x == 0) {
    // K and V raw through the split tile's space, then the ring's first stages
    wg::bar_expect_tx(resbar, 2 * kRes);
    load_rows128<HD>(cvt, &maps.k, resbar, hc, k0, b);
    load_rows128<HD>(cvt + kRes, &maps.v, resbar, hc, k0, b);
    for (int qt = 0; qt < kRawStages && qt < nq; ++qt) load(qt);
  }
  wg::bar_wait(resbar, 0);
  convert_flat(cvt, res, res + kRes, kRes);
  convert_flat(cvt + kRes, res + 2 * kRes, res + 3 * kRes, kRes);
  __syncthreads();  // the split tile's space is read: it may be rewritten

  float dk[HD / 2], dv[HD / 2];
  wg::acc_zero(dk);
  wg::acc_zero(dv);
  // K's split fragments in registers for S^T = K Q^T (dP^T = V dO^T reads V
  // from shared memory)
  uint32_t kf_hi[HD / 8][4], kf_lo[HD / 8][4];
  row_frags<HD, kBlockRows>(kf_hi, kf_lo, res, res + kRes, g * kRows, t);
  // this warpgroup's 64 rows of each resident box
  const uint32_t res_s = smem_addr(res) + g * kRows * 128, cvt_s = smem_addr(cvt);
  const float* l_t = tstats;
  const float* d_t = tstats + kT;
  for (int qt = 0; qt < nq; ++qt) {
    const int s = qt % kRawStages;
    wg::bar_wait(&full[s], (qt / kRawStages) & 1);
    const uint8_t* st = ring + s * kRaw;
    convert_tiles<HD, kBlockThreads / 32>(
        {st, cvt, cvt + kQ, cvt + 4 * kQ, cvt + 4 * kQ + kX},
        {st + kQ, cvt + 2 * kQ, cvt + 3 * kQ, cvt + 4 * kQ + 2 * kX, cvt + 4 * kQ + 3 * kX},
        warp, lane);
    if (threadIdx.x < 2 * kT) tstats[threadIdx.x] = stats[s * 2 * kT + threadIdx.x];
    wg::fence_async_smem();
    __syncthreads();  // the split tile is ready, the raw stage read
    if (threadIdx.x == 0 && qt + kRawStages < nq) load(qt + kRawStages);

    const uint32_t sp = wg::opaque(cvt_s), kv = wg::opaque(res_s);
    const uint32_t xt = sp + 4 * kQ;
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries
    float sc[kT / 2], dp[kT / 2];
    wg::mma_fence();
    mma3_rs_rows<HD>(sc, kf_hi, kf_lo, sp, sp + kQ);
    wg::mma_commit();
    mma3_ss<HD, kBlockRows>(dp, kv + 2 * kRes, kv + 3 * kRes, sp + 2 * kQ, sp + 3 * kQ);
    wg::mma_commit();
    // P^T = exp2(S^T scale log2e - lse log2e); padded keys exactly 0
    wg::mma_wait<1>();
    wg::acc_fence(sc);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
      const bool valid = (i & 2) ? valid_b : valid_a;
      const float l2 = l_t[wg::acc_col(t, i)] * fw::kLog2e;
      sc[i] = valid ? fw::ex2(fmaf(sc[i], scale_log2, -l2)) : 0.f;
    }
    // dS^T = P^T (dP^T - di) scale
    wg::mma_wait<0>();
    wg::acc_fence(dp);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) dp[i] = sc[i] * (dp[i] - d_t[wg::acc_col(t, i)]) * sm_scale;
    uint32_t p_hi[kT / 8][4], p_lo[kT / 8][4], s_hi[kT / 8][4], s_lo[kT / 8][4];
    frags(p_hi, p_lo, sc);
    frags(s_hi, s_lo, dp);
    // this tile's dV = P^T dO, then dK = dS^T Q, each in fresh registers
    float part[HD / 2];
    wg::mma_fence();
    mma3_rs<HD>(part, p_hi, p_lo, xt + 2 * kX, xt + 3 * kX);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(part);
    fw::frag_fence(p_hi);
    fw::frag_fence(p_lo);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dv[i] += part[i];
    wg::mma_fence();
    mma3_rs<HD>(part, s_hi, s_lo, xt, xt + kX);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(part);
    fw::frag_fence(s_hi);
    fw::frag_fence(s_lo);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] += part[i];
    __syncthreads();  // both warpgroups are done with the split tile
  }

  if (kw >= n) return;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 4) {
    const int col = wg::acc_col(t, i);
    const float2 z = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(dka + col) = valid_a ? make_float2(dk[i], dk[i + 1]) : z;
    *reinterpret_cast<float2*>(dkb + col) = valid_b ? make_float2(dk[i + 2], dk[i + 3]) : z;
    *reinterpret_cast<float2*>(dka + d + col) = valid_a ? make_float2(dv[i], dv[i + 1]) : z;
    *reinterpret_cast<float2*>(dkb + d + col) = valid_b ? make_float2(dv[i + 2], dv[i + 3]) : z;
  }
}

// The query-parallel pass: dq of 128 query rows of one head. Grid (N / 128
// rounded up, heads, B). Shared memory: Q hi, Q lo, dO hi, dO lo resident
// ([128][HD] each); the split tile of 32 keys below n_valid: K hi, K lo, V
// hi, V lo ([32][HD]), K^T hi, K^T lo ([HD][32]); the raw ring (K, V). dq
// goes to grads (B, N, 3D) at column 0.
template <int HD>
constexpr int kQSplitBytes = 4 * tile_bytes(kT, HD) + 2 * box_bytes(HD);
template <int HD>
constexpr int kQRawBytes = 2 * tile_bytes(kT, HD);
template <int HD>
constexpr int kQSmem = 4 * tile_bytes(kBlockRows, HD) + kQSplitBytes<HD> +
                       kRawStages * kQRawBytes<HD> + (kRawStages + 1) * 8 + wg::kAlign;

template <int HD>
__global__ void __launch_bounds__(kBlockThreads, 1)
    q_kernel(const __grid_constant__ RawMaps maps, const float* __restrict__ lse,
             const float* __restrict__ di, float* __restrict__ grads, int n, int n_valid,
             float scale_log2, float sm_scale) {
  static_assert(HD == 64, "the resident tiles of 128 rows fit shared memory at head width 64");
  constexpr int nb = boxes(HD), kRes = tile_bytes(kBlockRows, HD), kK = tile_bytes(kT, HD);
  constexpr int kX = box_bytes(HD), kRaw = kQRawBytes<HD>;
  static_assert(kQSplitBytes<HD> + kRawStages * kRaw >= 2 * kRes,
                "Q and dO arrive raw through the split tile's and the ring's space");
  extern __shared__ uint8_t smem_raw[];
  const int g = wg::warpgroup(), t = threadIdx.x & 127;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* res = wg::align(smem_raw);  // Q hi, Q lo, dO hi, dO lo
  uint8_t* cvt = res + 4 * kRes;       // K hi, K lo, V hi, V lo, K^T hi, K^T lo
  uint8_t* ring = cvt + kQSplitBytes<HD>;  // stage s: K raw, V raw
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRawStages * kRaw);
  uint64_t* resbar = full + kRawStages;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int hc = h * HD, n_kt = (n_valid + kT - 1) / kT, qw = q0 + g * kRows;
  const long long d = (long long)heads * HD;
  init_bars(full, kRawStages);

  auto load = [&](int kt) {
    const int s = kt % kRawStages;
    uint8_t* st = ring + s * kRaw;
    wg::bar_expect_tx(&full[s], kRaw);
    for (int j = 0; j < nb; ++j) {
      fw::tma_load3(st + j * box_bytes(kT), &maps.k, &full[s], hc + j * kBoxCols, kt * kT, b);
      fw::tma_load3(st + kK + j * box_bytes(kT), &maps.v, &full[s], hc + j * kBoxCols,
                    kt * kT, b);
    }
  };
  if (threadIdx.x == 0) {
    // Q and dO raw through the split tile's and the ring's space
    wg::bar_expect_tx(resbar, 2 * kRes);
    load_rows128<HD>(cvt, &maps.q, resbar, hc, q0, b);
    load_rows128<HD>(cvt + kRes, &maps.dO, resbar, hc, q0, b);
  }
  const int row_a = qw + wg::acc_row(t, 0);
  const bool live = qw < n;  // the last block's second warpgroup may have no rows
  const long long stat = ((long long)b * heads + h) * n;
  const float l2_a = live ? lse[stat + row_a] * fw::kLog2e : 0.f;
  const float l2_b = live ? lse[stat + row_a + 8] * fw::kLog2e : 0.f;
  const float di_a = live ? di[stat + row_a] : 0.f, di_b = live ? di[stat + row_a + 8] : 0.f;
  wg::bar_wait(resbar, 0);
  convert_flat(cvt, res, res + kRes, kRes);
  convert_flat(cvt + kRes, res + 2 * kRes, res + 3 * kRes, kRes);
  __syncthreads();  // the raw Q and dO are read: the ring may be filled
  if (threadIdx.x == 0)
    for (int kt = 0; kt < kRawStages && kt < n_kt; ++kt) load(kt);

  float dq[HD / 2];
  wg::acc_zero(dq);
  // Q's and dO's split fragments in registers for S = Q K^T and dP = dO V^T
  uint32_t qf_hi[HD / 8][4], qf_lo[HD / 8][4], of_hi[HD / 8][4], of_lo[HD / 8][4];
  row_frags<HD, kBlockRows>(qf_hi, qf_lo, res, res + kRes, g * kRows, t);
  row_frags<HD, kBlockRows>(of_hi, of_lo, res + 2 * kRes, res + 3 * kRes, g * kRows, t);
  const uint32_t cvt_s = smem_addr(cvt);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kRawStages;
    wg::bar_wait(&full[s], (kt / kRawStages) & 1);
    const uint8_t* st = ring + s * kRaw;
    convert_tiles<HD, kBlockThreads / 32>({st, cvt, cvt + kK, cvt + 4 * kK, cvt + 4 * kK + kX},
                                        {st + kK, cvt + 2 * kK, cvt + 3 * kK, nullptr, nullptr},
                                        warp, lane);
    wg::fence_async_smem();
    __syncthreads();  // the split tile is ready, the raw stage read
    if (threadIdx.x == 0 && kt + kRawStages < n_kt) load(kt + kRawStages);

    const uint32_t sp = wg::opaque(cvt_s);
    // S = Q K^T and dP = dO V^T: 64 queries x 32 keys
    float sc[kT / 2], dp[kT / 2];
    wg::mma_fence();
    mma3_rs_rows<HD>(sc, qf_hi, qf_lo, sp, sp + kK);
    wg::mma_commit();
    mma3_rs_rows<HD>(dp, of_hi, of_lo, sp + 2 * kK, sp + 3 * kK);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(sc);
    wg::acc_fence(dp);
    // dS = P (dP - di) scale, P = exp2(S scale log2e - lse log2e), keys at or
    // past n_valid 0
    const int key0 = kt * kT;
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
      const bool rb = (i & 2) != 0;
      const bool valid = key0 + wg::acc_col(t, i) < n_valid;
      const float p = valid ? fw::ex2(fmaf(sc[i], scale_log2, rb ? -l2_b : -l2_a)) : 0.f;
      sc[i] = p * (dp[i] - (rb ? di_b : di_a)) * sm_scale;
    }
    uint32_t s_hi[kT / 8][4], s_lo[kT / 8][4];
    frags(s_hi, s_lo, sc);
    // this tile's dQ = dS K in fresh registers
    float part[HD / 2];
    wg::mma_fence();
    mma3_rs<HD>(part, s_hi, s_lo, sp + 4 * kK, sp + 4 * kK + kX);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::acc_fence(part);
    fw::frag_fence(s_hi);
    fw::frag_fence(s_lo);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] += part[i];
    __syncthreads();  // both warpgroups are done with the split tile
  }

  if (!live) return;
  float* qa = grads + ((long long)b * n + row_a) * 3 * d + hc;
  float* qb = qa + 8 * 3 * d;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 4) {
    const int col = wg::acc_col(t, i);
    *reinterpret_cast<float2*>(qa + col) = make_float2(dq[i], dq[i + 1]);
    *reinterpret_cast<float2*>(qb + col) = make_float2(dq[i + 2], dq[i + 3]);
  }
}

// ---- the head-width-128 backward: the first f32 port's mma.sync passes ----------------
//
// `mma.sync.m16n8k8.tf32` products of 4 warps of 16 rows, fragments loaded
// from row-major `cp.async` tiles (rows padded to HD + 4 floats: no bank
// conflicts) and split in the product loop; the same three passes, sums
// and guarantees as above; one block an SM (133 KiB).
namespace legacy {

constexpr int kRows = 64;      // rows of a block: 4 warps x 16
constexpr int kThreads = 128;  // 4 warps
// the streamed tile's rows, the padded row stride (floats) of every tile
template <int HD>
constexpr int kTile = HD == 64 ? 64 : 32;
template <int HD>
constexpr int kLd = HD + 4;
template <int HD>
constexpr int kTileFloats = kTile<HD> * kLd<HD>;
template <int HD>
constexpr int kBlockFloats = kRows * kLd<HD>;
// blocks an SM each pass is built for (its launch bound)
template <int HD>
constexpr int kBwdBlocks = HD == 64 ? 2 : 1;
// shared memory: two resident 64-row tiles and a ring of two streamed
// tiles, plus the dk/dv pass's lse and di rows
template <int HD>
constexpr int kBwdSmem = (2 * kBlockFloats<HD> + 2 * (2 * kTileFloats<HD> + 2 * kTile<HD>)) * 4;

// ---- cp.async ---------------------------------------------------------------

DEV void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
DEV void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most one committed group is still in flight
DEV void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// rows x HD floats from global (rows `stride` floats apart) into a tile of
// rows kLd<HD> floats apart, 16 bytes a thread
template <int HD, int ROWS>
DEV void load_rows(float* dst, const float* src, long long stride, int tid) {
  constexpr int kChunks = HD / 4;
#pragma unroll 4
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    cp16(dst + r * kLd<HD> + c, src + r * stride + c);
  }
}

// `count` floats (a multiple of 4) from global into shared memory
DEV void load_vec(float* dst, const float* src, int count, int tid) {
  for (int i = tid * 4; i < count; i += kThreads * 4) cp16(dst + i, src + i);
}

// ---- 3xTF32 products --------------------------------------------------------

// x = hi + lo + (what tf32(x - hi) drops), hi and lo as tf32 bit patterns
DEV void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d (16 x 8, f32) += a (16 x 8) b (8 x 8), one TF32 pass
DEV void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A operand split once, used against many B operands.
struct AFrag {
  uint32_t hi[4], lo[4];
};

// d += a b in 3xTF32, the small terms first
DEV void mma3(float (&d)[4], const AFrag& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// The A operand (16 rows x 8 columns) at column c0 of a row-major tile whose
// row 0 is this warp's first: a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4).
template <int LD>
DEV AFrag a_from_tile(const float* tile, int c0, int g, int t) {
  AFrag a;
  split(tile[g * LD + c0 + t], a.hi[0], a.lo[0]);
  split(tile[(g + 8) * LD + c0 + t], a.hi[1], a.lo[1]);
  split(tile[g * LD + c0 + t + 4], a.hi[2], a.lo[2]);
  split(tile[(g + 8) * LD + c0 + t + 4], a.hi[3], a.lo[3]);
  return a;
}

// The A operand from an accumulator c (columns 2t, 2t + 1 of rows g, g + 8):
// A's column t is the accumulator's column 2t and t + 4 its 2t + 1, so the
// B operand's row t must be the one of column 2t and row t + 4 that of 2t + 1
// (as mma_paired reads them).
DEV AFrag a_from_acc(const float (&c)[4]) {
  AFrag a;
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
  return a;
}

// acc[j] (16 x 8 at columns 8j) += A (16 x HD, rows of `tile` from this
// warp's first) B^T where B's rows are those of `rows` (8 per j): products
// that reduce over the head width (S = Q K^T, dP = dO V^T and their
// transposes)
template <int HD, int NJ>
DEV void mma_rows(float (&acc)[NJ][4], const float* tile, const float* rows, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc) {
    const AFrag a = a_from_tile<kLd<HD>>(tile, kc * 8, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* r = rows + (j * 8 + g) * kLd<HD> + kc * 8;
      mma3(acc[j], a, r[t], r[t + 4]);
    }
  }
}

// acc[j] (16 x 8 at head columns 8j, j < HD / 8) += P (16 x 8 NK, from the
// accumulators p) times `rows` (8 NK rows x HD): products that reduce over
// keys or queries (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K). The
// tensor cores' f32 sums truncate where they align the products to the
// accumulator, so a sum carried across every tile of a long row (25 tiles
// of 8 k-steps at N = 1600) drifts by about an ulp of the running sum each
// step (2e-5 of max|o| at the flagship, B = 64). So each tile's products
// sum into fresh registers, kHdPart columns at a time, which are added to
// acc with f32 adds that round to nearest.
constexpr int kHdPart = 32;
template <int HD, int NK>
DEV void mma_paired(float (&acc)[HD / 8][4], const float (&p)[NK][4], const float* rows, int g,
                    int t) {
  constexpr int NJ = kHdPart / 8;
#pragma unroll
  for (int part = 0; part < HD / kHdPart; ++part) {
    float tile[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) tile[jj][0] = tile[jj][1] = tile[jj][2] = tile[jj][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const AFrag a = a_from_acc(p[kc]);
      const float* r = rows + (kc * 8 + 2 * t) * kLd<HD> + part * kHdPart + g;  // keys 2t, 2t + 1
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) mma3(tile[jj], a, r[jj * 8], r[jj * 8 + kLd<HD>]);
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[part * NJ + jj][e] += tile[jj][e];
  }
}

// The key-parallel pass: dk and dv of 64 keys of one head. Grid (N / 64,
// heads, B). K and V resident; (Q, dO) tiles of kTile<HD> queries and their
// lse and di rows streamed over every query row (padded ones too, as the
// plain version sums them). dk and dv go to grads (B, N, 3D) at columns D
// and 2D.
template <int HD>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<HD>)
    flash_f32_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        long long sq, long long sk, long long sv, const float* __restrict__ lse,
                        const float* __restrict__ di, float* __restrict__ grads, int n,
                        int n_valid, float scale_log2, float sm_scale) {
  constexpr int QT = kTile<HD>, LD = kLd<HD>;
  constexpr int kStage = 2 * kTileFloats<HD> + 2 * QT;  // Q, dO, lse, di
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kBlockFloats<HD>;
  float* ring = sV + kBlockFloats<HD>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const long long d = (long long)heads * HD;
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  float* dka = grads + ((long long)b * n + key_a) * 3 * d + d + h * HD + 2 * t;
  float* dkb = dka + 8 * 3 * d;

  if (k0 >= n_valid) {  // every key of the block masked: dk = dv = 0
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float2 z = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dka + j * 8) = z;
      *reinterpret_cast<float2*>(dkb + j * 8) = z;
      *reinterpret_cast<float2*>(dka + d + j * 8) = z;
      *reinterpret_cast<float2*>(dkb + d + j * 8) = z;
    }
    return;
  }
  const float* qb = q + (long long)b * n * sq + h * HD;
  const float* dob = dO + (long long)b * n * d + h * HD;
  const float* lb = lse + ((long long)b * heads + h) * n;
  const float* dib = di + ((long long)b * heads + h) * n;
  const int n_qt = n / QT;

  load_rows<HD, kRows>(sK, k + (long long)b * n * sk + h * HD + (long long)k0 * sk, sk, tid);
  load_rows<HD, kRows>(sV, v + (long long)b * n * sv + h * HD + (long long)k0 * sv, sv, tid);
  auto load_stage = [&](int qt) {
    float* st = ring + (qt & 1) * kStage;
    load_rows<HD, QT>(st, qb + (long long)qt * QT * sq, sq, tid);
    load_rows<HD, QT>(st + kTileFloats<HD>, dob + (long long)qt * QT * d, d, tid);
    load_vec(st + 2 * kTileFloats<HD>, lb + qt * QT, QT, tid);
    load_vec(st + 2 * kTileFloats<HD> + QT, dib + qt * QT, QT, tid);
  };
  load_stage(0);
  cp_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const bool valid_a = key_a < n_valid, valid_b = key_b < n_valid;
  const float* sKw = sK + warp * 16 * LD;
  const float* sVw = sV + warp * 16 * LD;

  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) load_stage(qt + 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const float* sQ = ring + (qt & 1) * kStage;
    const float* sdO = sQ + kTileFloats<HD>;
    const float* sl = sdO + kTileFloats<HD>;
    const float* sdi = sl + QT;

    // S^T = K Q^T and dP^T = V dO^T (16 keys x QT queries)
    float s[QT / 8][4], dp[QT / 8][4];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows<HD, QT / 8>(s, sKw, sQ, g, t);
    mma_rows<HD, QT / 8>(dp, sVw, sdO, g, t);
    // P^T = exp2(S^T scale log2e - lse log2e) (0 on masked keys), dS^T = P^T
    // (dP^T - di) scale
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const bool valid = e < 2 ? valid_a : valid_b;
        const float p = valid ? fw::ex2(fmaf(s[j][e], scale_log2, -sl[c] * fw::kLog2e)) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sdi[c]) * sm_scale;
      }
    mma_paired<HD, QT / 8>(dv, s, sdO, g, t);
    mma_paired<HD, QT / 8>(dk, dp, sQ, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const float2 ka = valid_a ? make_float2(dk[j][0], dk[j][1]) : make_float2(0.f, 0.f);
    const float2 kb2 = valid_b ? make_float2(dk[j][2], dk[j][3]) : make_float2(0.f, 0.f);
    const float2 va = valid_a ? make_float2(dv[j][0], dv[j][1]) : make_float2(0.f, 0.f);
    const float2 vb2 = valid_b ? make_float2(dv[j][2], dv[j][3]) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(dka + j * 8) = ka;
    *reinterpret_cast<float2*>(dkb + j * 8) = kb2;
    *reinterpret_cast<float2*>(dka + d + j * 8) = va;
    *reinterpret_cast<float2*>(dkb + d + j * 8) = vb2;
  }
}

// The query-parallel pass: dq of 64 query rows of one head. Grid (N / 64,
// heads, B). Q and dO resident, (K, V) tiles below n_valid streamed; dq goes
// to grads (B, N, 3D) at column 0.
template <int HD>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<HD>)
    flash_f32_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dO, long long sq,
                       long long sk, long long sv, const float* __restrict__ lse,
                       const float* __restrict__ di, float* __restrict__ grads, int n,
                       int n_valid, float scale_log2, float sm_scale) {
  constexpr int KT = kTile<HD>, LD = kLd<HD>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kBlockFloats<HD>;
  float* ring = sdO + kBlockFloats<HD>;  // stage s: K at 2s, V at 2s + 1 tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const long long d = (long long)heads * HD;
  const float* kb = k + (long long)b * n * sk + h * HD;
  const float* vb = v + (long long)b * n * sv + h * HD;
  const int n_kt = (n_valid + KT - 1) / KT;

  load_rows<HD, kRows>(sQ, q + (long long)b * n * sq + h * HD + (long long)q0 * sq, sq, tid);
  load_rows<HD, kRows>(sdO, dO + ((long long)b * n + q0) * d + h * HD, d, tid);
  load_rows<HD, KT>(ring, kb, sk, tid);
  load_rows<HD, KT>(ring + kTileFloats<HD>, vb, sv, tid);
  cp_commit();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const long long stat = ((long long)b * heads + h) * n;
  const float l2_a = lse[stat + row_a] * fw::kLog2e, l2_b = lse[stat + row_b] * fw::kLog2e;
  const float di_a = di[stat + row_a], di_b = di[stat + row_b];
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  const float* sQw = sQ + warp * 16 * LD;
  const float* sdOw = sdO + warp * 16 * LD;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      float* st = ring + ((kt + 1) & 1) * 2 * kTileFloats<HD>;
      load_rows<HD, KT>(st, kb + (long long)(kt + 1) * KT * sk, sk, tid);
      load_rows<HD, KT>(st + kTileFloats<HD>, vb + (long long)(kt + 1) * KT * sv, sv, tid);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const float* sK = ring + (kt & 1) * 2 * kTileFloats<HD>;
    const float* sV = sK + kTileFloats<HD>;

    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows<HD, KT / 8>(s, sQw, sK, g, t);
    mma_rows<HD, KT / 8>(dp, sdOw, sV, g, t);
    const int key0 = kt * KT;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool rb = e >= 2;
        const bool valid = key0 + j * 8 + 2 * t + (e & 1) < n_valid;
        const float p =
            valid ? fw::ex2(fmaf(s[j][e], scale_log2, rb ? -l2_b : -l2_a)) : 0.f;
        dp[j][e] = p * (dp[j][e] - (rb ? di_b : di_a)) * sm_scale;
      }
    mma_paired<HD, KT / 8>(dq, dp, sK, g, t);
    __syncthreads();
  }

  float* qa = grads + ((long long)b * n + row_a) * 3 * d + h * HD + 2 * t;
  float* qb2 = qa + 8 * 3 * d;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<float2*>(qa + j * 8) = make_float2(dq[j][0], dq[j][1]);
    *reinterpret_cast<float2*>(qb2 + j * 8) = make_float2(dq[j][2], dq[j][3]);
  }
}

}  // namespace legacy

// The backward: di, then the dk/dv and dq passes, on `st`. o and dO
// contiguous (B, N, heads * HD); di (B, heads, N) scratch; grads (B, N,
// 3 * heads * HD) contiguous, written as [dq | dk | dv]. At head width 64
// the passes read q, k, v and dO through `maps`; at 128 the legacy passes
// read them as pointers (rows `s*` floats apart).
template <int HD>
cudaError_t launch_bwd(const RawMaps* maps, const float* q, const float* k, const float* v,
                       const float* o, const float* dO, long long sq, long long sk, long long sv,
                       const float* lse, float* di, float* grads, int batch, int n, int heads,
                       int n_valid, float sm_scale, cudaStream_t st) {
  cudaError_t err;
  const float scale_log2 = sm_scale * fw::kLog2e;
  if constexpr (HD == 64) {
    if ((err = cudaFuncSetAttribute(kv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kKvSmem<HD>)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(q_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kQSmem<HD>)) != cudaSuccess)
      return err;
  } else {
    if ((err = cudaFuncSetAttribute(legacy::flash_f32_kv_kernel<HD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    legacy::kBwdSmem<HD>)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(legacy::flash_f32_q_kernel<HD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    legacy::kBwdSmem<HD>)) != cudaSuccess)
      return err;
  }
  di_kernel<HD><<<(unsigned)((long long)batch * n / 8), 256, 0, st>>>(o, dO, di, n, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (HD == 64) {
    const dim3 grid((n + kBlockRows - 1) / kBlockRows, heads, batch);
    kv_kernel<HD><<<grid, kBlockThreads, kKvSmem<HD>, st>>>(*maps, lse, di, grads, n, n_valid,
                                                         scale_log2, sm_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    q_kernel<HD><<<grid, kBlockThreads, kQSmem<HD>, st>>>(*maps, lse, di, grads, n, n_valid,
                                                       scale_log2, sm_scale);
  } else {
    const dim3 grid(n / kRows, heads, batch);
    legacy::flash_f32_kv_kernel<HD><<<grid, legacy::kThreads, legacy::kBwdSmem<HD>, st>>>(
        q, k, v, dO, sq, sk, sv, lse, di, grads, n, n_valid, scale_log2, sm_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    legacy::flash_f32_q_kernel<HD><<<grid, legacy::kThreads, legacy::kBwdSmem<HD>, st>>>(
        q, k, v, dO, sq, sk, sv, lse, di, grads, n, n_valid, scale_log2, sm_scale);
  }
  return cudaGetLastError();
}

}  // namespace f32a

// ---- host: rank-3 f32 TMA descriptors ---------------------------------------------

// An (imgs, rows, cols) f32 tensor whose rows are `row_stride` floats apart
// (>= cols, a multiple of 4; images rows * row_stride apart), read in boxes
// of box_rows x 32 columns of one image, 128-byte swizzle, zero fill past
// the ends.
inline cudaError_t tensor_map3_f32(CUtensorMap* map, const void* ptr, int imgs, int rows,
                                   int cols, int box_rows, long long row_stride) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)imgs};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 4, (cuuint64_t)rows * row_stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)f32a::kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dcvit
