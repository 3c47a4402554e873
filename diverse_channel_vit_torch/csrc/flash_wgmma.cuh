// The Hopper flash-attention core of the attend_project kernels
// (attend_project.cu, B1; attend_project_bwd.cu, B2), on top of
// wgmma_core.cuh's mbarrier ring, TMA and `wgmma` helpers.
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
//   operands brought into shared memory by TMA: head slices of the packed
//   (B, N, 3D) qkv and of (B, N, D) tensors through rank-3 tensor maps
//   (columns, rows, images), so a row box never runs into the next image and
//   TMA's zero fill and clipped stores take the ragged last tile;
// - P and dS go from the f32 accumulator of one product into the A operand
//   of the next as packed bf16 registers (`wgmma` with A from registers):
//   the accumulator layout of an m64nN product is the A-fragment layout of
//   an m64k16 one, so no tile goes through shared memory on the way;
// - the exponentials of one warpgroup run while another's products do: each
//   block is one consumer warpgroup of 64 rows, and several blocks share an
//   SM: B1's (with a producer warp, 160 threads) two, B2's attention passes'
//   (thread 0 issuing the loads, 128 threads) three. On an H100 that beat
//   blocks of two consumer warpgroups that take turns issuing their products
//   (FlashAttention-3's ping-pong, named barriers, one block an SM), in the
//   forward and in the backward, where dropping the producer warp for a
//   third block an SM gained more. (ptxas holds consumer code to 168 registers a thread in every
//   one of these shapes, `setmaxnreg` notwithstanding, so none can hold a
//   deeper pipeline in the dk/dv pass.) The forward and the backward's dq
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
#pragma once

#include "wgmma_core.cuh"

namespace dcvit {
namespace fw {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kHd = 64;               // head width (the one built)
constexpr int kWgRows = 64;           // rows of one warpgroup's tile
constexpr int kHalfBox = kWgRows * 128;  // bytes of a warpgroup's 64 rows in a box

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

// Store a warpgroup's 64 x 64 f32 accumulator, rounded to bf16, into its 64
// rows of a swizzled box (`box` at those rows).
DEV void store_tile(uint8_t* box, const float (&c)[32], int t) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) wg::st_pair(box, wg::acc_row(t, i), wg::acc_col(t, i), c[i], c[i + 1]);
}

}  // namespace fw

// ---- host: rank-3 TMA descriptors --------------------------------------------------

// A (imgs, rows, cols) row-major bf16 tensor read or written in boxes of
// box_rows x 64 columns of one image, 128-byte swizzle, zero fill past the
// ends (rows past `rows` belong to no image).
inline cudaError_t tensor_map3(CUtensorMap* map, const void* ptr, int imgs, int rows, int cols,
                               int box_rows) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)imgs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)wg::kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dcvit
