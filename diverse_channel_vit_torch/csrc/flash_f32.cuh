// The f32 kernels of masked multi-head attention with no projection: the
// forward (flash_packed.cu's `dcvit_flash_packed_fwd_f32`, B5 in f32) and
// the backward's three passes (flash_packed_bwd.cu's
// `dcvit_flash_packed_bwd_f32`, B6 in f32), head width HD 64 or 128.
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
// is 3xTF32: each operand x splits into hi = tf32(x) and lo = tf32(x - hi),
// and a product accumulates a_hi b_lo + a_lo b_hi + a_hi b_hi in f32 (the
// lo x lo term, 2^-22 of the product, is dropped), which keeps about 21 of
// f32's 24 bits. That is three TF32 passes, so at best a third of the 494.7
// TFLOP/s dense TF32 rate; f32 FMA on the CUDA cores would have 67 TFLOP/s
// at most. At the DiChaViT-S flagship (B = 64, 6 heads of 64, n_valid =
// 1569) the forward's 4 B n_valid^2 D = 242 GFLOP are 0.49 ms at one TF32
// pass and 1.47 ms at three; its f32 traffic (q, k, v read once, o written
// once) 617 MB, 0.18 ms at 3.35 TB/s.
//
// Design: `mma.sync.m16n8k8.tf32` (a warp's 16 x 8 tile, 8 deep), fragments
// loaded from shared memory by hand. `wgmma` takes .tf32 operands from
// shared memory only K-major, so four of the seven products (P V, P^T dO,
// dS^T Q, dS K) would need transposed copies of their tiles; with
// `mma.sync` every operand is read from a row-major tile in the order the
// product wants. Tiles arrive by `cp.async` (16 bytes a thread, coalesced
// rows) into a two-stage ring; rows are padded to HD + 4 floats, so every
// fragment load of the three access patterns below is free of bank
// conflicts. A block is 4 warps, each owning 16 rows of the block's 64.
// - P and dS go from one product's accumulator to the next product's A
//   operand in registers: an accumulator holds columns (2t, 2t+1) of rows
//   (g, g+8) (g = lane / 4, t = lane % 4), the A operand columns (t, t+4).
//   The key order inside an 8-key step is free in a sum over keys, so A's
//   column t is taken as key 2t and t+4 as key 2t+1, and the B operand
//   (V, dO, Q or K) is read at those rows: no shuffle.
// - The forward is FlashAttention-2's: Q resident, (K, V) tiles streamed,
//   an online softmax in the log2 domain (the scale folded into one `ex2`
//   per score), O divided by the row sum once at the end; it writes each
//   row's log-sum-exp, which the backward reads (its own, f32).
// - The backward is three passes, every sum in a fixed order and none
//   through atomics (two calls on the same inputs agree bit for bit): di =
//   rowsum(o do) per head; the key-parallel dk/dv pass (K, V resident, (Q,
//   dO, lse, di) streamed; S^T and dP^T recomputed, P^T = exp2(S^T scale
//   log2e - lse log2e)); the query-parallel dq pass (Q, dO resident, (K, V)
//   streamed). Keys at or past `n_valid` get P = 0, and their dk and dv rows
//   are written as exact zeros.
// - Tiles of 64 keys (or queries) at head width 64 and 32 at 128 keep two
//   blocks an SM in the forward (85 and 99 KiB); the backward's passes keep
//   two at head width 64 and one at 128 (133 KiB: two 64-row resident tiles
//   and the ring).
#pragma once

#include "flash_wgmma.cuh"

namespace dcvit {
namespace f32a {

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
constexpr int kFwdBlocks = 2;
template <int HD>
constexpr int kBwdBlocks = HD == 64 ? 2 : 1;

// shared memory: the forward's Q and its (K, V) ring; the backward's two
// resident 64-row tiles and its ring of two streamed tiles, plus the dk/dv
// pass's lse and di rows
template <int HD>
constexpr int kFwdSmem = (kBlockFloats<HD> + 2 * 2 * kTileFloats<HD>) * 4;
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

// ---- the forward --------------------------------------------------------------

// Grid (N / 64, heads, B), 128 threads. q, k, v: rows `s*` floats apart,
// images N rows apart; o (B, N, heads * HD) contiguous; lse (B, heads, N) or
// null.
template <int HD>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
    flash_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, long long sq, long long sk, long long sv,
                         float* __restrict__ o, float* __restrict__ lse, int n, int n_valid,
                         float scale_log2) {
  constexpr int KT = kTile<HD>, LD = kLd<HD>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* ring = sQ + kBlockFloats<HD>;  // stage s: K at 2s, V at 2s + 1 tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const float* qb = q + (long long)b * n * sq + h * HD;
  const float* kb = k + (long long)b * n * sk + h * HD;
  const float* vb = v + (long long)b * n * sv + h * HD;
  const int n_kt = (n_valid + KT - 1) / KT;

  load_rows<HD, kRows>(sQ, qb + (long long)q0 * sq, sq, tid);
  load_rows<HD, KT>(ring, kb, sk, tid);
  load_rows<HD, KT>(ring + kTileFloats<HD>, vb, sv, tid);
  cp_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g + 8
  const float* sQw = sQ + warp * 16 * LD;

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

    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_rows<HD, KT / 8>(s, sQw, sK, g, t);

    // keys at or past n_valid: -inf, so P = 0
    const int key0 = kt * KT;
    if (key0 + KT > n_valid) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * t + (e & 1) >= n_valid) s[j][e] = -INFINITY;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
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
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = fw::ex2(fmaf(s[j][0], scale_log2, -m_a));
      s[j][1] = fw::ex2(fmaf(s[j][1], scale_log2, -m_a));
      s[j][2] = fw::ex2(fmaf(s[j][2], scale_log2, -m_b));
      s[j][3] = fw::ex2(fmaf(s[j][3], scale_log2, -m_b));
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + rs_a;  // this thread's columns; summed over the quad at the end
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= alpha_a;
      acc[j][1] *= alpha_a;
      acc[j][2] *= alpha_b;
      acc[j][3] *= alpha_b;
    }
    mma_paired<HD, KT / 8>(acc, s, sV, g, t);
    __syncthreads();  // the stage is read; the next iteration's loads may refill it
  }

  l_a = sum_over_quad(l_a);
  l_b = sum_over_quad(l_b);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const long long d = (long long)heads * HD;
  float* oa = o + ((long long)b * n + row_a) * d + h * HD + 2 * t;
  float* ob = oa + 8 * d;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<float2*>(oa + j * 8) = make_float2(acc[j][0] * inv_a, acc[j][1] * inv_a);
    *reinterpret_cast<float2*>(ob + j * 8) = make_float2(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + ((long long)b * heads + h) * n;
    lrow[row_a] = (m_a + log2f(l_a)) * fw::kLn2;
    lrow[row_b] = (m_b + log2f(l_b)) * fw::kLn2;
  }
}

template <int HD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, long long sq, long long sk,
                       long long sv, float* o, float* lse, int batch, int n, int heads,
                       int n_valid, float sm_scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_f32_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFwdSmem<HD>);
  if (err != cudaSuccess) return err;
  flash_f32_fwd_kernel<HD><<<dim3(n / kRows, heads, batch), kThreads, kFwdSmem<HD>, st>>>(
      q, k, v, sq, sk, sv, o, lse, n, n_valid, sm_scale * fw::kLog2e);
  return cudaGetLastError();
}

// ---- the backward -------------------------------------------------------------

// di[b, h, r] = sum over the head's columns of o * do, f32: one warp a row,
// HD / 32 columns of each head a lane. Grid (B * N / 8), 256 threads.
template <int HD>
__global__ void __launch_bounds__(256)
    flash_f32_di_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                        float* __restrict__ di, int n, int heads) {
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

// The backward: di, then the dk/dv and dq passes, on `st`. o and dO
// contiguous (B, N, heads * HD); di (B, heads, N) scratch; grads (B, N,
// 3 * heads * HD) contiguous, written as [dq | dk | dv].
template <int HD>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dO, long long sq, long long sk, long long sv,
                       const float* lse, float* di, float* grads, int batch, int n, int heads,
                       int n_valid, float sm_scale, cudaStream_t st) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_f32_kv_kernel<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBwdSmem<HD>)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_f32_q_kernel<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBwdSmem<HD>)) != cudaSuccess)
    return err;
  flash_f32_di_kernel<HD><<<(unsigned)((long long)batch * n / 8), 256, 0, st>>>(o, dO, di, n,
                                                                               heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const float scale_log2 = sm_scale * fw::kLog2e;
  const dim3 grid(n / kRows, heads, batch);
  flash_f32_kv_kernel<HD><<<grid, kThreads, kBwdSmem<HD>, st>>>(
      q, k, v, dO, sq, sk, sv, lse, di, grads, n, n_valid, scale_log2, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_f32_q_kernel<HD><<<grid, kThreads, kBwdSmem<HD>, st>>>(
      q, k, v, dO, sq, sk, sv, lse, di, grads, n, n_valid, scale_log2, sm_scale);
  return cudaGetLastError();
}

}  // namespace f32a
}  // namespace dcvit
