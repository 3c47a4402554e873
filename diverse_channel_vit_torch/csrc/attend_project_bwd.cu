// attend_project backward: given dxo, the gradients of the packed qkv
// ([dq | dk | dv]), of the output projection (dWp, dbp) and of the qkv bias,
// for the forward in attend_project.cu.
//
// Replaces the TPU kernel `_ap_bwd_kernel`
// (diverse_channel_vit_tpu/ops/fused_block.py:713), reached through
// `_ap_bwd_impl` (:869) and `_apa_vjp_bwd` (:948).
//
// What bounds it on an H100: operations. Per image and layer at the
// DiChaViT-S flagship (1569 real rows and keys, D = 384, 6 heads of 64) the
// function needs 10 * rows * keys * D + 4 * rows * D^2 = 10.4 GFLOP of bf16
// products against about 11 MB of compulsory traffic.
//
// Design, and what differs from the TPU kernel:
// - The TPU ran grid (b, q-block) with the whole K/V row resident in VMEM and
//   accumulated dk, dv, dWp, dbp and the bias sums in VMEM scratch across a
//   sequential q axis. Here K+V of one head (400 KB at N = 1600) does not fit
//   a block's shared memory, and blocks run in no order. So the work splits
//   FlashAttention-2 style into passes, every reduction in a fixed order and
//   none through atomics:
//   (a) `ap_bwd_pre_kernel`, row-parallel: do = dxo Wp (rounded to bf16, as
//       the TPU rounded it), di = rowsum(o_h * do_h) per head in f32, and the
//       per-block column sums of dxo (dbp);
//   (b) `ap_bwd_kv_kernel`, one block per (64-key tile, head, image), looping
//       over every query tile: S^T = K Q^T, P^T = exp(S^T * scale - lse)
//       (lse from the forward kernel), dV += P^T dO, dS^T = P^T (dP^T - di)
//       * scale, dK += dS^T Q. dk and dv stay in registers and are written
//       once, with their column sums (the k and v bias gradients);
//   (c) `ap_bwd_q_kernel`, one block per (64-query tile, head, image), looping
//       over the valid key tiles: dQ = dS K, recomputing S and dP, and the
//       column sums of the rounded dq (the q bias gradient, as the TPU summed
//       its rounded dq);
//   (d) dWp = dxo^T o over every row, by the split-row GEMM of wgrad.cuh;
//   (e) the per-block bias partials and dWp partials summed in a fixed order.
// - Keys at or past `n_valid` get P = 0 exactly, so their dk and dv rows come
//   out exactly 0: dW_qkv = y^T [dq | dk | dv] sums over all N rows, and a
//   stray value in a padded key row would reach a weight gradient that no
//   output check sees. Key tiles wholly past `n_valid` are written as zeros.
// - P and dS are rounded to bf16 before their products, as on the TPU; all
//   accumulators are f32. bf16 `mma.sync.m16n8k16` with `cp.async` tiles, as
//   in the forward; each warp owns 16 rows (keys in (b), queries in (c)), so
//   the products' fragments never leave registers between steps.
#include "wgrad.cuh"

namespace dcvit {

constexpr int kBRows = 64;      // rows (queries or keys) per tile
constexpr int kBThreads = 128;  // four warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pre_smem_bytes(int d_out) {
  return 2 * (kBRows * padded(d_out) + 2 * kBRows * padded(64));
}
template <int DH>
__host__ __device__ constexpr int kv_smem_bytes() {
  return 2 * 6 * kBRows * padded(DH) + 4 * (2 * 2 * kBRows + 4 * 2 * DH);
}
template <int DH>
__host__ __device__ constexpr int q_smem_bytes() {
  return 2 * 6 * kBRows * padded(DH) + 4 * 4 * DH;
}

// (a) do = dxo Wp, di, dbp partials. Grid (N / 64, B).
template <int DH>
__global__ void __launch_bounds__(kBThreads)
    ap_bwd_pre_kernel(const __nv_bfloat16* __restrict__ dxo, const __nv_bfloat16* __restrict__ wp,
                      const __nv_bfloat16* __restrict__ o, __nv_bfloat16* __restrict__ do_out,
                      float* __restrict__ di, float* __restrict__ bias_part, int n, int heads,
                      int d_out, int bias_stride) {
  static_assert(DH == 64, "one 64-column chunk of do is one head");
  const int d = heads * DH;
  const int t = blockIdx.x, b = blockIdx.y, q0 = t * kBRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = warp * 16 + g, row_b = row_a + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SX = padded(d_out);
  constexpr int SW = padded(64);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sW = sX + kBRows * SX;

  const long long row0 = (long long)b * n + q0;
  load_tile_async(sX, dxo + row0 * d_out, kBRows, d_out, d_out, tid, kBThreads);
  cp_async_commit();

  const int n_kc = d_out / 64;
  for (int h = 0; h < heads; ++h) {
    const int n0 = h * DH;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // Wp rows [k0, k0 + 64) x columns [n0, n0 + 64), stored [k][n]
    load_tile_async(sW, wp + n0, 64, 64, d, tid, kBThreads);
    cp_async_commit();
    for (int kc = 0; kc < n_kc; ++kc) {
      const int buf = kc & 1;
      if (kc + 1 < n_kc) {
        load_tile_async(sW + (buf ^ 1) * 64 * SW, wp + (long long)(kc + 1) * 64 * d + n0, 64, 64,
                        d, tid, kBThreads);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* w_t = sW + buf * 64 * SW;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        load_a_frag(a, sX, SX, warp * 16, kc * 64 + kk * 16, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          load_b_frag_kn(bfr, w_t, SW, np * 16, kk * 16, lane);
          mma_bf16(acc[2 * np], a, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }
      __syncthreads();
    }
    // round do to bf16; di = sum over the head's columns of o * do (f32)
    float di_a = 0.f, di_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + j * 8 + t4 * 2;
      const long long ga = (row0 + row_a) * d + col, gb = (row0 + row_b) * d + col;
      const uint32_t va = pack_bf16(acc[j][0], acc[j][1]);
      const uint32_t vb = pack_bf16(acc[j][2], acc[j][3]);
      *reinterpret_cast<uint32_t*>(do_out + ga) = va;
      *reinterpret_cast<uint32_t*>(do_out + gb) = vb;
      const float2 fa = unpack_bf16(va), fb = unpack_bf16(vb);
      const float2 oa = unpack_bf16(*reinterpret_cast<const uint32_t*>(o + ga));
      const float2 ob = unpack_bf16(*reinterpret_cast<const uint32_t*>(o + gb));
      di_a += fa.x * oa.x + fa.y * oa.y;
      di_b += fb.x * ob.x + fb.y * ob.y;
    }
    di_a = sum_over_quad(di_a);
    di_b = sum_over_quad(di_b);
    if (t4 == 0) {
      float* drow = di + ((long long)b * heads + h) * n + q0;
      drow[row_a] = di_a;
      drow[row_b] = di_b;
    }
  }
  // dbp partial: column sums of this tile of dxo (sX is visible: every
  // iteration above ended in __syncthreads)
  float* part = bias_part + ((long long)b * gridDim.x + t) * bias_stride;
  for (int c = tid; c < d_out; c += kBThreads) {
    float s = 0.f;
    for (int r = 0; r < kBRows; ++r) s += bf(sX[r * SX + c]);
    part[c] = s;
  }
}

// (b) dk, dv and their column sums. Grid (N / 64, heads, B).
template <int DH>
__global__ void __launch_bounds__(kBThreads)
    ap_bwd_kv_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     __nv_bfloat16* __restrict__ dqkv, float* __restrict__ bias_part, int n,
                     int n_valid, float scale_log2, float sm_scale, int d_out, int bias_stride) {
  const int heads = gridDim.y;
  const int d = heads * DH;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z, k0 = t * kBRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long row3 = 3LL * d;
  const int hc = h * DH;
  const __nv_bfloat16* base = qkv + (long long)b * n * row3;
  __nv_bfloat16* dbase = dqkv + (long long)b * n * row3;
  float* part = bias_part + ((long long)b * gridDim.x + t) * bias_stride + d_out;

  if (k0 >= n_valid) {  // wholly padded key tile: exact zeros
    for (int i = tid; i < kBRows * DH / 2; i += kBThreads) {
      const int r = i / (DH / 2), c = (i - r * (DH / 2)) * 2;
      const long long off = (long long)(k0 + r) * row3 + hc + c;
      *reinterpret_cast<uint32_t*>(dbase + off + d) = 0u;
      *reinterpret_cast<uint32_t*>(dbase + off + 2 * d) = 0u;
    }
    for (int c = tid; c < DH; c += kBThreads) {
      part[d + hc + c] = 0.f;
      part[2 * d + hc + c] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SDH = padded(DH);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBRows * SDH;
  __nv_bfloat16* sQ = sV + kBRows * SDH;       // two stages
  __nv_bfloat16* sDO = sQ + 2 * kBRows * SDH;  // two stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * kBRows * SDH);  // [2][64] lse
  float* sD = sL + 2 * kBRows;                                   // [2][64] di
  float* sRed = sD + 2 * kBRows;                                 // [4 warps][2][DH]

  const float* lrow = lse + ((long long)b * heads + h) * n;
  const float* drow = di + ((long long)b * heads + h) * n;
  auto load_q_tile = [&](int qt, int buf) {
    const long long q0 = (long long)qt * kBRows;
    load_tile_async(sQ + buf * kBRows * SDH, base + q0 * row3 + hc, kBRows, DH, row3, tid,
                    kBThreads);
    load_tile_async(sDO + buf * kBRows * SDH, dO + ((long long)b * n + q0) * d + hc, kBRows, DH,
                    d, tid, kBThreads);
    if (tid < 16) cp_async16(sL + buf * kBRows + tid * 4, lrow + q0 + tid * 4);
    else if (tid < 32) cp_async16(sD + buf * kBRows + (tid - 16) * 4, drow + q0 + (tid - 16) * 4);
    cp_async_commit();
  };

  load_tile_async(sK, base + (long long)k0 * row3 + d + hc, kBRows, DH, row3, tid, kBThreads);
  load_tile_async(sV, base + (long long)k0 * row3 + 2 * d + hc, kBRows, DH, row3, tid, kBThreads);
  load_q_tile(0, 0);

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const bool valid_a = key_a < n_valid, valid_b = key_b < n_valid;

  const int nq = n / kBRows;
  for (int qt = 0; qt < nq; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < nq) {
      load_q_tile(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* q_t = sQ + buf * kBRows * SDH;
    const __nv_bfloat16* do_t = sDO + buf * kBRows * SDH;
    const float* l_t = sL + buf * kBRows;
    const float* d_t = sD + buf * kBRows;

    // S^T = K Q^T: this warp's 16 keys x 64 queries
    float st[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sK, SDH, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, q_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(st[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(st[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    // P^T = exp(S^T * scale - lse[query]); padded keys exactly 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        const bool valid = e < 2 ? valid_a : valid_b;
        st[j][e] = valid ? exp2f(st[j][e] * scale_log2 - l_t[qc] * kLog2e) : 0.f;
      }
    // dV += P^T dO (P rounded to bf16)
    {
      uint32_t pf[4][4];
      acc_to_a_frags(pf, st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bfr[4];
          load_b_frag_kn(bfr, do_t, SDH, np * 16, kk * 16, lane);
          mma_bf16(dv[2 * np], pf[kk], bfr[0], bfr[1]);
          mma_bf16(dv[2 * np + 1], pf[kk], bfr[2], bfr[3]);
        }
    }
    // dP^T = V dO^T
    float dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sV, SDH, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, do_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(dpt[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(dpt[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    // dS^T = P^T (dP^T - di[query]) * scale; dK += dS^T Q (dS rounded to bf16)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t4 * 2 + (e & 1);
        st[j][e] = st[j][e] * (dpt[j][e] - d_t[qc]) * sm_scale;
      }
    {
      uint32_t dsf[4][4];
      acc_to_a_frags(dsf, st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bfr[4];
          load_b_frag_kn(bfr, q_t, SDH, np * 16, kk * 16, lane);
          mma_bf16(dk[2 * np], dsf[kk], bfr[0], bfr[1]);
          mma_bf16(dk[2 * np + 1], dsf[kk], bfr[2], bfr[3]);
        }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  // write dk, dv (bf16); column sums of the f32 accumulators, as the TPU
  // summed its f32 scratch
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = hc + j * 8 + t4 * 2;
    const long long oa = (long long)key_a * row3 + col, ob = (long long)key_b * row3 + col;
    *reinterpret_cast<uint32_t*>(dbase + oa + d) = pack_bf16(dk[j][0], dk[j][1]);
    *reinterpret_cast<uint32_t*>(dbase + ob + d) = pack_bf16(dk[j][2], dk[j][3]);
    *reinterpret_cast<uint32_t*>(dbase + oa + 2 * d) = pack_bf16(dv[j][0], dv[j][1]);
    *reinterpret_cast<uint32_t*>(dbase + ob + 2 * d) = pack_bf16(dv[j][2], dv[j][3]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sk = sum_over_rows(dk[j][e] + dk[j][2 + e]);
      const float sv = sum_over_rows(dv[j][e] + dv[j][2 + e]);
      if (g == 0) {
        sRed[(warp * 2 + 0) * DH + j * 8 + t4 * 2 + e] = sk;
        sRed[(warp * 2 + 1) * DH + j * 8 + t4 * 2 + e] = sv;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * DH; i += kBThreads) {
    const int which = i / DH, c = i - which * DH;  // 0: k, 1: v
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += sRed[(w * 2 + which) * DH + c];
    part[(1 + which) * d + hc + c] = s;
  }
}

// (c) dq and its column sums. Grid (N / 64, heads, B).
template <int DH>
__global__ void __launch_bounds__(kBThreads)
    ap_bwd_q_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dqkv, float* __restrict__ bias_part, int n,
                    int n_valid, float scale_log2, float sm_scale, int d_out, int bias_stride) {
  const int heads = gridDim.y;
  const int d = heads * DH;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = t * kBRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long row3 = 3LL * d;
  const int hc = h * DH;
  const __nv_bfloat16* base = qkv + (long long)b * n * row3;
  const int row_a = warp * 16 + g, row_b = row_a + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SDH = padded(DH);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kBRows * SDH;
  __nv_bfloat16* sK = sDO + kBRows * SDH;  // two stages
  __nv_bfloat16* sV = sK + 2 * kBRows * SDH;
  float* sRed = reinterpret_cast<float*>(sV + 2 * kBRows * SDH);  // [4 warps][DH]

  load_tile_async(sQ, base + (long long)q0 * row3 + hc, kBRows, DH, row3, tid, kBThreads);
  load_tile_async(sDO, dO + ((long long)b * n + q0) * d + hc, kBRows, DH, d, tid, kBThreads);
  load_tile_async(sK, base + d + hc, kBRows, DH, row3, tid, kBThreads);
  load_tile_async(sV, base + 2 * d + hc, kBRows, DH, row3, tid, kBThreads);
  cp_async_commit();

  const long long stat = ((long long)b * heads + h) * n + q0;
  const float l2_a = lse[stat + row_a] * kLog2e, l2_b = lse[stat + row_b] * kLog2e;
  const float di_a = di[stat + row_a], di_b = di[stat + row_b];

  float dq[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  uint32_t qf[DH / 16][4], dof[DH / 16][4];

  const int n_tiles = (n_valid + kBRows - 1) / kBRows;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      const long long off = (long long)(kt + 1) * kBRows * row3 + hc;
      load_tile_async(sK + (buf ^ 1) * kBRows * SDH, base + off + d, kBRows, DH, row3, tid,
                      kBThreads);
      load_tile_async(sV + (buf ^ 1) * kBRows * SDH, base + off + 2 * d, kBRows, DH, row3, tid,
                      kBThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        load_a_frag(qf[kk], sQ, SDH, warp * 16, kk * 16, lane);
        load_a_frag(dof[kk], sDO, SDH, warp * 16, kk * 16, lane);
      }
    }
    const __nv_bfloat16* k_t = sK + buf * kBRows * SDH;
    const __nv_bfloat16* v_t = sV + buf * kBRows * SDH;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        load_b_frag_nk(bfr, k_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
        load_b_frag_nk(bfr, v_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], dof[kk], bfr[0], bfr[1]);
        mma_bf16(dp[2 * np + 1], dof[kk], bfr[2], bfr[3]);
      }
    // dS = P (dP - di) * scale, P = exp(S * scale - lse); padded keys 0
    const int kv0 = kt * kBRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + t4 * 2 + (e & 1);
        const float p = key < n_valid ? exp2f(s[j][e] * scale_log2 - (e < 2 ? l2_a : l2_b)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? di_a : di_b)) * sm_scale;
      }
    // dQ += dS K (dS rounded to bf16)
    uint32_t dsf[4][4];
    acc_to_a_frags(dsf, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bfr[4];
        load_b_frag_kn(bfr, k_t, SDH, np * 16, kk * 16, lane);
        mma_bf16(dq[2 * np], dsf[kk], bfr[0], bfr[1]);
        mma_bf16(dq[2 * np + 1], dsf[kk], bfr[2], bfr[3]);
      }
    __syncthreads();
  }

  // write dq (bf16); column sums of the rounded values
  __nv_bfloat16* drow = dqkv + ((long long)b * n + q0) * row3 + hc;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    const uint32_t va = pack_bf16(dq[j][0], dq[j][1]);
    const uint32_t vb = pack_bf16(dq[j][2], dq[j][3]);
    *reinterpret_cast<uint32_t*>(drow + (long long)row_a * row3 + col) = va;
    *reinterpret_cast<uint32_t*>(drow + (long long)row_b * row3 + col) = vb;
    const float2 fa = unpack_bf16(va), fb = unpack_bf16(vb);
    const float s0 = sum_over_rows(fa.x + fb.x), s1 = sum_over_rows(fa.y + fb.y);
    if (g == 0) {
      sRed[warp * DH + col] = s0;
      sRed[warp * DH + col + 1] = s1;
    }
  }
  __syncthreads();
  float* part = bias_part + ((long long)b * gridDim.x + t) * bias_stride + d_out;
  for (int c = tid; c < DH; c += kBThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += sRed[w * DH + c];
    part[hc + c] = s;
  }
}

}  // namespace dcvit

// Plain C entry point (loaded with ctypes). Shapes: qkv and dqkv (B, N, 3D)
// packed [q | k | v], o and do_buf (B, N, D), dxo (B, N, D_out), all bf16;
// wp (D_out, D) bf16 in nn.Linear layout; lse and di (B, H, N) f32; dwp
// (D_out, D) f32; bias_out (D_out + 3D) f32 = [dbp | dbq | dbk | dbv];
// bias_part (B * N / 64, D_out + 3D) f32 and wgrad_part (splits, D_out, D)
// f32 scratch. All contiguous. Returns a cudaError_t: the first failed
// launch's, or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int dcvit_attend_project_bwd(const void* qkv, const void* o, const void* lse,
                                        const void* wp, const void* dxo, void* dqkv, void* dwp,
                                        void* bias_out, void* do_buf, void* di, void* bias_part,
                                        void* wgrad_part, int batch, int n, int heads,
                                        int head_dim, int d_out, int n_valid, float sm_scale,
                                        int splits, void* stream) {
  using namespace dcvit;
  if (head_dim != 64 || n % kBRows != 0 || d_out % 64 != 0 || n_valid < 1 || n_valid > n ||
      batch < 1 || batch > 65535 || heads < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = heads * 64, tiles = n / kBRows, stride = d_out + 3 * d;
  const float scale_log2 = sm_scale * kLog2e;

  const int pre_smem = pre_smem_bytes(d_out);
  auto pre = ap_bwd_pre_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(pre, cudaFuncAttributeMaxDynamicSharedMemorySize, pre_smem);
  if (err != cudaSuccess) return (int)err;
  pre<<<dim3(tiles, batch), kBThreads, pre_smem, st>>>(
      static_cast<const bf16*>(dxo), static_cast<const bf16*>(wp), static_cast<const bf16*>(o),
      static_cast<bf16*>(do_buf), static_cast<float*>(di), static_cast<float*>(bias_part), n,
      heads, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto kv = ap_bwd_kv_kernel<64>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem_bytes<64>());
  if (err != cudaSuccess) return (int)err;
  kv<<<dim3(tiles, heads, batch), kBThreads, kv_smem_bytes<64>(), st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(do_buf),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dqkv),
      static_cast<float*>(bias_part), n, n_valid, scale_log2, sm_scale, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto qk = ap_bwd_q_kernel<64>;
  err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem_bytes<64>());
  if (err != cudaSuccess) return (int)err;
  qk<<<dim3(tiles, heads, batch), kBThreads, q_smem_bytes<64>(), st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(do_buf),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dqkv),
      static_cast<float*>(bias_part), n, n_valid, scale_log2, sm_scale, d_out, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dWp = dxo^T o over all B * N rows, then the fixed-order sums
  const long long rows = (long long)batch * n;
  err = launch_wgrad(static_cast<const bf16*>(dxo), d_out, static_cast<const bf16*>(o), d,
                     static_cast<float*>(wgrad_part), rows, d_out, d, splits, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce(static_cast<const float*>(wgrad_part), static_cast<float*>(dwp), splits,
                      (long long)d_out * d, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(static_cast<const float*>(bias_part), static_cast<float*>(bias_out),
                            batch * tiles, stride, st);
}
