// flash_packed backward: given do, the gradients dq, dk and dv of the
// forward in flash_packed.cu.
//
// Replaces the TPU kernel `_packed_bwd_kernel`
// (diverse_channel_vit_tpu/ops/attention.py:297), reached through
// `_packed_bwd_impl` (:358) and `_flash_packed_vjp_bwd` (:418).
//
// What bounds it on an H100: operations, of two kinds. The TPU kernel's
// `CostEstimate` (:398-402) counts 10 * B * N^2 * D FLOP, 2.5 times the
// forward's; over the real keys that is 605 GFLOP at the DiChaViT-S
// flagship (B = 64, n_valid = 1569, D = 384), 0.612 ms at 989 TFLOP/s; and,
// with P recomputed in each of the two attention passes below, 1.9e9
// exponentials, about 0.48 ms at the special-function units' ~3.9 T exp2/s;
// against 617 MB of compulsory traffic (q, k, v, o, do read once, dq, dk, dv
// written once; the lse read is 2.4 MB), 0.18 ms at 3.35 TB/s.
//
// Design (flash_packed.cuh on flash_wgmma.cuh and wgmma_core.cuh): the
// attend_project backward's (B2's) two attention passes, without its
// projection and bias sums; the benchmark scripts' attention backward (S1)
// runs the same three passes after a statistics pass of its own.
// - The TPU ran grid (b, q-block) with the whole K/V row resident in VMEM
//   and accumulated dk and dv in f32 VMEM scratch across a sequential q axis
//   (:304-356), recomputing the softmax's max and sum. Here K+V of one head
//   (400 KB at N = 1600) does not fit a block's shared memory, and blocks run
//   in no order, so the work splits FlashAttention-2 style into three
//   passes, every reduction in a fixed order and none through atomics (two
//   calls on the same inputs agree bit for bit):
//   (a) `flash_bwd_di_kernel`, row-parallel: di = rowsum(o_h * do_h) per
//       head, in f32 (o and do read once, about 0.16 GB at the flagship);
//   (b) `flash_bwd_kv_kernel<false>`, one block per (64 keys, head, image),
//       K and V resident, the (Q, dO, lse, di) tiles of 64 queries streamed
//       by TMA through a three-stage ring: S^T = K Q^T and dP^T = V dO^T on
//       `wgmma` from shared memory, P^T = exp2(S^T scale log2e - lse log2e)
//       from the forward's log-sum-exp in place of the recomputed max and
//       sum (the same P up to f32 rounding), dS^T = P^T (dP^T - di) * scale,
//       then dV += P^T dO and dK += dS^T Q with P^T and dS^T packed to bf16
//       as the register A operands; dk and dv stay in f32 registers and leave
//       once, by TMA;
//   (c) `flash_bwd_q_kernel<false>`, one block per (64 queries, head,
//       image), Q and dO resident, the (K, V) tiles below `n_valid`
//       streamed: S and dP recomputed, dQ += dS K issued with the next
//       tile's S and dP.
//   (b) and (c) run three blocks of one warpgroup on each SM, thread 0
//   issuing the loads, so one block's exponentials run while another's
//   products do.
// - Keys at or past `n_valid` get P = 0 exactly, so their dk and dv rows come
//   out exactly 0 (key tiles wholly past `n_valid` are written as zeros):
//   the qkv GEMM's weight gradient sums over every row, padded ones too.
// - P and dS are rounded to bf16 before their products, as on the TPU; all
//   accumulators are f32. q, k and v come as strided views, each through a
//   rank-3 TMA map with its own row stride; dq, dk and dv leave by TMA into
//   one (B, N, 3D) buffer, [dq | dk | dv], the layout the qkv GEMM's
//   backward reads.
// - In f32 (`dcvit_flash_packed_bwd_f32`) the passes are flash_f32.cuh's:
//   the same three, on 3xTF32 `wgmma` products with P and dS in f32 (at
//   head width 128 its first port's `mma.sync` passes), into an f32
//   [dq | dk | dv] buffer, the passes splitting q, k, v and do into tf32
//   hi / lo in shared memory; bound and design there.
#include "flash_f32.cuh"
#include "flash_packed.cuh"

// Plain C entry point (loaded with ctypes). head_dim 64 or 128. q, k, v:
// (B, N, H * head_dim)
// bf16 views whose rows are contiguous and 16-byte aligned, rows `stride_*`
// elements apart (a multiple of 8) and images N rows apart; o and dout
// (B, N, H * head_dim) bf16 contiguous; lse and di (B, H, N) f32 contiguous
// (di is scratch); grads (B, N, 3 * H * head_dim) bf16 contiguous, written
// as [dq | dk | dv]. Returns a cudaError_t: the first failed launch's (or TMA
// descriptor's), or cudaErrorInvalidValue for a shape the kernels do not
// take.
extern "C" int dcvit_flash_packed_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* grads, void* di,
                                      int batch, int n, int heads, int head_dim,
                                      long long stride_q, long long stride_k, long long stride_v,
                                      int n_valid, float sm_scale, void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  const long long d = (long long)heads * head_dim;
  if (!fw::head_width_built(head_dim) || n % fw::kWgRows != 0 || n_valid < 1 || n_valid > n || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535 || stride_q < d || stride_k < d ||
      stride_v < d || (stride_q | stride_k | stride_v) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dc = (int)d;
  CUtensorMap q_map, k_map, v_map, do_map, grads_map;
  cudaError_t err;
  if ((err = tensor_map3(&q_map, q, batch, n, dc, fw::kWgRows, stride_q)) != cudaSuccess ||
      (err = tensor_map3(&k_map, k, batch, n, dc, fw::kWgRows, stride_k)) != cudaSuccess ||
      (err = tensor_map3(&v_map, v, batch, n, dc, fw::kWgRows, stride_v)) != cudaSuccess ||
      (err = tensor_map3(&do_map, dout, batch, n, dc, fw::kWgRows, d)) != cudaSuccess ||
      (err = tensor_map3(&grads_map, grads, batch, n, 3 * dc, fw::kWgRows, 3 * d)) !=
          cudaSuccess)
    return (int)err;
  // q, k and v: maps of their own, each head's columns from 0
  auto run = head_dim == 64 ? launch_flash_bwd<64, 1> : launch_flash_bwd<128, 1>;
  return (int)run(q_map, k_map, v_map, do_map, grads_map, 0, 0, 0, static_cast<const bf16*>(o),
                  static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                  static_cast<float*>(di), static_cast<bf16*>(grads), batch, n, heads, n_valid,
                  sm_scale, st);
}

// The f32 backward (flash_f32.cuh): the arguments of dcvit_flash_packed_bwd,
// every tensor f32, row strides a multiple of 4 (16 bytes); grads (B, N,
// 3 * H * head_dim) f32.
extern "C" int dcvit_flash_packed_bwd_f32(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* grads, void* di, int batch, int n, int heads,
                                          int head_dim, long long stride_q, long long stride_k,
                                          long long stride_v, int n_valid, float sm_scale,
                                          void* stream) {
  using namespace dcvit;
  const long long d = (long long)heads * head_dim;
  if (!fw::head_width_built(head_dim) || n % f32a::kRows != 0 || n_valid < 1 || n_valid > n ||
      batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || stride_q < d ||
      stride_k < d || stride_v < d || (stride_q | stride_k | stride_v) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (head_dim == 128)
    return (int)f32a::launch_bwd<128>(nullptr, f(q), f(k), f(v), f(o), f(dout), stride_q,
                                      stride_k, stride_v, f(lse), static_cast<float*>(di),
                                      static_cast<float*>(grads), batch, n, heads, n_valid,
                                      sm_scale, st);
  const int dc = (int)d;
  f32a::RawMaps maps{};
  cudaError_t err;
  if ((err = tensor_map3_f32(&maps.q, q, batch, n, dc, f32a::kT, stride_q)) != cudaSuccess ||
      (err = tensor_map3_f32(&maps.k, k, batch, n, dc, f32a::kT, stride_k)) != cudaSuccess ||
      (err = tensor_map3_f32(&maps.v, v, batch, n, dc, f32a::kT, stride_v)) != cudaSuccess ||
      (err = tensor_map3_f32(&maps.dO, dout, batch, n, dc, f32a::kT, d)) != cudaSuccess)
    return (int)err;
  return (int)f32a::launch_bwd<64>(&maps, f(q), f(k), f(v), f(o), f(dout), stride_q, stride_k,
                                   stride_v, f(lse), static_cast<float*>(di),
                                   static_cast<float*>(grads), batch, n, heads, n_valid,
                                   sm_scale, st);
}

// The f32 backward passes' dynamic shared memory a block, for reports (ptxas
// prints static shared memory only): the dk/dv and dq passes at head width
// 64, then the legacy passes at 128.
extern "C" void dcvit_flash_f32_smem_bwd(int* out, int n) {
  using namespace dcvit::f32a;
  const int sizes[] = {kKvSmem<64>, kQSmem<64>, legacy::kBwdSmem<128>, legacy::kBwdSmem<128>};
  for (int i = 0; i < n && i < 4; ++i) out[i] = sizes[i];
}
