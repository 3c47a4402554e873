// bench_attn backward: masked multi-head attention backward from q, k, v, o
// and do alone, the softmax statistics recomputed (no log-sum-exp input).
//
// Replaces the TPU kernel `_bwd_kernel` (scripts/bench_attn.py:94), reached
// through `_bwd_call` (:203, call :206), the benchmark of two schedules of
// the attention backward ("pair_staged" and "pair_batched").
//
// Arithmetic, as the TPU kernel's, per head: P = softmax(q k^T * scale) over
// the keys below n_valid (the others masked to -1e30), di = rowsum(o * do),
// dP = do v^T, dS = P (dP - di) * scale, dq = bf16(dS) k, dk = sum over ALL
// N query rows (padded ones too) of bf16(dS)^T q, dv = the same sum of
// bf16(P)^T do; dk and dv accumulate in f32 and are rounded once.
//
// What bounds it on an H100: operations, of two kinds. The TPU kernel's
// `CostEstimate` (:232) counts 10 * B * N^2 * D FLOP; over the real keys that
// is 10 * B * N * n_valid * D = 641 GFLOP at the benchmark's defaults
// (B = 64, N = 1664, n_valid = 1569, D = 384), 0.65 ms at 989 TFLOP/s; the
// exponentials of P, taken once for the statistics and once in each of the
// two gradient passes, are 3 x 1.0e9, about 0.77 ms at the special-function
// units' ~3.9 T exp2/s; against 491 MB of compulsory traffic (five inputs
// read once, three outputs written once), 0.15 ms at 3.35 TB/s.
//
// Design (flash_packed.cuh on the flash core flash_wgmma.cuh; head width 64
// or 128, `--heads 3` at D = 384 being 128), and what differs from the TPU
// kernel:
// - The TPU held one image's whole K and V in VMEM, took each query block's
//   exact row maxima and sums over them, then accumulated dk and dv in f32
//   VMEM scratch across a sequential query-block axis (:197-200). Here one
//   head's K+V at N = 1664 (416 KB) does not fit a block's 227 KB of shared
//   memory, and blocks run in no order, so the work runs in four kernels,
//   with no float atomics:
//   (a) the statistics pass, `flash_packed_fwd_kernel<false>`: the package's
//       flash_packed forward (B5) without P V, one block per (64 query rows,
//       head, image), K tiles alone streamed by TMA; it writes each row's
//       log-sum-exp, the same bits B5's forward writes for the same q and k
//       (the same products, maxima, rescaling and sums, in the same order).
//       P = exp(s - lse) then equals the TPU's exp(s - max) / sum up to f32
//       rounding. This pass is what S1 has and the package's backward (B6,
//       which reads the forward's lse) does not;
//   (b)-(d) B6's three passes (`launch_flash_bwd`): di, then the dk/dv pass
//       (one block per 64 keys, every one of the N / 64 query tiles streamed,
//       padded query rows included) and the dq pass (one block per 64
//       queries, the key tiles below n_valid streamed), on `wgmma` with P and
//       dS from registers. Given the same lse, S1 and B6 agree bit for bit.
// - dq, dk and dv leave by TMA into one (B, N, 3D) buffer, [dq | dk | dv];
//   the wrapper returns its three column views.
// - `variant` is HP, the heads a block of the dk/dv and dq passes carries:
//   "pair_staged" = 1 (one warpgroup, three blocks an SM), "pair_batched" =
//   2 (two warpgroups, one per head, sharing one ring whose stages hold both
//   heads' boxes under one barrier: each stage load serves the head pair;
//   with an odd head count the last pair is one head, as in the TPU
//   kernel's pairing). Each warpgroup runs the same per-head instructions
//   in both, so the two variants agree bit for bit. The statistics and di passes are shared by
//   the two. ptxas holds consumer code to 168 registers a thread, so a
//   256-thread block of these passes fits one an SM where one-warpgroup
//   blocks fit three, and "pair_batched" is the slower.
// - Keys at or past n_valid get P = 0 exactly, so their dk and dv rows come
//   out exactly 0 (key tiles wholly past n_valid are written as zeros).
// The first version ran three `mma.sync` passes of four-warp blocks with
// `cp.async` double buffering: 5.1 ms at the defaults on an H100 (PERF.md
// §6).
#include "flash_packed.cuh"

// Plain C entry point (loaded with ctypes). q, k, v, o, dout:
// (B, N, H * head_dim) bf16 contiguous, 16-byte aligned; grads
// (B, N, 3 * H * head_dim) bf16 contiguous, written as [dq | dk | dv]; lse
// and di: (B, H, N) f32 contiguous scratch. heads_per_block is the variant:
// 1 ("pair_staged") or 2 ("pair_batched"; with H odd the last block carries
// one head); head_dim 64 or 128. Returns a cudaError_t:
// the first failed launch's (or TMA descriptor's), or cudaErrorInvalidValue
// for a shape the kernels do not take.
extern "C" int dcvit_bench_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, void* grads, void* lse, void* di, int batch,
                                    int n, int heads, int head_dim, int n_valid, float sm_scale,
                                    int heads_per_block, void* stream) {
  using namespace dcvit;
  using bf16 = __nv_bfloat16;
  if (!fw::head_width_built(head_dim) || n < fw::kWgRows || n % fw::kWgRows != 0 ||
      n_valid < 1 || n_valid > n || batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      (heads_per_block != 1 && heads_per_block != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = heads * head_dim;
  CUtensorMap q_map, k_map, v_map, do_map, grads_map;
  cudaError_t err;
  if ((err = tensor_map3(&q_map, q, batch, n, d, fw::kWgRows, d)) != cudaSuccess ||
      (err = tensor_map3(&k_map, k, batch, n, d, fw::kWgRows, d)) != cudaSuccess ||
      (err = tensor_map3(&v_map, v, batch, n, d, fw::kWgRows, d)) != cudaSuccess ||
      (err = tensor_map3(&do_map, dout, batch, n, d, fw::kWgRows, d)) != cudaSuccess ||
      (err = tensor_map3(&grads_map, grads, batch, n, 3 * d, fw::kWgRows, 3LL * d)) !=
          cudaSuccess)
    return (int)err;
  // (a) the statistics pass: no v, no o
  auto stats = head_dim == 64 ? launch_flash_fwd<false, 64> : launch_flash_fwd<false, 128>;
  if ((err = stats(q_map, k_map, k_map, q_map, 0, 0, 0, static_cast<float*>(lse), batch, n,
                   heads, n_valid, sm_scale, st)) != cudaSuccess)
    return (int)err;
  // (b)-(d) di, dk/dv, dq
  auto run = head_dim == 64 ? (heads_per_block == 1 ? launch_flash_bwd<64, 1>
                                                    : launch_flash_bwd<64, 2>)
                            : (heads_per_block == 1 ? launch_flash_bwd<128, 1>
                                                    : launch_flash_bwd<128, 2>);
  return (int)run(q_map, k_map, v_map, do_map, grads_map, 0, 0, 0, static_cast<const bf16*>(o),
                  static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                  static_cast<float*>(di), static_cast<bf16*>(grads), batch, n, heads, n_valid,
                  sm_scale, st);
}
