// The shared Hopper core of the ln_mlp kernels (ln_mlp.cu, ln_mlp_bwd.cu, and
// the int8 ln_mlp_q.cu, ln_mlp_q_bwd.cu) and, through flash_wgmma.cuh, of the
// attention kernels: TMA tile loads into a ring of shared-memory stages, each
// with a full and an empty mbarrier, and warpgroup matrix products
// (`wgmma.mma_async`) on the tiles as they arrive, with f32 (bf16 products)
// or s32 (int8 products) accumulators in registers.
//
// Block shape (every kernel built on it): warpgroups 0 and 1 consume, each a
// 64-row `wgmma` tile; warpgroup 2 produces, one thread of it issuing every
// TMA load. `setmaxnreg` moves registers from the producer (24) to the
// consumers (240): 2 x 128 x 240 + 128 x 24 = 64,512 of the SM's 65,536.
// The roles split once, in one if/else that never reconverges, as
// `setmaxnreg` requires. (nvcc 12.9's ptxas still allocates the consumer
// code within the launch bound's 168 registers a thread, so the kernels keep
// a warpgroup's accumulators at 128 registers or fewer: a 192-register
// accumulator spilled.)
//
// Shared-memory tiles are TMA boxes of 128 bytes a row (64 bf16 columns, 128
// int8 or 32 f32) in the 128-byte swizzle, each based on a 1024-byte
// boundary:
// - K-major (the reduction axis contiguous): a [rows][64 k] box;
//   descriptor SBO = 1024 bytes (the next 8 rows), LBO unused; the k-step
//   of 16 inside the box adds 32 bytes to the start address.
// - MN-major (the output axis contiguous, `wgmma`'s transposed operand): a
//   [64 k][64 mn] box per 64 output columns, the boxes `mn_stride` bytes
//   apart; descriptor LBO = mn_stride (the next 64 columns), SBO = 1024 (the
//   next 8 k rows); the k-step of 16 adds 2048 bytes.
// Rows past the end of a tensor load as zeros (TMA's out-of-bounds fill) and
// are clipped by TMA stores, so a ragged last row tile needs no masking in
// the products.
//
// The TMA descriptors are encoded on the host through the driver's
// `cuTensorMapEncodeTiled`, fetched with the runtime's driver entry-point
// query (no link against libcuda), and passed as `__grid_constant__` kernel
// parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace dcvit {
namespace wg {

constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox = 64;                        // bf16 columns of a box
constexpr int kBoxBytes = kBox * kBox * 2;      // a 64 x 64 box
constexpr int kAlign = 1024;                    // swizzle-atom alignment

// ---- mbarriers --------------------------------------------------------------

DEV void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
DEV void bar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
// the producer's arrival, announcing `bytes` of TMA traffic to come
DEV void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
DEV void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
DEV bool bar_test(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
DEV uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}
// Wait until the phase of parity `parity` has completed. A wait that has not
// ended after 10 s traps, so a fault in a pipeline surfaces as a failed
// launch instead of a hung card.
DEV void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (bar_test(addr, parity)) return;
  const uint64_t start = global_ns();
  while (!bar_test(addr, parity))
    if (global_ns() - start > 10000000000ull) __trap();
}

// ---- clusters (distributed shared memory) -----------------------------------
//
// The int8 kernels at D = 768 (ln_mlp_q.cu, ln_mlp_q_bwd.cu) run pairs of
// blocks in a cluster that share their rows and exchange f32 partial sums,
// row maxima or int8 tiles; the GEMM of ln_mlp_gemm.cuh runs pairs that
// share a weight tile (`tma_load_multicast`, each block releasing a stage
// on both blocks' empty barriers with `bar_arrive_remote`). A thread stores
// into the other block's shared memory (`st.shared::cluster` at the address
// `peer_addr` maps) and then arrives on the other block's mbarrier with
// release semantics at cluster scope; the reader waits on its own mbarrier
// with acquire semantics at cluster scope (`bar_wait_cluster`). A reader
// with ordinary loads needs no proxy fence; where `wgmma` reads the stored
// tile (B7's hq boxes), the writer fences with `fence_async_cluster` before
// it arrives and the reader with `fence_async_smem` after its wait.

DEV uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster, with release / acquire
// semantics (a block's mbarriers are initialised before the other touches them)
DEV void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// the shared::cluster address of `p` (in this block's shared memory) in block `rank`
DEV uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}
DEV void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
DEV void st_peer4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}
DEV void st_peer_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// make this thread's generic shared-memory writes, in this block or another
// of the cluster, visible to TMA and wgmma
DEV void fence_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}
// arrive on the mbarrier at shared::cluster address `addr`, releasing this
// thread's earlier stores at cluster scope
DEV void bar_arrive_peer(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
// arrive on the mbarrier at shared::cluster address `addr` with the default
// (CTA-scope) release: how a consumer hands a ring stage back to the block
// whose producer multicasts into it (its reads were wgmma's, complete at
// wgmma.wait_group); a cluster-scope release here costs every k-step
DEV void bar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}
DEV bool bar_test_cluster(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
// bar_wait for a phase completed by the other block of a cluster (acquire at
// cluster scope: its stores before its arrivals are visible after the wait)
DEV void bar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (bar_test_cluster(addr, parity)) return;
  const uint64_t start = global_ns();
  while (!bar_test_cluster(addr, parity))
    if (global_ns() - start > 10000000000ull) __trap();
}

// ---- named barriers, proxy fences ------------------------------------------

// id 0 is __syncthreads'; the kernels use 1, 2 (one per consumer warpgroup)
// and 3 (both consumer warpgroups)
DEV void sync_named(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// make this thread's generic shared-memory writes visible to TMA and wgmma
DEV void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---- TMA ----------------------------------------------------------------------

DEV void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}
// tma_load into the same offset of every block of the cluster in `mask` (bit
// r: rank r), each block's mbarrier at `bar`'s offset receiving the bytes
DEV void tma_load_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                            uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "h"(mask)
      : "memory");
}
DEV void tma_store(const CUtensorMap* map, const void* src, int col, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(col), "r"(row)
               : "memory");
}
DEV void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
DEV void tma_store_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// wait until every committed store has read its shared-memory source (which
// may then be rewritten); the writes themselves may still be in flight
DEV void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- roles ---------------------------------------------------------------------

// This thread's warpgroup, read from lane 0 so that the compiler can prove it
// uniform across the warp: the role branches split whole warpgroups, as the
// warpgroup-wide `.sync.aligned` instructions in them require.
DEV int warpgroup() { return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0); }

// ---- register hand-over --------------------------------------------------------

template <int R>
DEV void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
DEV void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma --------------------------------------------------------------------------

// Shared-memory matrix descriptors, 128-byte swizzle, from a box's shared
// address: the high word (SBO 1024 bytes, the swizzle mode) is a constant,
// the low word the start address and LBO in 16-byte units.
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);
// The part of a shared address that a descriptor takes (its start address
// field holds 18 bits of it). A block launched in a cluster sees its own
// shared memory at addresses that carry its rank in the cluster from bit 24
// up (the shared::cluster window: TMA and mbarrier operands need those bits);
// desc_k / desc_mn of such an address would carry the rank into the stride
// field, so the cluster kernels build their descriptors from desc_addr(base).
DEV uint32_t desc_addr(uint32_t addr) { return addr & 0x3FFFFu; }
// K-major box at shared address `addr`, k-step `ks` (16 columns) inside it
DEV uint64_t desc_k(uint32_t addr, int ks) {
  return ((uint64_t)kDescHi << 32) | (((addr + 32 * ks) >> 4) | (1u << 16));
}
// MN-major boxes from shared address `addr`, `mn_stride` bytes apart,
// k-step `ks` (16 rows)
DEV uint64_t desc_mn(uint32_t addr, int ks, uint32_t mn_stride) {
  return ((uint64_t)kDescHi << 32) | (((addr + 2048 * ks) >> 4) | ((mn_stride >> 4) << 16));
}
// `v`, hidden from the compiler's loop-invariant hoisting: a kernel passes
// its shared base addresses through this once per loop iteration, so the
// descriptors are rebuilt next to each product instead of being held in
// registers across the loop.
DEV uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

DEV void mma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
DEV void mma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
DEV void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
DEV void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
DEV void acc_zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Element (row, col) of a 64-wide accumulator fragment: thread t of the
// warpgroup holds d[i] at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (t % 4) + i % 2.
DEV int acc_row(int t, int i) { return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1); }
DEV int acc_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

// Byte offset of element (row, col), col < 64, in a swizzled 128-byte-row box.
DEV uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}
// The dynamic shared memory `p`, rounded up to the swizzle-atom alignment
// (kernels allocate kAlign bytes beyond what they use).
DEV uint8_t* align(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + kAlign - 1) &
                                    ~uintptr_t(kAlign - 1));
}
// Store a bf16 pair (col even) into a swizzled box.
DEV void st_pair(uint8_t* box, int row, int col, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(box + swz(row, col)) = pack_bf16(lo, hi);
}

// d[0:32] (+)= A(64 x 16) B(16 x 64); f32 accumulators in the m64n64 layout.
template <int TA, int TB>
DEV void mma_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[0:64] (+)= A(64 x 16) B(16 x 128); f32 accumulators in the m64n128 layout.
template <int TA, int TB>
DEV void mma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[0:96] (+)= A(64 x 16) B(16 x 192); f32 accumulators in the m64n192 layout.
template <int TA, int TB>
DEV void mma_m64n192(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[0:128] (+)= A(64 x 16) B(16 x 256); f32 accumulators in the m64n256 layout.
template <int TA, int TB>
DEV void mma_m64n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---- int8 products ------------------------------------------------------------------
//
// `wgmma` on int8 takes both operands K-major (no transpose, no scale-a/b
// immediates) and sums exactly into s32 accumulators laid out as the f32
// ones, so acc_row / acc_col hold. An int8 K-major box of 128 columns is 128
// bytes a row, as a bf16 box of 64 is, so desc_k serves both: the k-step of
// 32 int8 values is the 32 bytes of bf16's k16.

// d[0:32] (+)= A(64 x 32) B(32 x 64), int8 in, s32 accumulators in the m64n64 layout.
DEV void mma_s8_m64n64(int (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] (+)= A(64 x 32) B(32 x 128), int8 in, s32 accumulators in the m64n128 layout.
DEV void mma_s8_m64n128(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:96] (+)= A(64 x 32) B(32 x 192), int8 in, s32 accumulators in the m64n192 layout.
DEV void mma_s8_m64n192(int (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int R>
DEV void acc_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Byte offset of byte column col < 128 in a swizzled 128-byte-row box: an
// int8 box of 128 columns, or (col = 4 c) column c < 32 of an f32 box.
DEV uint32_t swz_b(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}


// ---- GELU epilogues -------------------------------------------------------------

// tanh(u) = 1 - 2 / (exp(2u) + 1) from the SFU's exponential and reciprocal:
// within about 1e-7 of tanhf in absolute terms (far below a bf16 ulp of the
// GELU outputs it feeds) at a fraction of tanhf's instructions, which would
// otherwise cost the epilogues more than their products.
DEV float tanh_fast(float u) { return 1.f - __fdividef(2.f, __expf(2.f * u) + 1.f); }

// tanh-GELU (torch approximate="tanh") of x in f32
DEV float gelu(float x) {
  const float t = tanh_fast(0.7978845608028654f * (x + 0.044715f * x * x * x));
  return 0.5f * x * (1.f + t);
}
// tanh-GELU of x and its derivative, from one tanh
DEV void gelu_and_grad(float x, float& g, float& dg) {
  const float t = tanh_fast(0.7978845608028654f * (x + 0.044715f * x * x * x));
  g = 0.5f * x * (1.f + t);
  dg = 0.5f * (1.f + t) +
       0.5f * x * (1.f - t * t) * 0.7978845608028654f * (1.f + 3.f * 0.044715f * x * x);
}

}  // namespace wg

// ---- host: TMA descriptors ---------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The encoder needs a current context, which a thread that has made no CUDA
// call yet may lack: autograd's device thread can reach a backward kernel's
// entry point before anything there has touched the card, and PyTorch makes
// no context current on a thread whose device is already the one asked
// for. cudaFree(nullptr) makes the runtime's context current, once a thread.
inline cudaError_t encode_fn(EncodeTiledFn* out) {
  thread_local bool context_current = false;
  if (!context_current) {
    const cudaError_t err = cudaFree(nullptr);
    if (err != cudaSuccess) return err;
    context_current = true;
  }
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A row-major (rows, cols) tensor read or written in boxes of box_rows rows
// x 128 bytes, 128-byte swizzle, zero fill past the ends: bf16 (the default)
// in boxes of 64 columns, int8 (UINT8) of 128, f32 (FLOAT32) of 32.
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long rows, int cols,
                              int box_rows,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const int elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_UINT8     ? 1
                         : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                                                                   : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dcvit
