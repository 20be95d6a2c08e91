// hopper_tf32.cuh — building blocks of the port's tensor-core kernels on
// Hopper (sm_90a): the 3xTF32 split, the bf16 rounding, the tiles of the
// main kernels' B operands, mbarriers (also across a thread-block
// cluster), TMA tile loads (also multicast to a cluster), the register-A
// wgmma m64n128k8 and m64n64k8 (tf32) and the shared-memory wgmma
// m64nNk16 (bf16, N = 128, 192, 256), with f32 accumulation, as inline
// PTX.
//
// Layouts (PTX ISA, "Register fragments and shared memory matrix layouts"
// for wgmma .tf32 and .bf16; the same as CuTe's ALayout_64x8 /
// CLayout_64xN):
//   * A fragment, tf32 (64 x 8, registers): warp w of the warpgroup holds
//     rows 16w..16w+15; lane l holds a[0] = (16w + l/4,     l%4),
//     a[1] = (+8, l%4), a[2] = (l/4, l%4 + 4), a[3] = (+8, l%4 + 4).  In
//     bytes: register v holds the 4 bytes at byte 4(l%4) of the row's
//     16-byte chunk 2ks + (v >> 1) of a 32-byte k-step ks, row + 8 for odd
//     v.
//   * accumulator (64 x N, f32): d[4j + 2h + e] sits at row
//     16w + l/4 + 8h, column 8j + 2(l%4) + e.
//   * A and B from shared memory (K-major tiles): rows of 128 bytes (32
//     floats or 64 bf16) with the 128-byte swizzle that TMA's
//     CU_TENSOR_MAP_SWIZZLE_128B writes — 16-byte chunk c of row r sits
//     at chunk c ^ (r % 8) — so a tile base must be 1024-byte aligned.
//     32-bit operands have no transposed form, so B is K-major for both.
//     The c64 route's B tiles have rows of 64 bytes (16 floats) with the
//     64-byte swizzle (CU_TENSOR_MAP_SWIZZLE_64B: chunk c of row r at c ^
//     ((r / 2) % 4), a 512-byte pattern).
//   * a 16-bit A may also be MN-major ("transposed", the wgmma's
//     imm-trans-a = 1): rows of 128 bytes are K rows holding 64 M
//     elements, with the same swizzle; a 64 × 16 step reads two groups of
//     8 K rows, 1024 bytes apart (desc_mnmajor_sw128).
//   * in a cluster, a CTA's shared-memory address names the same offset in
//     every CTA of the cluster: a multicast TMA load writes its box, and
//     signals its mbarrier, at that offset in each CTA of its mask, and
//     mapa turns a local address into the one of a given CTA rank.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- 3xTF32 split ---------------------------------------------------------
// x = hi + lo + O(2^-22 |x|): hi = x rounded to TF32 (10-bit mantissa,
// nearest, ties away from zero), lo = the remainder rounded the same way.
// x - hi is exact in f32.  The rounding is integer arithmetic: half a TF32
// ulp added to the bits, the 13 low ones cleared — cvt.rna.tf32.f32's
// value for every finite x, but cvt.rna is a sequence of its own on
// sm_90a: with it the c64 kernel ran 6–9% slower (PERF.md §6).
//
// A NaN whose top 11 mantissa bits are set carries into a zero (0x7FFFFFFF
// to −0, 0xFFFFFFFF to +0), and the remainder of a NaN is the FSUB's
// canonical 0x7FFFFFFF.  KEEP_NAN holds the remainder's bits at most
// 0x7FFFEFFF, so that lo of a NaN or an inf is a NaN (0x7FFFE000), as
// cvt.rna's was: one integer min, for callers that may see any NaN.  The
// c64 kernel's A split skips it: its Hs is clamped before the split.
template <bool KEEP_NAN = true>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  int r = __float_as_int(x - __uint_as_float(hi));
  if (KEEP_NAN) r = min(r, 0x7FFFEFFF);
  lo = (static_cast<uint32_t>(r) + 0x1000u) & 0xFFFFE000u;
}

// f32 → bf16 bits, round to nearest even; NaN → 0x7FC0.  Bit for bit what
// torch's .to(torch.bfloat16) does (c10::BFloat16's round_to_nearest_even).
__device__ __forceinline__ uint16_t bf16_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// ---- the main kernels' B operands -------------------------------------------
// One 32 × 32 tile of B, the layout the main kernels read V in (K-major,
// row stride b_pad, zero-padded): rows j0 … j0+31 of a row-major float
// matrix X (row stride ldx floats; rows outside [0, rows) and columns from
// `cols` on read as 0), columns n0 … n0+31, transposed into B's rows n0 …
// n0+31 at K columns K0 … K0+31 (those below kend):
//   MODE 0 (f32): split into TF32 hi and lo, the lo plane `plane` floats
//     after the hi one;
//   MODE 2 (bf16): B bf16, X rounded to nearest even.
// (MODE 1, c64, is c64_operand_tile below.)  The pre-passes of
// ring_hemm.cu and the peer gather of ring_peers.cu both write B with
// it.  X = nullptr writes NaN in place of X's entries: a gather whose
// chunk never came poisons its product.  256 threads (32 × 8); `tile` may
// be reused on return.
template <int MODE>
__device__ __forceinline__ void b_operand_tile(
    float (&tile)[32][33], const float* __restrict__ X, long long ldx,
    int j0, int rows, int n0, int cols, void* __restrict__ B, int K0,
    int kend, int b_pad, long long plane) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int j = j0 + i, n = n0 + tx;
    float x = 0.0f;
    if (j >= 0 && j < rows && n < cols)
      x = X == nullptr ? __int_as_float(0x7FC00000)
                       : __ldcg(X + (long long)j * ldx + n);
    tile[i][tx] = x;
  }
  __syncthreads();
  const int K = K0 + tx;
  if (K < kend) {
#pragma unroll
    for (int i = ty; i < 32; i += 8) {
      const float x = tile[tx][i];
      const long long o = (long long)(n0 + i) * b_pad + K;
      if (MODE == 2) {
        static_cast<uint16_t*>(B)[o] = bf16_rne(x);
      } else {
        uint32_t hi, lo;
        split_tf32(x, hi, lo);
        static_cast<float*>(B)[o] = __uint_as_float(hi);
        static_cast<float*>(B)[plane + o] = __uint_as_float(lo);
      }
    }
  }
  __syncthreads();
}

// The c64 route's B (MODE 1): one 32 × 32 tile of a c64 X (rows j0 …
// j0+31 of `rows`, row stride ldx floats; complex columns n0 … n0+31 of
// `cols`; outside them 0) as six K-major planes, `plane` floats apart —
// Vr, Vd = fl(Vi − Vr) and Vs = fl(Vr + Vi), each TF32 hi then lo — the
// B operands of the three-product (3M) complex product (ring_hemm.cu's
// c64 note).  conj = 1 takes conj(X) (Vi = −Im X).  Otherwise as
// b_operand_tile.
__device__ __forceinline__ void c64_operand_tile(
    float (&tile)[2][32][33], const float* __restrict__ X, long long ldx,
    int j0, int rows, int n0, int cols, int conj, float* __restrict__ B,
    int K0, int kend, int b_pad, long long plane) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int j = j0 + i, n = n0 + tx;
    float2 z = make_float2(0.0f, 0.0f);
    if (j >= 0 && j < rows && n < cols) {
      if (X == nullptr) {
        z.x = z.y = __int_as_float(0x7FC00000);
      } else {
        z = __ldcg(reinterpret_cast<const float2*>(X + (long long)j * ldx) +
                   n);
        if (conj) z.y = -z.y;
      }
    }
    tile[0][i][tx] = z.x;
    tile[1][i][tx] = z.y;
  }
  __syncthreads();
  const int K = K0 + tx;
  if (K < kend) {
#pragma unroll
    for (int i = ty; i < 32; i += 8) {
      const float re = tile[0][tx][i], im = tile[1][tx][i];
      const float part[3] = {re, im - re, re + im};
      const long long o = (long long)(n0 + i) * b_pad + K;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        uint32_t hi, lo;
        split_tf32(part[c], hi, lo);
        B[2 * c * plane + o] = __uint_as_float(hi);
        B[(2 * c + 1) * plane + o] = __uint_as_float(lo);
      }
    }
  }
  __syncthreads();
}

// ---- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------
// one 2-D tile of `map` at element coordinates (c0 innermost, c1) into
// shared memory; completion is counted in bytes on `bar`.  Out-of-bounds
// elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- clusters ---------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_ctaid_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ctaid_y() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.y;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: arrive, then wait for all
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// arrive on the mbarrier at `bar`'s offset in the CTA of cluster rank
// `rank` (this CTA's own rank included), with the default (CTA-scope)
// release, as CUTLASS's ClusterBarrier does
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(smem_u32(bar)), "r"(rank) : "memory");
}

// tma_load_2d into the same offset of every CTA whose rank is set in
// `mask`, each completing on its own mbarrier at `bar`'s offset
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// make this thread's ordinary shared-memory writes visible to the async
// proxy (TMA, wgmma) before a barrier that orders them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier `id` (1..15) over `count` threads
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// ---- wgmma ------------------------------------------------------------------
// shared-memory descriptor of a K-major, 128-byte-swizzled tile: start
// address >> 4 (bits 0-13), leading offset 1 (unused for swizzled K-major),
// stride offset 1024 B between 8-row groups (bits 32-45), layout SW128.
// A k-step (8 floats or 16 bf16) inside the 128-byte row advances the
// start by 32 B.
__device__ __forceinline__ uint64_t desc_kmajor_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// the same for a K-major tile of 64-byte rows with the 64-byte swizzle
// (8-row groups 512 B apart, layout SW64); a k-step of 8 floats advances
// the start by 32 B, as above.
__device__ __forceinline__ uint64_t desc_kmajor_sw64(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((512ull >> 4) << 32) |
         (2ull << 62);
}

// shared-memory descriptor of an MN-major, 128-byte-swizzled 16-bit
// tile (K rows of 64 MN elements): the stride between 8-row K groups
// (bits 32-45) is 1024 B, and so is the leading offset (bits 16-29), the
// stride between 64-element MN blocks, which a 64-row A never crosses.
// A 16-deep k-step advances the start by 16 rows, 2048 B.
__device__ __forceinline__ uint64_t desc_mnmajor_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | ((1024ull >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the same for register-A fragments: keeps them live, unmoved, until after
// the wgmma_wait that retires the wgmma reading them
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

#define HOPPER_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A · B for a 64 x 128 x 8 step: A (tf32) in registers, B (tf32) by
// descriptor, f32 accumulator; `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
        "l"(desc_b));
}

// the same for a 64 x 64 x 8 step (32 accumulator registers)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
        "l"(desc_b));
}

// d (+)= A · B for a 64 x N x 16 step, bf16 · bf16 with both operands by
// descriptor (128-byte swizzle; B K-major, A K-major for TA = 0 and
// MN-major — the transposed form — for TA = 1), f32 accumulator of N/2
// registers; `accumulate` = 0 overwrites d.  bf16 · bf16 products are
// exact in f32.
template <int TA = 0>
__device__ __forceinline__ void wgmma_ss_m64n128k16_bf16(float (&d)[64],
                                                        uint64_t desc_a,
                                                        uint64_t desc_b,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA));
}

template <int TA = 0>
__device__ __forceinline__ void wgmma_ss_m64n192k16_bf16(float (&d)[96],
                                                        uint64_t desc_a,
                                                        uint64_t desc_b,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56),
        HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA));
}

template <int TA = 0>
__device__ __forceinline__ void wgmma_ss_m64n256k16_bf16(float (&d)[128],
                                                        uint64_t desc_a,
                                                        uint64_t desc_b,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p, 1, 1, %131, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56),
        HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88),
        HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA));
}

#undef HOPPER_D8

}  // namespace hopper
