// ring_hemm — the Chebyshev filter's HEMM, W (=|+=) H[:, col0:col0+b] · V,
// hand-written in CUDA C++ for Hopper (sm_90a): TMA loads into an mbarrier
// pipeline feeding register-A wgmma, with 3xTF32 for f32 accuracy: the f32
// route, and the c64 route in a kernel of its own that makes the complex
// product of three real products (Gauss's 3M form; the complex64 bullet
// below); and the bf16 route (bf16 H, f32 V rounded to bf16, f32 sums)
// for the bf16 rung, a kernel of its own: shared-memory wgmma on a 128×192
// tile in 2-CTA clusters that share V's tile by TMA multicast (its note is
// at ring_hemm_bf16_kernel below).
//
// Replaces the TPU kernel chase_tpu/ops/pallas_ring.py::_ring_kernel
// (built by make_hemm_local, run by parallel/ring.py::
// chebyshev_filter_ring_pallas).  That kernel computes one device's rows of
// W = H·V on a 1D ring of p devices: at ring step s it multiplies the H
// column block of the V chunk it holds and passes the chunk on; step 0
// stores, later steps add.  H streams in its own dtype (f32, or bf16 for
// the bf16 rung) and the dot accumulates in f32.  This kernel is one such
// step: `accumulate = 0` is the TPU kernel's s == 0 store, `accumulate =
// 1` its s > 0 add, so the multi-GPU ring can feed NCCL-received chunks
// into the same kernel.  On one card (p = 1) a filter step is one call
// with accumulate = 0, K = N.
//
// The trans route (ring_hemm_f32_t, ring_hemm_c64_t, ring_hemm_bf16_t)
// computes W (=|+=) H[row0:row0+b, :]ᴴ · V: one ring_B step of the 2-D
// ring, which the JAX package runs as XLA's matmul on h_blk.conj().T
// (chase_tpu/parallel/ring.py::_ring2d_pair).  It reads the rank's block
// in place, with no transposed copy: the A tile is loaded MN-major (the
// note at tile_row; the bf16 kernel's note), the c64 conjugate comes of
// Hᴴ·V = conj(Hᵀ·conj(V)) (the pre-pass splits conj(V), the epilogue
// negates Im), and row0 is TMA's outer coordinate, so the route has no
// `off` shift.  Same bound, tiles, stages, promotion and epilogue as the
// route it is the transpose of.
//
// What bounds it on an H100: one call at the solver's shapes (K = N =
// 30000, width k <= 3000) is 2·N²·k = 5.4 TFLOP against 3.6 GB of H, so it
// is bound by arithmetic.  IEEE f32 outside the tensor cores peaks at 67
// TFLOP/s, which no SIMT kernel can pass by much (the first version of
// this kernel reached 33, cuBLAS SGEMM 51).  The tensor cores do TF32 at
// 495 TFLOP/s; three TF32 products per f32 product (3xTF32) give f32-class
// accuracy at a ceiling of 165 TFLOP/s.  Next in line is the L2 → SM
// traffic: a 128×128×32 step reads 48 KB (H tile + V hi/lo tiles) for 1.05
// useful MFLOP, ~4.6 TB/s at 100 TFLOP/s.  Measured (H100 80GB HBM3 SXM,
// power limit 700 W): 50.99 ms = 105.9 TFLOP/s at (30000, 3000), against
// 110.76 ms for cuBLAS SGEMM.  A 1xTF32 variant took 64% of the time, and
// halving V's L2 reads (TMA multicast in 2-CTA clusters) gained nothing.
// In an nvidia-smi trace at 100 ms beside 160 back-to-back calls on one
// such card, the software power cap was active in every sample (median
// 699 W, SM clock 1230–1590 MHz, no thermal slowdown): on that card the
// power limit binds it as much as the tensor pipe.  Whether it does on
// every card, and what the per-tile issue gaps cost, is open (PERF.md §7).
//
// Error scheme of the f32 route (measured by a probe on the H100 before
// this kernel was written; PERF.md): x = hi + lo with hi = x rounded to
// TF32 (nearest, ties away from zero) and lo = x - hi rounded the same way
// (split_tf32, hopper_tf32.cuh: integer arithmetic, cvt.rna's bits for
// every finite x; its NaN guard keeps lo of a NaN or an inf a NaN), and H·V
// ≈ lo·Vhi + hi·Vlo + hi·Vhi, small terms first (lo·Vlo, at 2^-22
// relative, is dropped).  The wgmma accumulator's adder is not IEEE
// round-to-nearest: one accumulator over K = 30000 drifted to 2.1e-4
// relative, 63× cuBLAS.  So each K tile (32 deep, 12
// wgmma) sums into a fresh accumulator that is then added, in IEEE f32, to
// a running sum in registers (1.6e-6 at K = 30000, ≤ 1.14× cuBLAS at every
// probed shape; every 4th tile failed the 4×-plain bound at K = 200).
// Promoting every 2nd tile held the bound (2.6× cuBLAS at worst) but ran
// 5.5% slower at (30000, 3000) and 2.4% at (30000, 750) in this kernel
// (PERF.md).  The bf16 route promotes the same way, every 2nd 64-deep
// tile (its note).
//
// Design:
//   * split_transpose_kernel (f32 pre-pass): V (b × k, row stride ldv,
//     N-major) → Vt = [hi; lo], each (w_pad × b_pad), K-major and
//     zero-padded.  wgmma takes 32-bit B operands only K-major from shared
//     memory (there is no transposed form for tf32), and V is N-major.
//   * bf16_pack_kernel (bf16 pre-pass): V (b × k, f32) → Vb (w_pad ×
//     b_pad) bf16, V rounded to nearest-even (as torch's .to(bfloat16)),
//     transposed to K-major like the f32 route's B (wgmma could read a
//     transposed 16-bit B; K-major keeps the TMA boxes and the descriptor
//     of both operands alike).
//   * complex64 (ring_hemm_kernel_c64, pre-pass split_c64_kernel): the
//     complex product in three real products (3M, as cublasCgemm3m).
//     With H = Hr + i·Hi, V = Vr + i·Vi, Hs = fl(Hr + Hi), Vd = fl(Vi −
//     Vr), Vs = fl(Vr + Vi): k1 = Hs·Vr, k2 = Hr·Vd, k3 = Hi·Vs; Re = k1 −
//     k3, Im = k1 + k2.  6·m·b·k FLOPs done for the complex product's
//     8·m·b·k (which the yardstick, portbench/roofline.py, still counts):
//     9 m64n64k8 wgmma per 8-deep complex k-step where the real expansion
//     it replaced (rows V[j] and i·V[j] of a (2b × 2k) real B under the
//     f32 kernel on H's float view) issued 12 m64n128k8 per 16 complex; B
//     read by wgmma and TMA bytes per complex MAC fall by 25% and 17% (40
//     KB a stage for 16 × 128 × 64 complex MACs).  The kernel reads H's
//     interleaved (re, im) pairs and forms Hs in registers, so H costs no
//     extra memory; the pre-pass writes Vr, Vd, Vs in TF32 hi/lo: 6·b·k
//     floats of scratch where the expansion took 8·b·k.  Each k is a
//     3xTF32 product, promoted per 16-deep K tile, as the expansion's
//     32-float tile was.  Gauss's form (T1 = Hr·Vr, T2 = Hi·Vi, T3 =
//     Hs·Vs; Re = T1 − T2, Im = T3 − T1 − T2) costs five adds a promotion
//     where this one costs four, and ran 3–8% slower in this kernel
//     (probes/c64_route_design.py; PERF.md, PR 20).  Error: Gauss's Im
//     carries |Hs||Vs| + |Hr||Vr| + |Hi||Vi| times the products' f32-class
//     ε; here Re carries |Hs||Vr| + |Hi||Vs| and Im |Hs||Vr| + |Hr||Vd|,
//     each at most 2(|Hr| + |Hi|)(|Vr| + |Vi|)·ε, as Gauss's Im: up to
//     about twice the normwise bound of the 4M product, cancellation in
//     k1 − k3 included.  Measured against a c128 product at (30000, k):
//     1.8–2.2e-6, the expansion's 1.8–2.2e-6, cuBLAS CGEMM's 1.0–1.3e-5
//     (the chip gate: 1e-5 and 4× the plain CGEMM).  The A split is
//     split_tf32 without its NaN guard: the clamp on Hs stands for it
//     (c64r::set).  The trans route takes conj(V)'s planes and negates
//     Im: Hᴴ·V = conj(Hᵀ·conj(V)).  Registers: 3 × 32 accumulators,
//     2 × 32 running sums (re, im), 2 × 24 A fragments (Hs, Hr, Hi in
//     hi/lo for two k-steps) = 208 of the consumers' 232; ptxas (CUDA
//     12.9): 168 registers at launch (setmaxnreg then 40 / 232), 0 bytes
//     spilled, for both ring_hemm_kernel_c64<0> and <1>; the f32
//     instantiations 168, 0.
//     What binds it (measured with the probe's variants at (30000, 3000),
//     H100 80GB HBM3 at 700 W): the wgmma alone run at 135 ms, 96% of the
//     3xTF32 ceiling at the 8·m·b·k count; with the per-tile wait and
//     promotion 148–155 ms; with the fragment reads and TF32 splits (24
//     values a k-step, where the expansion split 16 per 12 wgmma) 185–192
//     ms, against the expansion's 196–200 in the same calls.
//   * the f32 main kernel, ring_hemm_kernel<E> for E = Tf32x3,
//     one 128×128 W tile per block, 384 threads:
//       - warpgroup 2 (one elected thread) is the producer: TMA loads of
//         the H tile (128 rows × 128 bytes: 32 f32 of K, 128-byte
//         swizzle) and the B tiles (128 columns × the same K: Vhi and Vlo)
//         into a ring of E::STAGES stages, guarded by full/empty
//         mbarriers; setmaxnreg gives its registers to the consumers (40 /
//         232);
//       - warpgroups 0 and 1 are consumers, 64 rows each: per K tile they
//         read their A fragments from the swizzled H tile into registers,
//         split into hi/lo there (so the H tile stays one f32 TMA load and
//         costs no extra shared memory, barrier or copy), and issue the
//         tile's 12 m64n128k8 wgmma with A from registers; then they
//         wait, release the stage and promote the tile's sum.  The next
//         tile's fragments are read while this tile's wgmma run (two
//         register sets), and two consumers keep the tensor cores busy
//         while the other promotes;
//   * grouped raster (GROUP_M = 8 row stripes per group), so the blocks
//     resident at once share H stripes and V tiles in L2.  Measured on the
//     H100 against one block row per column sweep: the pipelined fragments
//     and the grouped raster together took (30000, 3000) from 77.4 to
//     60.0 ms in one call, the same ~+27% at widths 750 and 2250 (PERF.md).
//   * ragged edges: the H descriptor is exactly H[:m, :col0+b] (col0 is a
//     TMA coordinate, not a pointer offset), so TMA zero-fills rows past m
//     and columns past col0+b.  TMA's inner coordinate must be 16-byte
//     aligned, so the boxes start at col0 - off, off = col0 % 4 f32 (2
//     c64, 8 bf16): the pre-pass shifts V's rows by `off` columns of its
//     output (zeros before them) and the consumers zero the first tile's `off`
//     leading A columns, in registers (f32) or in shared memory (bf16), so
//     that a non-finite H entry left of the block cannot leak in as 0·inf.
//     The pre-pass output is zero-padded; the epilogue stores (or adds
//     into) W with masked plain stores, so W may be a strided column
//     window and nothing outside [0,m)×[0,k) is touched.  TMA needs H
//     16-byte aligned with a row stride of a whole number of 16 bytes (4
//     floats, 2 c64, 8 bf16; the wrapper checks, DenseOperator pads).
//   * the one driver-API call, cuTensorMapEncodeTiled, is reached through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Shared memory per block (f32): 4 stages × (16 + 16 + 16) KB = 192 KB of
// dynamic shared memory (plus 1 KB for alignment and the barriers); c64:
// 5 stages × (16 + 6 × 4) KB = 200 KB.
// Registers: 168 at launch; setmaxnreg moves the producer to 40 and the
// consumers to 232 (2 × 64 accumulators + 2 sets of A fragments, 2 × 32
// registers).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tf32.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                  // W tile rows (2 consumers × 64)
constexpr int BN = 128;                  // W tile columns (wgmma N)
constexpr int GROUP_M = 8;               // row stripes per raster group
constexpr int TILE_BYTES = BM * 128;     // 128 rows of 128 bytes = 16 KB
constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;

// ---- the f32 route ----------------------------------------------------------
// Each K tile is 128 bytes of a row: BK elements.  A fragment register v
// of k-step ks holds the 32-bit word q = lane % 4 of the row's 16-byte
// chunk 2 ks + (v >> 1) (hopper_tf32.cuh); `col` is the tile column of the
// word's first element.

// f32: 3xTF32
struct Tf32x3 {
  static constexpr int BK = 32;              // K tile: 32 f32 = one 128 B row
  static constexpr int ALIGN = 4;            // elements per 16 bytes
  static constexpr int B_TILES = 2;          // V's hi and lo parts
  static constexpr int STAGES = 4;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  struct Frag { uint32_t hi[4][4], lo[4][4]; };

  __device__ static void set(Frag& f, int ks, int v, uint32_t word, int q,
                             int kmin) {
    const int col = 8 * ks + 4 * (v >> 1) + q;
    split_tf32(col >= kmin ? __uint_as_float(word) : 0.0f, f.hi[ks][v],
               f.lo[ks][v]);
  }
  // B tiles: Vhi at `b`, Vlo at b + TILE_BYTES; small terms first
  __device__ static void mma(float (&acc)[64], Frag& f, const void* b) {
    const uint64_t dh = desc_kmajor_sw128(b);
    const uint64_t dl = desc_kmajor_sw128(
        static_cast<const unsigned char*>(b) + TILE_BYTES);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_m64n128k8_tf32(acc, f.lo[ks], dh + 2 * ks, ks == 0 ? 0 : 1);
      wgmma_m64n128k8_tf32(acc, f.hi[ks], dl + 2 * ks, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n128k8_tf32(acc, f.hi[ks], dh + 2 * ks, 1);
  }
  __device__ static void fence(Frag& f) {
    fence_regs(f.hi);
    fence_regs(f.lo);
  }
};

template <class E>
__host__ __device__ constexpr int stage_bytes() {
  return (1 + E::B_TILES) * TILE_BYTES;
}

template <class E>
__host__ __device__ constexpr int smem_bytes() {
  return E::STAGES * stage_bytes<E>() + 1024 + 2 * E::STAGES * 8;
}

// ---- the trans route's A tile ----------------------------------------------
// TU = 0: the tile is H[m0:m0+128, K tile] as it lies (K-major: one TMA box
// of 128 rows × 128 bytes).  TU = 1: A = H[row0:row0+b, :]ᴴ, so the tile's
// K runs along H's rows and its M along H's columns — MN-major.  The
// 128-byte swizzle caps a box's inner extent at 128 bytes (32 f32
// columns), so the tile is 4 boxes of BK H rows × 128 bytes, box x
// holding H columns m0 + 32x onwards; each box is 128-byte swizzled
// (16-byte chunk c of box row kk at c ^ (kk % 8)).
//
// A warp's fragment load reads 8 M positions (lane/4) × 4 K positions
// (lane%4).  Read in order, the 8 M positions share 2 chunks of a box
// row and rows kk, kk ^ 1 swizzle onto the same chunks: a 2-way bank
// conflict.  So the tile's M order is permuted (free: M is W's row, and
// the epilogue writes row m0 + tile_row(L)): accumulator row L = [u3 u2 u1
// u0 s x1 x0] (bits) reads H column tile_row(L) = [u3 u2 s u1 u0 x1 x0] —
// lane/4 = [s x1 x0] then covers chunks 4s + (u1 u0) of one box, and with
// the swizzle's XOR by kk % 8 = 4h + lane%4 the 32 lanes hit 32 banks.
// (The c64 kernel's rows are permuted too: c64r::tile_row.)
template <int TU>
__device__ __forceinline__ int tile_row(int L) {
  if constexpr (TU == 1)
    return (L & 0x63) | ((L & 0x04) << 2) | ((L & 0x18) >> 1);
  else
    return L;
}

// ---- f32 pre-pass: split and transpose the V chunk --------------------------
// Vt[0][n][off + j] = hi(V[j][n]), Vt[1][n][off + j] = lo(V[j][n]) for j <
// b, n < k; zero elsewhere in (w_pad × b_pad).  32×32 tiles through shared
// memory (b_operand_tile, hopper_tf32.cuh) so both the read (along n) and
// the write (along kk) are coalesced.
__global__ void __launch_bounds__(256)
split_transpose_kernel(const float* __restrict__ V, long long ldv,
                       float* __restrict__ Vt, int b, int k, int off,
                       int b_pad, int w_pad) {
  __shared__ float tile[32][33];
  const int kk0 = blockIdx.x * 32;
  b_operand_tile<0>(tile, V, ldv, kk0 - off, b, blockIdx.y * 32, k, Vt, kk0,
                    b_pad, b_pad, (long long)w_pad * b_pad);
}

// ---- c64 pre-pass: the six planes of the V chunk ----------------------------
// For a c64 V (b × k, row stride ldv floats): Vt[2c + l][n][off + j] =
// part l (hi, lo) of the TF32 split of component c of V[j][n] — Vr, Vd =
// fl(Vi − Vr) and Vs = fl(Vr + Vi) — for j < b, n < k; zero elsewhere in
// (6 × w_pad × b_pad) (c64_operand_tile, hopper_tf32.cuh).  conj = 1
// splits conj(V): the trans route's B.
__global__ void __launch_bounds__(256)
split_c64_kernel(const float* __restrict__ V, long long ldv,
                 float* __restrict__ Vt, int b, int k, int off, int b_pad,
                 int w_pad, int conj) {
  __shared__ float tile[2][32][33];
  const int kk0 = blockIdx.x * 32;
  c64_operand_tile(tile, V, ldv, kk0 - off, b, blockIdx.y * 32, k, conj, Vt,
                   kk0, b_pad, b_pad, (long long)w_pad * b_pad);
}

// ---- bf16 pre-pass: round and transpose the V chunk --------------------------
// Vb[n][off + j] = bf16(V[j][n]) for j < b, n < k; zero elsewhere in
// (w_pad × b_pad).  The same 32×32 shared-memory transpose as the f32
// pre-pass (b_operand_tile).
__global__ void __launch_bounds__(256)
bf16_pack_kernel(const float* __restrict__ V, long long ldv,
                 uint16_t* __restrict__ Vb, int b, int k, int off,
                 int b_pad) {
  __shared__ float tile[32][33];
  const int kk0 = blockIdx.x * 32;
  b_operand_tile<2>(tile, V, ldv, kk0 - off, b, blockIdx.y * 32, k, Vb, kk0,
                    b_pad, b_pad, 0);
}

// ---- main kernel ------------------------------------------------------------
template <class E, int TU>
__global__ void __launch_bounds__(NTHREADS, 1)
ring_hemm_kernel(const __grid_constant__ CUtensorMap tmH,
                 const __grid_constant__ CUtensorMap tmV,
                 float* __restrict__ W, long long ldw, int m, int k, int b,
                 int col0, int off, int w_pad, int accumulate) {
  constexpr int STAGE_BYTES = stage_bytes<E>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: the H tile, then the B tile(s), each TILE_BYTES, 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + E::STAGES * STAGE_BYTES);
  uint64_t* empty = full + E::STAGES;

  // grouped raster: consecutive blocks walk GROUP_M row stripes of one
  // column tile before the next column tile, so the blocks resident at
  // once share both their H stripes and their V tiles in L2
  const int num_n = gridDim.x, num_m = gridDim.y;
  const int id = blockIdx.y * num_n + blockIdx.x;
  const int first_m = id / (GROUP_M * num_n) * GROUP_M;
  const int gsize = min(num_m - first_m, GROUP_M);
  const int in_group = id % (GROUP_M * num_n);
  const int m0 = (first_m + in_group % gsize) * BM;
  const int n0 = in_group / gsize * BN;
  const int ntiles = (b + off + E::BK - 1) / E::BK;
  const int kbase = col0 - off;          // 16-byte-aligned TMA coordinate
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < E::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tmH);
      tma_prefetch_desc(&tmV);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % E::STAGES;
        mbar_wait(&empty[s], ((t / E::STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        if constexpr (TU == 0) {
          tma_load_2d(st, &tmH, &full[s], kbase + t * E::BK, m0);
        } else {                 // 4 boxes of BK rows of H (col0 = row0)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            tma_load_2d(st + x * (TILE_BYTES / 4), &tmH, &full[s], m0 + 32 * x,
                        col0 + t * E::BK);
        }
#pragma unroll
        for (int i = 0; i < E::B_TILES; ++i)
          tma_load_2d(st + (1 + i) * TILE_BYTES, &tmV, &full[s], t * E::BK,
                      i * w_pad + n0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float run[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = acc[i] = 0.0f;
    // A fragment register (ks, v): row 16 w + l/4 + 8 (v & 1) of this
    // warpgroup's 64, 32-bit word l%4 of the row's 16-byte chunk 2 ks +
    // (v >> 1); in the swizzled tile that chunk sits at (2 ks + (v >> 1))
    // ^ (row % 8), and row % 8 = l/4.
    const int arow = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int q = lane % 4, r8 = lane / 4;
    // the trans route (TU = 1): for A row arow + 8 h, H column P =
    // tile_row(arow + 8 h) lies in box P / 32 at element fi = P % 32 of
    // each box row; its K position kc = 8 ks + 4 (v >> 1) + q is box row
    // kk = c + q with c = 8 ks + 4 (v >> 1), whose bits do not meet q's,
    // so kk % 8 = (c % 8) ^ q.  The word is then tbase[h] + 32 c + (((fi >>
    // 2) ^ q ^ (c % 8)) << 2): a per-thread base and XOR key, and per
    // register two compile-time constants.
    int tbase[2] = {0, 0}, tkey[2] = {0, 0};
    if constexpr (TU > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int P = tile_row<TU>(arow + 8 * h);
        const int fi = P % 32;
        tbase[h] = P / 32 * E::BK * 32 + 32 * q + (fi & 3);
        tkey[h] = ((fi >> 2) ^ q) << 2;
      }
    }
    using Frag = typename E::Frag;
    // tile t's A fragments: wait for its stage, read (and split, for f32)
    auto load_a = [&](int t, Frag& f) {
      const int s = t % E::STAGES;
      mbar_wait(&full[s], (t / E::STAGES) & 1);
      const uint32_t* Ht =
          reinterpret_cast<const uint32_t*>(smem + s * STAGE_BYTES);
      const int kmin = t == 0 ? off : 0;     // columns left of the block
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if constexpr (TU == 0) {
            const int r = arow + 8 * (v & 1);
            const int chunk = (2 * ks + (v >> 1)) ^ r8;
            E::set(f, ks, v, Ht[r * 32 + chunk * 4 + q], q, kmin);
          } else {
            const int c = 8 * ks + 4 * (v >> 1);   // unrolled: a constant
            const int h = v & 1;
            E::set(f, ks, v, Ht[tbase[h] + 32 * c + (tkey[h] ^ ((c & 7) << 2))],
                   q, 0);
          }
        }
    };
    // issue tile t's wgmma into a fresh accumulator
    auto mma = [&](int t, Frag& f) {
      fence_regs(acc);
      wgmma_fence();
      E::mma(acc, f, smem + (t % E::STAGES) * STAGE_BYTES + TILE_BYTES);
      wgmma_commit();
    };
    // wait for tile t's wgmma, release its stage, promote its sum (IEEE)
    auto finish = [&](int t, Frag& f) {
      wgmma_wait<0>();
      fence_regs(acc);
      E::fence(f);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % E::STAGES]);
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] += acc[i];
    };
    // two register sets: tile t + 1's fragments are read while tile t's
    // wgmma run (unrolled by two so each set has fixed registers)
    Frag f0, f1;
    if (ntiles > 0) load_a(0, f0);
    for (int t = 0; t < ntiles; t += 2) {
      mma(t, f0);
      if (t + 1 < ntiles) load_a(t + 1, f1);
      finish(t, f0);
      if (t + 1 < ntiles) {
        mma(t + 1, f1);
        if (t + 2 < ntiles) load_a(t + 2, f0);
        finish(t + 1, f1);
      }
    }
    // epilogue: d[4j + 2h + e] is row arow + 8h, column 8j + 2(l%4) + e
    // (on the trans route the tile's row tile_row(arow + 8h))
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + tile_row<TU>(arow + 8 * h);
      if (r >= m) continue;
      float* wrow = W + (long long)r * ldw;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * j + 2 * q + e;
          const float x = run[4 * j + 2 * h + e];
          if (c < k) wrow[c] = accumulate ? wrow[c] + x : x;
        }
    }
  }
}

// ---- the c64 route's kernel: three real products (3M) ----------------------
// W (=|+=) H[:, col0:col0+b] · V for c64 H, V and W, with H = Hr + i·Hi and
// V = Vr + i·Vi as
//   k1 = (Hr + Hi)·Vr,  k2 = Hr·(Vi − Vr),  k3 = Hi·(Vr + Vi),
//   Re W = k1 − k3,  Im W = k1 + k2,
// each k a 3xTF32 product (the f32 route's error scheme), 6·m·b·k FLOPs
// (the design note at the top).  One 128 × 64 (complex) W tile per block,
// 384 threads:
//   - the producer (warpgroup 2) brings, per K tile of BK = 16 complex,
//     the interleaved c64 H tile (128 rows × 128 bytes, 128-byte swizzle;
//     on the trans route 8 boxes of 16 H rows × 16 complex) and the six B
//     tiles of the c64 pre-pass (Vr, Vd = fl(Vi − Vr), Vs = fl(Vr + Vi),
//     each TF32 hi and lo; 64 rows × 16 floats, 64-byte swizzle): 16 + 24
//     KB a stage;
//   - each consumer (64 rows) reads per k-step (8 complex) its (re, im)
//     pairs from the H tile with 8-byte loads, forms Hs = fl(Hr + Hi) in
//     registers, splits Hs, Hr, Hi into TF32 hi and lo, and issues k1, k2
//     and k3 small terms first (lo·Vhi, hi·Vlo, hi·Vhi; m64n64k8) into
//     three fresh accumulators; the K tile's second k-step is read while
//     its first runs, and the next tile's first while its second runs
//     (two fragment sets, 2 × 24 registers);
//   - after each K tile (16 complex, as often as the real expansion this
//     kernel replaced promoted) it waits, releases the stage and promotes
//     in IEEE f32: re += k1 − k3, im += k1 + k2;
//   - the epilogue writes (re, im) pairs into W (row stride ldw floats)
//     with masked 8-byte stores, `accumulate` as the f32 kernel.
// TU = 1 is the trans route, W (=|+=) H[col0:col0+b, :]ᴴ · V, by Hᴴ·V =
// conj(Hᵀ·conj(V)): the pre-pass splits conj(V), the A tile is read
// MN-major (the f32 trans route's boxes), and the epilogue negates Im.
// Registers per consumer thread: 3 × 32 accumulators, 2 × 32 running sums,
// 2 × 24 fragments = 208 of 232 (setmaxnreg).
namespace c64r {
constexpr int BK = 16;                   // K tile: 16 complex = a 128 B H row
constexpr int BN = 64;                   // W tile columns (complex; wgmma N)
constexpr int ALIGN = 2;                 // complex elements per 16 bytes
constexpr int PLANES = 6;                // Vr, Vd, Vs, each TF32 hi and lo
constexpr int B_BYTES = BN * BK * 4;     // a plane's tile: 64 rows of 64 B
constexpr int STAGE_BYTES = TILE_BYTES + PLANES * B_BYTES;   // 40 KB
constexpr int STAGES = 5;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory");

// a k-step's A fragments: TF32 hi and lo of Hs, Hr and Hi
struct Frag { uint32_t hi[3][4], lo[3][4]; };

// register v of a k-step from its (re, im) pair: Hs = fl(Hr + Hi) with its
// bits held at most 0x7FFFEFFF (a NaN stays a NaN: a NaN anywhere in H
// reaches k1, and so both parts of its row), Hr, Hi.  The clamp on Hs
// stands for split_tf32's NaN guard, which these splits skip.
__device__ __forceinline__ void set(Frag& f, int v, float2 h) {
  const float s = __int_as_float(min(__float_as_int(h.x + h.y), 0x7FFFEFFF));
  split_tf32<false>(s, f.hi[0][v], f.lo[0][v]);
  split_tf32<false>(h.x, f.hi[1][v], f.lo[1][v]);
  split_tf32<false>(h.y, f.hi[2][v], f.lo[2][v]);
}

__device__ __forceinline__ void fence(Frag& f) {
  fence_regs(f.hi);
  fence_regs(f.lo);
}

// The tile row (untransposed) or column (trans) that accumulator row L =
// [.. h r2 r1 r0] (bits; r = lane/4, h the fragment's +8) reads: permuted
// (free, as for the f32 trans route) so that a half-warp's 8-byte
// fragment loads hit 32 distinct banks.  Untransposed, the half-warp's
// rows r1 r0 sit at swizzle keys 2 (r1 r0) + r2 and its chunks are key ^
// (even base + q/2): 8 chunks × 2 words of q%2.  Trans, lane (r, q) reads
// element e = [r1 h r2 r0] of its box row kk, whose key is 4 (v >> 1) + q:
// chunk (e >> 1) ^ kk % 8 and word e & 1 are distinct over r1 r0 q.
template <int TU>
__device__ __forceinline__ int tile_row(int L) {
  if constexpr (TU == 0)
    return (L & ~7) | ((L & 3) << 1) | ((L >> 2) & 1);
  else
    return (L & ~15) | ((L & 2) << 2) | ((L & 8) >> 1) | ((L & 4) >> 1) |
           (L & 1);
}
}  // namespace c64r

// W (=|+=) H[:, col0:col0+b] · V (TU = 1: H[col0:col0+b, :]ᴴ · V) with V
// given as the c64 pre-pass's six planes (w_pad × b_pad each; off = col0 %
// 2); m, k, b, col0 and off in complex elements, ldw in floats.
template <int TU>
__global__ void __launch_bounds__(NTHREADS, 1)
ring_hemm_kernel_c64(const __grid_constant__ CUtensorMap tmH,
                     const __grid_constant__ CUtensorMap tmV,
                     float* __restrict__ W, long long ldw, int m, int k,
                     int b, int col0, int off, int w_pad, int accumulate) {
  constexpr int BK = c64r::BK, BN = c64r::BN, PLANES = c64r::PLANES;
  constexpr int B_BYTES = c64r::B_BYTES, STAGES = c64r::STAGES;
  constexpr int STAGE_BYTES = c64r::STAGE_BYTES;
  using Frag = c64r::Frag;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: the H tile, then the six B tiles, 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // the f32 kernel's grouped raster
  const int num_n = gridDim.x, num_m = gridDim.y;
  const int id = blockIdx.y * num_n + blockIdx.x;
  const int first_m = id / (GROUP_M * num_n) * GROUP_M;
  const int gsize = min(num_m - first_m, GROUP_M);
  const int in_group = id % (GROUP_M * num_n);
  const int m0 = (first_m + in_group % gsize) * BM;
  const int n0 = in_group / gsize * BN;
  const int ntiles = (b + off + BK - 1) / BK;
  const int kbase = 2 * (col0 - off);    // 16-byte-aligned float coordinate
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tmH);
      tma_prefetch_desc(&tmV);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        if constexpr (TU == 0) {
          tma_load_2d(st, &tmH, &full[s], kbase + 2 * BK * t, m0);
        } else {                 // 8 boxes of BK rows of H (col0 = row0)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            tma_load_2d(st + x * (TILE_BYTES / 8), &tmH, &full[s],
                        2 * m0 + 32 * x, col0 + BK * t);
        }
#pragma unroll
        for (int i = 0; i < PLANES; ++i)
          tma_load_2d(st + TILE_BYTES + i * B_BYTES, &tmV, &full[s], BK * t,
                      i * w_pad + n0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float k1[32], k2[32], k3[32], re[32], im[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) k1[i] = k2[i] = k3[i] = re[i] = im[i] = 0.0f;
    // A fragment register v of k-step ks: row arow + 8 (v & 1), complex K
    // column cc = 8 ks + 4 (v >> 1) + q, read as its (re, im) floats.
    // Untransposed: H tile row P = tile_row(arow + 8h), floats 2 cc, 2 cc
    // + 1 in 16-byte chunk cc / 2 = 4 ks + 2 (v >> 1) + q / 2, word 2 (q %
    // 2), the chunk swizzled by P % 8.  Trans: H column P's box P / 16 and
    // element e = P % 16, box row kk = cc (swizzle key kk % 8 = 4 (v >> 1)
    // + q), chunk e / 2, word 2 (e % 2).  Either way a per-thread base and
    // XOR key, and per register compile-time constants.
    const int arow = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int q = lane % 4;
    int base[2], key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int P = c64r::tile_row<TU>(arow + 8 * h);
      if constexpr (TU == 0) {
        base[h] = P * 32 + 2 * (q & 1);
        key[h] = ((q >> 1) ^ (P & 7)) << 2;
      } else {
        // boxes of 16 rows × 32 floats
        base[h] = (P >> 4) * 16 * 32 + 32 * q + 2 * (P & 1);
        key[h] = (((P & 15) >> 1) ^ q) << 2;
      }
    }
    // k-step ks of tile t: wait for its stage (ks = 0), read and split
    auto load_a = [&](int t, int ks, Frag& f) {
      const int s = t % STAGES;
      if (ks == 0) mbar_wait(&full[s], (t / STAGES) & 1);
      const float* Ht = reinterpret_cast<const float*>(smem + s * STAGE_BYTES);
      // complex column 0 of the first tile lies left of the block when off
      // = 1: zeroed, so that a non-finite entry there cannot leak in as
      // 0·inf
      const bool left = TU == 0 && t == 0 && ks == 0 && off > 0 && q == 0;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int h = v & 1, hv = v >> 1;
        const int i = TU == 0
            ? base[h] + (key[h] ^ ((4 * ks + 2 * hv) << 2))
            : base[h] + 32 * (8 * ks + 4 * hv) + (key[h] ^ (hv << 4));
        float2 x = *reinterpret_cast<const float2*>(Ht + i);
        if (hv == 0 && left) x = make_float2(0.0f, 0.0f);
        c64r::set(f, v, x);
      }
    };
    // k-step ks of tile t's wgmma: k1 (Hs·Vr), k2 (Hr·Vd), k3 (Hi·Vs)
    // small terms first; fresh (acc = 0) overwrites the accumulators
    auto mma = [&](int t, int ks, Frag& f, int acc) {
      const unsigned char* bt = smem + (t % STAGES) * STAGE_BYTES + TILE_BYTES;
      uint64_t d[PLANES];
#pragma unroll
      for (int i = 0; i < PLANES; ++i)
        d[i] = desc_kmajor_sw64(bt + i * B_BYTES) + 2 * ks;
      wgmma_m64n64k8_tf32(k1, f.lo[0], d[0], acc);
      wgmma_m64n64k8_tf32(k2, f.lo[1], d[2], acc);
      wgmma_m64n64k8_tf32(k3, f.lo[2], d[4], acc);
      wgmma_m64n64k8_tf32(k1, f.hi[0], d[1], 1);
      wgmma_m64n64k8_tf32(k2, f.hi[1], d[3], 1);
      wgmma_m64n64k8_tf32(k3, f.hi[2], d[5], 1);
      wgmma_m64n64k8_tf32(k1, f.hi[0], d[0], 1);
      wgmma_m64n64k8_tf32(k2, f.hi[1], d[2], 1);
      wgmma_m64n64k8_tf32(k3, f.hi[2], d[4], 1);
    };
    Frag f0, f1;
    if (ntiles > 0) load_a(0, 0, f0);
    for (int t = 0; t < ntiles; ++t) {
      fence_regs(k1);
      fence_regs(k2);
      fence_regs(k3);
      wgmma_fence();
      mma(t, 0, f0, 0);
      wgmma_commit();
      load_a(t, 1, f1);                  // while k-step 0 runs
      wgmma_fence();
      mma(t, 1, f1, 1);
      wgmma_commit();
      if (t + 1 < ntiles) {              // k-step 0 retired: f0 is free
        wgmma_wait<1>();
        c64r::fence(f0);
        load_a(t + 1, 0, f0);
      }
      wgmma_wait<0>();
      fence_regs(k1);
      fence_regs(k2);
      fence_regs(k3);
      c64r::fence(f0);
      c64r::fence(f1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        re[i] += k1[i] - k3[i];
        im[i] += k1[i] + k2[i];
      }
    }
    // epilogue: d[4j + 2h + e] is row tile_row(arow + 8h), complex column
    // 8j + 2(l%4) + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + c64r::tile_row<TU>(arow + 8 * h);
      if (r >= m) continue;
      float2* wrow = reinterpret_cast<float2*>(W + (long long)r * ldw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * j + 2 * q + e;
          const int i = 4 * j + 2 * h + e;
          float2 x = make_float2(re[i], TU ? -im[i] : im[i]);
          if (c < k) {
            if (accumulate) {
              const float2 y = wrow[c];
              x.x = y.x + x.x;
              x.y = y.y + x.y;
            }
            wrow[c] = x;
          }
        }
    }
  }
}

// ---- the bf16 route's kernel ------------------------------------------------
// ring_hemm_bf16_kernel replaces the same TPU kernel, _ring_kernel, as it
// streams a bf16 H (the bf16 rung): W (=|+=) H[:, col0:col0+b] · bf16(V),
// every product exact in f32 (8-bit mantissas), f32 sums.
//
// What bounds it on an H100: at (30000, 3000) the bf16 tensor cores
// (989 TFLOP/s) need 5.46 ms and HBM 0.54 ms, so arithmetic — but only if
// the tiles reach the SMs fast enough.  Each 64-deep K step of a BM × BN
// W tile brings (BM + BN) · 128 bytes from L2 into shared memory for
// 2·BM·BN·64 FLOPs.  Measured on an H100 80GB HBM3 SXM (power limit 700
// W; probes/bf16_route_design.py), the variants without multicast drew
// 5.5–7.8 TB/s of such reads: 128×128 (32 KB per 2.10 MFLOP: the
// register-A design this kernel replaced, and its shared-memory form)
// 12.7–15.9 ms at (30000, 3000), 128×192 (40 KB per 3.15 MFLOP) 9.9–12.2
// ms.  The tile cannot grow past 128×192 here: the IEEE promotion keeps
// a running sum beside the accumulators, 2 × BN/2 floats per consumer
// thread, and 192 + addresses fit the consumers' 232 registers
// (setmaxnreg 40 / 232 of 65,536 for 384 threads) where 256 would not.
// Shared memory: 5 stages of 16 + 24 KB = 200 KB of 227.
//
// Design, against those limits:
//   * 2×1 thread-block clusters: the two CTAs hold two row stripes of one
//     column tile and each TMA-multicasts half of the V tile to both, so
//     a K step reads 16 + 12 KB from L2 per 3.15 MFLOP (0.58× the 128×128
//     tile's bytes per FLOP).  A stage is refilled only when the consumers
//     of both CTAs have released it: each consumer warp arrives on the
//     empty barrier of every CTA that wrote into the stage (mapa +
//     mbarrier.arrive.shared::cluster, CTA-scope release, as CUTLASS
//     does — a cluster-scope release on that arrive made every cluster
//     variant 1.3–1.7× slower than its unclustered form), and the
//     producer waits, before it exits, for the releases still owed to its
//     barriers.  The grid's row and column counts are rounded up to whole
//     clusters; an extra CTA reads TMA's zero fill and stores nothing.
//   * A and B from shared memory (wgmma m64n192k16 with two descriptors):
//     no A fragments in registers, which leaves them to the running sum.
//     The first tile's `off` columns left of the block are zeroed in
//     shared memory (fence.proxy.async, then a warpgroup barrier, before
//     that tile's wgmma).
//   * promotion every PROMOTE = 2 K tiles (128 deep): inside a group each
//     tile's wgmma is issued before the previous one is waited for
//     (wgmma_wait<1>, one group in flight), so a consumer idles only at
//     the group's end, where it waits, promotes into the IEEE running sum
//     and the other consumer keeps the tensor cores busy.
//   * the same grouped raster as the f32 kernel, over clusters.
// Measured beside each other (same card and limit, three calls of the
// probe; error against an f64 product of the rounded operands at K =
// 30000): the kept variant 9.04–9.46 ms at (30000, 3000), 4.72–4.86 ms at
// 1500, 2.50–2.58 ms at 750, error 0.7–1.0e-6, at the 700 W cap with the
// SM clock at 1.37–1.45 GHz (571–598 TFLOP/s, 75–79% of the tensor
// cores' rate at that clock).  Promotion every tile: 11.35–11.40 ms
// (1.2e-6); every 4th: 6% faster (8.85–8.86 ms, 7.7e-7), but at K = 300
// its error reached 4.0e-7 in a card-only test, past 4× the f32
// product's (1.0e-7), where every 2nd stays at 2.0e-7; every 8th, 16th
// and 32nd: 8.74–9.64, 9.19–9.26, 9.09–9.55 ms (7.1e-7, 1.1e-6, 2.3e-6),
// each past that bound on the probe's ragged shapes; never (one
// accumulator): 3.6e-5, over the 1e-5 gate.  2×2 clusters (H multicast
// too; only 30 clusters, 120 SMs, fit at once)
// 9.69–9.73 ms, 9.04–9.22 at every 4th or 8th; 1×2 9.39–9.50; raster
// groups of 4 or 16 row stripes 9.10–9.49; a 128×256 tile run as two
// 64×128 halves in turn (SPLIT = 2, each half waited for and promoted
// into its half of the sum) 10.29–11.15 ms, 9–23% slower than the kept
// variant in the same call, at a higher SM clock (1.41–1.75 GHz: 1.5×
// the waits per FLOP of the kept tile, and m64n128 steps that read A once
// per half); cuBLAS's bf16 GEMM (f32 out) 7.88–7.91 ms at 3.6e-5; the
// replaced design 13.01–13.38 ms.
// The shape is fixed at compile time; probes/bf16_route_design.py builds
// other shapes of this source with -D flags to compare them.
#ifndef RING_HEMM_BF16_BN
#define RING_HEMM_BF16_BN 192      // W tile columns (wgmma N)
#endif
#ifndef RING_HEMM_BF16_CM
#define RING_HEMM_BF16_CM 2        // cluster: CTAs along W's rows (share V)
#endif
#ifndef RING_HEMM_BF16_CN
#define RING_HEMM_BF16_CN 1        // cluster: CTAs along W's columns (share H)
#endif
#ifndef RING_HEMM_BF16_PROMOTE
#define RING_HEMM_BF16_PROMOTE 2   // K tiles per IEEE promotion (0: never)
#endif
#ifndef RING_HEMM_BF16_GROUP
#define RING_HEMM_BF16_GROUP 8     // row stripes per raster group
#endif
#ifndef RING_HEMM_BF16_SPLIT
#define RING_HEMM_BF16_SPLIT 1     // column parts a consumer runs in turn
#endif

namespace bf16r {
constexpr int BM = 128;                  // W tile rows (2 consumers × 64)
constexpr int BK = 64;                   // K tile: 64 bf16 = one 128 B row
constexpr int ALIGN = 8;                 // bf16 elements per 16 bytes
constexpr int BN = RING_HEMM_BF16_BN;
constexpr int CM = RING_HEMM_BF16_CM;
constexpr int CN = RING_HEMM_BF16_CN;
constexpr int PROMOTE = RING_HEMM_BF16_PROMOTE;
constexpr int GROUP_M = RING_HEMM_BF16_GROUP;
// a consumer's 64 × BN tile is computed as SPLIT parts of WN columns in
// turn, each promoted into its slice of the running sum: only one part's
// accumulators are live
constexpr int SPLIT = RING_HEMM_BF16_SPLIT;
constexpr int WN = BN / SPLIT;           // wgmma N
constexpr int NACC = WN / 2;             // accumulator floats per thread
constexpr int NRUN = PROMOTE > 0 ? BN / 2 : 1;   // running-sum floats
constexpr int H_BYTES = BM * 128;        // the H tile: 16 KB
constexpr int V_BYTES = BN * 128;        // the V tile: BN rows of 128 B
constexpr int STAGE_BYTES = H_BYTES + V_BYTES;
constexpr int SMEM_MAX = 232448;         // 227 KB a block can have
constexpr int STAGES = (SMEM_MAX - 1024 - 256) / STAGE_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
// a stage is filled by the CTAs of this CTA's cluster row (H slices) and
// column (V slices): CM + CN - 1 of them, this one included
constexpr int SENDERS = CM + CN - 1;
static_assert(WN == 128 || WN == 192 || WN == 256, "wgmma N");
static_assert(SPLIT == 1 || PROMOTE > 0, "parts need promotion");
static_assert(NACC + NRUN <= 192,
              "acc + run must fit the consumers' 232 registers");
static_assert(CM * CN <= 8 && BM % CN == 0 && BN % (8 * CM) == 0, "cluster");
static_assert(STAGES >= 2, "shared memory");

// TA = 1: A MN-major (the trans route)
template <int N, int TA>
__device__ __forceinline__ void mma(float (&acc)[N / 2], uint64_t da,
                                    uint64_t db, int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_m64n128k16_bf16<TA>(acc, da, db, accumulate);
  else if constexpr (N == 192)
    wgmma_ss_m64n192k16_bf16<TA>(acc, da, db, accumulate);
  else
    wgmma_ss_m64n256k16_bf16<TA>(acc, da, db, accumulate);
}

// the A descriptor of a warpgroup's 64 rows at `a` and the per-k-step
// advance (in 16-byte units): K-major (32 bytes along the row) or, on
// the trans route, MN-major (16 K rows of 128 bytes)
template <int TA>
__device__ __forceinline__ uint64_t a_desc(const void* a) {
  return TA ? desc_mnmajor_sw128(a) : desc_kmajor_sw128(a);
}
__host__ __device__ constexpr int a_step(int ta) { return ta ? 2048 / 16 : 2; }
}  // namespace bf16r

// W (=|+=) H[:, col0:col0+b] · Vb for a bf16 H and the bf16 pre-pass's Vb
// (K-major); one BM × BN W tile per CTA, CM × CN CTAs per cluster.  TA = 1
// is the trans route, W (=|+=) H[col0:col0+b, :]ᴴ · Vb (col0 names H's
// first row): the H tile is two TMA boxes of 64 H rows (K) × 64 columns
// (128 bytes of M, 128-byte swizzle), one per consumer warpgroup, read
// MN-major by the wgmma (its transpose bit; 16-bit A allows it) — the
// same bytes, stages, cluster and promotion as TA = 0, and no `off`.
template <int TA>
__global__ void __launch_bounds__(NTHREADS, 1)
ring_hemm_bf16_kernel(const __grid_constant__ CUtensorMap tmH,
                      const __grid_constant__ CUtensorMap tmV,
                      float* __restrict__ W, long long ldw, int m, int k,
                      int b, int col0, int off, int accumulate) {
  constexpr int BM = bf16r::BM, BK = bf16r::BK, BN = bf16r::BN;
  constexpr int CM = bf16r::CM, CN = bf16r::CN, PROMOTE = bf16r::PROMOTE;
  constexpr int NACC = bf16r::NACC, H_BYTES = bf16r::H_BYTES;
  constexpr int SPLIT = bf16r::SPLIT, WN = bf16r::WN, NRUN = bf16r::NRUN;
  constexpr int V_BYTES = bf16r::V_BYTES, STAGES = bf16r::STAGES;
  constexpr int STAGE_BYTES = bf16r::STAGE_BYTES, SENDERS = bf16r::SENDERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: the H tile (BM rows), then the V tile (BN rows), 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // this CTA's place in its cluster (rank = cn + CN·cm), and the grouped
  // raster over clusters: consecutive clusters walk GROUP_M row stripes of
  // one column tile before the next column tile
  const int cn = CN > 1 ? static_cast<int>(cluster_ctaid_x()) : 0;
  const int cm = CM > 1 ? static_cast<int>(cluster_ctaid_y()) : 0;
  constexpr int GROUP = bf16r::GROUP_M / CM > 0 ? bf16r::GROUP_M / CM : 1;
  const int num_n = gridDim.x / CN, num_m = gridDim.y / CM;
  const int id = (blockIdx.y / CM) * num_n + blockIdx.x / CN;
  const int first_m = id / (GROUP * num_n) * GROUP;
  const int gsize = min(num_m - first_m, GROUP);
  const int in_group = id % (GROUP * num_n);
  const int m0 = ((first_m + in_group % gsize) * CM + cm) * BM;
  const int n0 = ((in_group / gsize) * CN + cn) * BN;
  const int ntiles = (b + off + BK - 1) / BK;
  const int kbase = col0 - off;          // 16-byte-aligned TMA coordinate
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS * SENDERS);
    }
    mbar_init_fence();
  }
  if constexpr (CM * CN > 1) cluster_sync();
  else __syncthreads();

  if (wg == 2) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tmH);
      tma_prefetch_desc(&tmV);
      // masks of the CTAs that share this CTA's H rows (its cluster row)
      // and its V columns (its cluster column)
      uint16_t row_mask = 0, col_mask = 0;
      for (int j = 0; j < CN; ++j)
        row_mask |= static_cast<uint16_t>(1u << (cm * CN + j));
      for (int i = 0; i < CM; ++i)
        col_mask |= static_cast<uint16_t>(1u << (i * CN + cn));
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        // every CTA this one writes into has released stage s
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        const int kc = kbase + t * BK;
        if constexpr (TA) {              // box x: H columns m0 + 64 x ..
          for (int x = CN == 1 ? 0 : cn; x < 2; x += CN) {
            if constexpr (CN == 1)
              tma_load_2d(st + x * (H_BYTES / 2), &tmH, &full[s], m0 + 64 * x,
                          kc);
            else
              tma_load_2d_multicast(st + x * (H_BYTES / 2), &tmH, &full[s],
                                    m0 + 64 * x, kc, row_mask);
          }
        } else if constexpr (CN == 1) {
          tma_load_2d(st, &tmH, &full[s], kc, m0);
        } else {                         // slice cn of the H tile's rows
          tma_load_2d_multicast(st + cn * (H_BYTES / CN), &tmH, &full[s], kc,
                                m0 + cn * (BM / CN), row_mask);
        }
        if constexpr (CM == 1) {
          tma_load_2d(st + H_BYTES, &tmV, &full[s], t * BK, n0);
        } else {                         // slice cm of the V tile's rows
          tma_load_2d_multicast(st + H_BYTES + cm * (V_BYTES / CM), &tmV,
                                &full[s], t * BK, n0 + cm * (BN / CM),
                                col_mask);
        }
      }
      // wait for the last releases, which may come from other CTAs of the
      // cluster, so that none arrives on this CTA's barriers after it exits
      for (int t = ntiles; t < ntiles + STAGES; ++t)
        mbar_wait(&empty[t % STAGES], ((t / STAGES) & 1) ^ 1);
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[NACC], run[NRUN];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NRUN; ++i) run[i] = 0.0f;
    // release tile t's stage: one arrive per warp on the empty barrier of
    // every CTA that wrote into it (lane i takes sender i)
    auto release = [&](int t) {
      __syncwarp();
      if constexpr (SENDERS == 1) {
        if (lane == 0) mbar_arrive(&empty[t % STAGES]);
      } else if (lane < SENDERS) {
        // senders: this CTA's cluster row (cm, 0..CN-1), then the rest of
        // its cluster column (0..CM-1 but cm, cn)
        const int i = lane - CN, row = i < cm ? i : i + 1;
        const int rank = lane < CN ? cm * CN + lane : row * CN + cn;
        mbar_arrive_cluster(&empty[t % STAGES], rank);
      }
    };
    auto promote = [&]() {
      if constexpr (PROMOTE > 0) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) run[i] += acc[i];
      }
    };
    // zero the first tile's `off` columns left of the block (so that a
    // non-finite H entry there cannot leak in as 0·inf); column c < 8 of
    // row r sits in 16-byte chunk 0 ^ (r % 8)
    auto zero_left = [&](unsigned char* st) {
      const int r = wg * 64 + (threadIdx.x % 128) / 2;
      const int half = threadIdx.x % 2;
      uint16_t* row = reinterpret_cast<uint16_t*>(st + r * 128 + (r % 8) * 16);
      for (int c = half; c < off; c += 2) row[c] = 0;
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
    };
    const uint32_t a_off = wg * (H_BYTES / 2);   // this warpgroup's 64 rows
    if constexpr (SPLIT == 1) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const bool fresh = PROMOTE > 0 && t % PROMOTE == 0;
        if (fresh && t > 0) {            // the group before t is complete
          wgmma_wait<0>();
          fence_regs(acc);
          release(t - 1);
          promote();
        }
        mbar_wait(&full[s], (t / STAGES) & 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        if (t == 0 && off > 0) zero_left(st);
        // acc is touched only where no wgmma writing it is in flight (a
        // use under a pending wgmma makes ptxas insert a wait there)
        if (fresh || t == 0) fence_regs(acc);
        wgmma_fence();
        const uint64_t da = bf16r::a_desc<TA>(st + a_off);
        const uint64_t db = desc_kmajor_sw128(st + H_BYTES);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          bf16r::mma<WN, TA>(acc, da + bf16r::a_step(TA) * ks, db + 2 * ks,
                         ks == 0 && (fresh || (PROMOTE == 0 && t == 0)) ? 0
                                                                        : 1);
        wgmma_commit();
        if (!fresh && t > 0) {           // tile t - 1 is complete
          wgmma_wait<1>();
          release(t - 1);
        }
      }
      // unconditional, so that ptxas sees every wgmma retired before the
      // epilogue (with none in flight the wait returns at once)
      wgmma_wait<0>();
      fence_regs(acc);
      if (ntiles > 0) release(ntiles - 1);
      promote();
    } else {
      // per group of PROMOTE K tiles: the SPLIT column parts in turn, each
      // waited for and promoted into its slice of run; then the group's
      // stages are released
      for (int g = 0; g < ntiles; g += PROMOTE) {
        const int gend = min(g + PROMOTE, ntiles);
#pragma unroll
        for (int p = 0; p < SPLIT; ++p) {
          for (int t = g; t < gend; ++t) {
            unsigned char* st = smem + (t % STAGES) * STAGE_BYTES;
            if (p == 0) {
              mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
              if (t == 0 && off > 0) zero_left(st);
            }
            if (t == g) fence_regs(acc);
            wgmma_fence();
            const uint64_t da = bf16r::a_desc<TA>(st + a_off);
            const uint64_t db =
                desc_kmajor_sw128(st + H_BYTES + p * WN * 128);
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              bf16r::mma<WN, TA>(acc, da + bf16r::a_step(TA) * ks,
                                 db + 2 * ks,
                             ks == 0 && t == g ? 0 : 1);
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int i = 0; i < NACC; ++i) run[p * NACC + i] += acc[i];
        }
        for (int t = g; t < gend; ++t) release(t);
      }
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // epilogue: d[4j + 2h + e] is row 16 (warp % 4) + lane/4 + 8h of this
    // warpgroup's 64, column 8j + 2(lane % 4) + e
    const int arow = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int q = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + arow + 8 * h;
      if (r >= m) continue;
      float* wrow = W + (long long)r * ldw;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * j + 2 * q + e;
          float x;
          if constexpr (PROMOTE > 0) x = run[4 * j + 2 * h + e];
          else x = acc[4 * j + 2 * h + e];
          if (c < k) wrow[c] = accumulate ? wrow[c] + x : x;
        }
    }
  }
}

// ---- host side --------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 2-D map of a row-major (rows × cols) array of `type` (unit_bytes
// each) with row stride `ld` units, read in boxes of box_cols × box_rows
// with the given swizzle
CUresult make_map(CUtensorMap* map, CUtensorMapDataType type, int unit_bytes,
                  const void* base, long long cols, long long rows,
                  long long ld, int box_cols, int box_rows,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * unit_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the same for E's element in boxes of BK elements (128 bytes) × box_rows
// with the 128-byte swizzle
template <class E>
CUresult make_map(CUtensorMap* map, const void* base, long long cols,
                  long long rows, long long ld, int box_rows = 128) {
  return make_map(map, E::TMA_TYPE, 128 / E::BK, base, cols, rows, ld, E::BK,
                  box_rows);
}

// the same for bf16 in boxes of 64 columns (128 bytes) × box_rows
CUresult make_map_bf16(CUtensorMap* map, const void* base, long long cols,
                       long long rows, long long ld, int box_rows) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols, rows,
                  ld, bf16r::BK, box_rows);
}

// error codes beside cudaError_t's (which stay below 1000)
constexpr int ERR_NO_ENCODER = 1000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 2000;       // + the CUresult of a failed encode

// W[0:m, 0:k] (=|+=) H[0:m, col0:col0+b] · B, B given as the pre-pass
// output (E::B_TILES planes of w_pad × b_pad) with off = col0 % E::ALIGN;
// on the trans route (TU = 1) W[0:m, 0:k] (=|+=) H[col0:col0+b, 0:m]ᴴ · B
// with off = 0
template <class E, int TU>
int launch(const void* H, long long ldh, int col0, const void* Vt, int b_pad,
           int w_pad, float* W, long long ldw, int m, int k, int b,
           int accumulate, cudaStream_t stream) {
  if (m <= 0 || k <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODER;
  CUtensorMap tmH, tmV;
  CUresult r;
  if constexpr (TU == 0) {
    // exactly H[:m, :col0+b], so TMA zero-fills past the block's last
    // column
    r = make_map<E>(&tmH, H, col0 + b > 0 ? col0 + b : 1, m, ldh);
  } else {
    // exactly H[:col0+b, :m]: TMA zero-fills rows past the slab and
    // columns past m; row0 is TMA's outer coordinate, so no alignment
    const long long rows = col0 + b;
    r = make_map<E>(&tmH, H, m, rows > 0 ? rows : 1, ldh, E::BK);
  }
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  r = make_map<E>(&tmV, Vt, b_pad, (long long)E::B_TILES * w_pad, b_pad);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  // per call: the attribute belongs to the current device's context
  const cudaError_t e = cudaFuncSetAttribute(
      ring_hemm_kernel<E, TU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<E>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(w_pad / BN, (m + BM - 1) / BM);
  ring_hemm_kernel<E, TU><<<grid, NTHREADS, smem_bytes<E>(), stream>>>(
      tmH, tmV, W, ldw, m, k, b, col0, TU == 0 ? col0 % E::ALIGN : 0, w_pad,
      accumulate);
  return static_cast<int>(cudaGetLastError());
}

// W[0:m, 0:k] (=|+=) H[0:m, col0:col0+b] · V on the c64 kernel, V given as
// the c64 pre-pass's six planes (6 × w_pad × b_pad) with off = col0 % 2;
// TU = 1: H[col0:col0+b, 0:m]ᴴ · V with off = 0.  m, k, b and col0 in
// complex elements, ldh and ldw in floats.
template <int TU>
int launch_c64(const void* H, long long ldh, int col0, const void* Vt,
               int b_pad, int w_pad, float* W, long long ldw, int m, int k,
               int b, int accumulate, cudaStream_t stream) {
  constexpr int BK = c64r::BK, BN = c64r::BN, PLANES = c64r::PLANES;
  constexpr int SMEM_BYTES = c64r::SMEM_BYTES;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (m <= 0 || k <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODER;
  CUtensorMap tmH, tmV;
  CUresult r;
  if constexpr (TU == 0) {
    // exactly H[:m, :col0+b] as floats, so TMA zero-fills past the block
    const long long cols = 2LL * (col0 + b);
    r = make_map(&tmH, F32, 4, H, cols > 0 ? cols : 1, m, ldh, 32, BM);
  } else {
    // exactly H[:col0+b, :m] as floats, in boxes of BK rows × 16 complex
    const long long rows = col0 + b;
    r = make_map(&tmH, F32, 4, H, 2LL * m, rows > 0 ? rows : 1, ldh, 32, BK);
  }
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  r = make_map(&tmV, F32, 4, Vt, b_pad, (long long)PLANES * w_pad, b_pad, BK,
               BN, CU_TENSOR_MAP_SWIZZLE_64B);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  const cudaError_t e = cudaFuncSetAttribute(
      ring_hemm_kernel_c64<TU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(w_pad / BN, (m + BM - 1) / BM);
  ring_hemm_kernel_c64<TU><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      tmH, tmV, W, ldw, m, k, b, col0, TU == 0 ? col0 % c64r::ALIGN : 0,
      w_pad, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// W[0:m, 0:k] (=|+=) H[0:m, col0:col0+b] · Vb on the bf16 kernel (TA = 1:
// H[col0:col0+b, 0:m]ᴴ · Vb): grid rows and columns rounded up to whole
// clusters (the extra CTAs read TMA's zero fill and store nothing)
template <int TA>
int launch_bf16(const uint16_t* H, long long ldh, int col0, const uint16_t* Vb,
                int b_pad, int w_pad, float* W, long long ldw, int m, int k,
                int b, int accumulate, cudaStream_t stream) {
  constexpr int BM = bf16r::BM, BN = bf16r::BN, CM = bf16r::CM;
  constexpr int CN = bf16r::CN, SMEM_BYTES = bf16r::SMEM_BYTES;
  if (m <= 0 || k <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODER;
  CUtensorMap tmH, tmV;
  CUresult r;
  if constexpr (TA) {
    // exactly H[:col0+b, :m] in boxes of 64 rows × 64 columns
    r = make_map_bf16(&tmH, H, m, col0 + b > 0 ? col0 + b : 1, ldh,
                      bf16r::BK);
  } else {
    // exactly H[:m, :col0+b], so TMA zero-fills past the block's last
    // column; each CTA loads its slice of the tiles its cluster shares
    r = make_map_bf16(&tmH, H, col0 + b > 0 ? col0 + b : 1, m, ldh, BM / CN);
  }
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  r = make_map_bf16(&tmV, Vb, b_pad, w_pad, b_pad, BN / CM);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  cudaError_t e = cudaFuncSetAttribute(
      ring_hemm_bf16_kernel<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gx = (k + BN - 1) / BN, gy = (m + BM - 1) / BM;
  const dim3 grid((gx + CN - 1) / CN * CN, (gy + CM - 1) / CM * CM);
  const int off = TA ? 0 : col0 % bf16r::ALIGN;
  if constexpr (CM * CN == 1) {
    ring_hemm_bf16_kernel<TA><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
        tmH, tmV, W, ldw, m, k, b, col0, off, accumulate);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CN;
    attr[0].val.clusterDim.y = CM;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int off_arg = off;
    void* args[] = {&tmH, &tmV, &W, &ldw, &m, &k, &b, &col0, &off_arg,
                    &accumulate};
    e = cudaLaunchKernelExC(
        &cfg, reinterpret_cast<const void*>(ring_hemm_bf16_kernel<TA>), args);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The pre-pass alone: Vt (2 × w_pad × b_pad, contiguous) from V (b × k,
// row stride ldv), V's row j at Vt column off + j.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int ring_hemm_split_f32(const float* V, long long ldv, float* Vt,
                                   int b, int k, int off, int b_pad,
                                   int w_pad, cudaStream_t stream) {
  if (b_pad <= 0 || w_pad <= 0) return 0;
  const dim3 grid(b_pad / 32, w_pad / 32);
  split_transpose_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      V, ldv, Vt, b, k, off, b_pad, w_pad);
  return static_cast<int>(cudaGetLastError());
}

// The c64 pre-pass: Vt (6 × w_pad × b_pad, contiguous) — Vr, Vd = fl(Vi −
// Vr) and Vs = fl(Vr + Vi), each TF32 hi then lo, K-major — from a c64 V
// (b × k, row stride ldv complex elements), V's row j at Vt column off + j
// (off = col0 % 2).  b_pad a multiple of 16 of at least b + off, w_pad a
// multiple of 64 of at least k.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ring_hemm_split_c64(const float* V, long long ldv, float* Vt,
                                   int b, int k, int off, int b_pad,
                                   int w_pad, cudaStream_t stream) {
  if (b_pad <= 0 || w_pad <= 0) return 0;
  const dim3 grid((b_pad + 31) / 32, w_pad / 32);
  split_c64_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      V, 2 * ldv, Vt, b, k, off, b_pad, w_pad, 0);
  return static_cast<int>(cudaGetLastError());
}

// The same of conj(V) (Vi = −Im V): the trans route's B
// (ring_hemm_c64_t); arguments as ring_hemm_split_c64's.
extern "C" int ring_hemm_split_c64_conj(const float* V, long long ldv,
                                        float* Vt, int b, int k, int off,
                                        int b_pad, int w_pad,
                                        cudaStream_t stream) {
  if (b_pad <= 0 || w_pad <= 0) return 0;
  const dim3 grid((b_pad + 31) / 32, w_pad / 32);
  split_c64_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      V, 2 * ldv, Vt, b, k, off, b_pad, w_pad, 1);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 pre-pass: Vb (w_pad × b_pad bf16, contiguous) from V (b × k
// f32, row stride ldv), V's row j rounded to bf16 at Vb column off + j.
// b_pad a multiple of 64, w_pad >= k of 32 (the wrapper rounds k up to the
// bf16 kernel's 192-column tile).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ring_hemm_pack_bf16(const float* V, long long ldv,
                                   uint16_t* Vb, int b, int k, int off,
                                   int b_pad, int w_pad,
                                   cudaStream_t stream) {
  if (b_pad <= 0 || w_pad <= 0) return 0;
  const dim3 grid(b_pad / 32, w_pad / 32);
  bf16_pack_kernel<<<grid, dim3(32, 8), 0, stream>>>(V, ldv, Vb, b, k, off,
                                                     b_pad);
  return static_cast<int>(cudaGetLastError());
}

// W[0:m, 0:k] (=|+=) H[0:m, col0:col0+b] · V with V given as the pre-pass
// output Vt with off = col0 % 4 (2 × w_pad × b_pad, w_pad = 128·⌈k/128⌉,
// b_pad = 32·⌈(b + off)/32⌉, at least 32 also for b = 0).
// H: row-major with row stride ldh floats, 16-byte aligned, ldh % 4 == 0;
// W: row stride ldw, unit column stride.  Launches on `stream`, never
// synchronizes; returns 0, a cudaError_t, or ERR_* above.
extern "C" int ring_hemm_f32(const float* H, long long ldh, int col0,
                             const float* Vt, int b_pad, int w_pad, float* W,
                             long long ldw, int m, int k, int b,
                             int accumulate, cudaStream_t stream) {
  return launch<Tf32x3, 0>(H, ldh, col0, Vt, b_pad, w_pad, W, ldw, m, k, b,
                           accumulate, stream);
}

// The trans route: W[0:m, 0:k] (=|+=) H[row0:row0+b, 0:m]ᴴ · V, one ring_B
// step of the 2-D ring (K = b runs along H's rows), with V given as the
// pre-pass output Vt with off = 0.  H: row stride ldh floats, 16-byte
// aligned, ldh % 4 == 0; row0 any row (TMA's outer coordinate).
// Otherwise as ring_hemm_f32.
extern "C" int ring_hemm_f32_t(const float* H, long long ldh, int row0,
                               const float* Vt, int b_pad, int w_pad, float* W,
                               long long ldw, int m, int k, int b,
                               int accumulate, cudaStream_t stream) {
  return launch<Tf32x3, 1>(H, ldh, row0, Vt, b_pad, w_pad, W, ldw, m, k, b,
                           accumulate, stream);
}

// The c64 route: W[0:m, 0:k] (=|+=) H[0:m, col0:col0+b] · V for c64 H, V
// and W, V given as ring_hemm_split_c64's output with off = col0 % 2, on
// ring_hemm_kernel_c64 (three real products, 3M).  m, k, b and col0
// in complex elements; H's row stride ldh in floats, 16-byte aligned, ldh
// % 4 == 0; W's row stride ldw in floats, unit column stride.  Otherwise
// as ring_hemm_f32.
extern "C" int ring_hemm_c64(const float* H, long long ldh, int col0,
                             const float* Vt, int b_pad, int w_pad, float* W,
                             long long ldw, int m, int k, int b,
                             int accumulate, cudaStream_t stream) {
  return launch_c64<0>(H, ldh, col0, Vt, b_pad, w_pad, W, ldw, m, k, b,
                       accumulate, stream);
}

// Its trans route: W[0:m, 0:k] (=|+=) H[row0:row0+b, 0:m]ᴴ · V with V
// given as ring_hemm_split_c64_conj's output (off = 0); row0 any row.
// Otherwise as ring_hemm_c64.
extern "C" int ring_hemm_c64_t(const float* H, long long ldh, int row0,
                               const float* Vt, int b_pad, int w_pad, float* W,
                               long long ldw, int m, int k, int b,
                               int accumulate, cudaStream_t stream) {
  return launch_c64<1>(H, ldh, row0, Vt, b_pad, w_pad, W, ldw, m, k, b,
                       accumulate, stream);
}

// The bf16 route: W (f32) (=|+=) H[0:m, col0:col0+b] (bf16) · V with V
// given as the bf16 pre-pass output Vb with off = col0 % 8 (w_pad × b_pad,
// w_pad >= k — rows past it read as zeros —, b_pad = 64·⌈(b + off)/64⌉,
// at least 64), on ring_hemm_bf16_kernel.  H: row stride ldh bf16
// elements, 16-byte aligned, ldh % 8 == 0.  Otherwise as ring_hemm_f32.
extern "C" int ring_hemm_bf16(const uint16_t* H, long long ldh, int col0,
                              const uint16_t* Vb, int b_pad, int w_pad,
                              float* W, long long ldw, int m, int k, int b,
                              int accumulate, cudaStream_t stream) {
  return launch_bf16<0>(H, ldh, col0, Vb, b_pad, w_pad, W, ldw, m, k, b,
                        accumulate, stream);
}

// The bf16 route's trans form: W (f32) (=|+=) H[row0:row0+b, 0:m]ᴴ (bf16)
// · V with V given as the bf16 pre-pass output Vb with off = 0; row0 any
// row.  Otherwise as ring_hemm_bf16.
extern "C" int ring_hemm_bf16_t(const uint16_t* H, long long ldh, int row0,
                                const uint16_t* Vb, int b_pad, int w_pad,
                                float* W, long long ldw, int m, int k, int b,
                                int accumulate, cudaStream_t stream) {
  return launch_bf16<1>(H, ldh, row0, Vb, b_pad, w_pad, W, ldw, m, k, b,
                        accumulate, stream);
}
