// ring_hemm — the Chebyshev filter's HEMM, W (=|+=) H[:, col0:col0+b] · V,
// hand-written in CUDA C++ for Hopper (sm_90a): TMA loads into an mbarrier
// pipeline feeding register-A wgmma, with 3xTF32 for f32 accuracy, and a
// bf16 route (bf16 H, f32 V rounded to bf16, f32 sums) for the bf16 rung.
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
// The bf16 route does one bf16 product per term at the 989 TFLOP/s dense
// bf16 rate: at (30000, 3000) its bound is 5.46 ms of arithmetic (H is 1.8
// GB, 0.54 ms of HBM); its per-tile promotion and 64-deep tiles make it a
// simple first version, not a tuned one (its times are in PERF.md).
//
// Error scheme of the f32 route (measured by a probe on the H100 before
// this kernel was written; PERF.md): x = hi + lo with hi = tf32_rna(x), lo
// = tf32_rna(x - hi), and H·V ≈ lo·Vhi + hi·Vlo + hi·Vhi, small terms
// first (lo·Vlo, at 2^-22 relative, is dropped).  The wgmma accumulator's
// adder is not IEEE round-to-nearest: one accumulator over K = 30000
// drifted to 2.1e-4 relative, 63× cuBLAS.  So each K tile (32 deep, 12
// wgmma) sums into a fresh accumulator that is then added, in IEEE f32, to
// a running sum in registers (1.6e-6 at K = 30000, ≤ 1.14× cuBLAS at every
// probed shape; every 4th tile failed the 4×-plain bound at K = 200).
// Promoting every 2nd tile held the bound (2.6× cuBLAS at worst) but ran
// 5.5% slower at (30000, 3000) and 2.4% at (30000, 750) in this kernel
// (PERF.md).  The bf16 route's products are exact in f32 (8-bit
// mantissas), so its only error beyond V's rounding to bf16 is the sum:
// it promotes each 64-deep tile the same way (the probe that measured the
// alternative is in PERF.md).
//
// Design:
//   * split_transpose_kernel (f32 pre-pass): V (b × k, row stride ldv,
//     N-major) → Vt = [hi; lo], each (w_pad × b_pad), K-major and
//     zero-padded.  wgmma takes 32-bit B operands only K-major from shared
//     memory (there is no transposed form for tf32), and V is N-major.
//   * bf16_pack_kernel (bf16 pre-pass): V (b × k, f32) → Vb (w_pad ×
//     b_pad) bf16, V rounded to nearest-even (as torch's .to(bfloat16)),
//     transposed to K-major like the f32 route's B (wgmma could read a
//     transposed 16-bit B, but one layout keeps one pipeline).
//   * complex64 (ring_hemm_split_c64): the main kernel is the f32 one, run
//     on the float view of a c64 H (m × 2n floats, [re, im, ...] rows).
//     The complex pre-pass writes, for a c64 V (b × k), the real (2b × 2k)
//     B with row 2j = V[j] and row 2j+1 = i·V[j], both viewed as floats;
//     then Hf·B, over K = 2b from float column 2·col0, is H·V viewed as
//     floats.  That is 8·m·b·k FLOPs, those of a complex product, where
//     the JAX package's real-pair embedding (a 2N real problem) spends
//     16·m·b·k.  Everything of the main kernel (masking, ragged edges,
//     TMA alignment, strided W) carries over: the wrapper passes float
//     strides and columns.  K doubles, and the per-tile promotion below
//     keeps its error at f32's (the chip gate holds it to a c128 product).
//   * the main kernel, ring_hemm_kernel<E> for E = Tf32x3 (f32, c64) or
//     Bf16, one 128×128 W tile per block, 384 threads:
//       - warpgroup 2 (one elected thread) is the producer: TMA loads of
//         the H tile (128 rows × 128 bytes: 32 f32 or 64 bf16 of K,
//         128-byte swizzle) and the B tiles (128 columns × the same K:
//         Vhi and Vlo for f32, Vb for bf16) into a ring of E::STAGES
//         stages, guarded by full/empty mbarriers; setmaxnreg gives its
//         registers to the consumers (40 / 232);
//       - warpgroups 0 and 1 are consumers, 64 rows each: per K tile they
//         read their A fragments from the swizzled H tile into registers
//         (f32: split into hi/lo there, so the H tile stays one f32 TMA
//         load and costs no extra shared memory, barrier or copy; bf16:
//         the words as they are) and issue the tile's wgmma with A from
//         registers (f32: 12 m64n128k8, bf16: 4 m64n128k16); then they
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
//     aligned, so the boxes start at col0 - off, off = col0 % E::ALIGN (4
//     f32 or 8 bf16): the pre-pass shifts V's rows by `off` columns of its
//     output (zeros before them) and the consumers zero the first tile's
//     `off` leading A columns (so a non-finite H entry left of the block
//     cannot leak in as 0·inf).  The pre-pass output is zero-padded; the
//     epilogue stores (or adds into) W with masked plain stores, so W may
//     be a strided column window and nothing outside [0,m)×[0,k) is
//     touched.  TMA needs H 16-byte aligned with a row stride of a whole
//     number of 16 bytes (4 floats, 8 bf16; the wrapper checks,
//     DenseOperator pads).
//   * the one driver-API call, cuTensorMapEncodeTiled, is reached through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Shared memory per block: f32 4 stages × (16 + 16 + 16) KB = 192 KB, bf16
// 6 stages × (16 + 16) KB = 192 KB of dynamic shared memory (plus 1 KB for
// alignment and the barriers).  Registers: 168 at launch; setmaxnreg
// moves the producer to 40 and the consumers to 232 (2 × 64 accumulators
// + 2 sets of A fragments: 2 × 32 registers for f32, 2 × 16 for bf16).

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

// ---- the two routes ---------------------------------------------------------
// Each K tile is 128 bytes of a row: BK elements.  A fragment register v
// of k-step ks holds the 32-bit word q = lane % 4 of the row's 16-byte
// chunk 2 ks + (v >> 1) (hopper_tf32.cuh); `col` is the tile column of the
// word's first element.

// f32 (and c64 through its float view): 3xTF32
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

// bf16 H, V rounded to bf16 by the pre-pass: one exact product per term
struct Bf16 {
  static constexpr int BK = 64;              // K tile: 64 bf16 = one 128 B row
  static constexpr int ALIGN = 8;
  static constexpr int B_TILES = 1;
  static constexpr int STAGES = 6;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  struct Frag { uint32_t a[4][4]; };

  // the word holds columns col (low half) and col + 1 (high half); a
  // column left of the block (col < kmin) is zeroed
  __device__ static void set(Frag& f, int ks, int v, uint32_t word, int q,
                             int kmin) {
    const int col = 16 * ks + 8 * (v >> 1) + 2 * q;
    f.a[ks][v] = col >= kmin ? word
                             : (col + 1 >= kmin ? word & 0xFFFF0000u : 0u);
  }
  __device__ static void mma(float (&acc)[64], Frag& f, const void* b) {
    const uint64_t db = desc_kmajor_sw128(b);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n128k16_bf16(acc, f.a[ks], db + 2 * ks, ks == 0 ? 0 : 1);
  }
  __device__ static void fence(Frag& f) { fence_regs(f.a); }
};

template <class E>
__host__ __device__ constexpr int stage_bytes() {
  return (1 + E::B_TILES) * TILE_BYTES;
}

template <class E>
__host__ __device__ constexpr int smem_bytes() {
  return E::STAGES * stage_bytes<E>() + 1024 + 2 * E::STAGES * 8;
}

// ---- f32 pre-pass: split and transpose the V chunk --------------------------
// Vt[0][n][off + j] = hi(B[j][n]), Vt[1][n][off + j] = lo(B[j][n]) for
// j < b, n < k; zero elsewhere in (w_pad × b_pad).  32×32 tiles through shared memory so
// both the read (along n) and the write (along kk) are coalesced.
//
// CPLX = false: B = V, f32 (b × k, row stride ldv).
// CPLX = true: V is the float view of a c64 chunk (b/2 complex rows, row
// stride ldv floats, k = 2·columns floats) and B is the real (b × k)
// matrix that makes the f32 product Hf·B, with Hf the float view of a c64
// H, equal H·V viewed as floats: row 2i of B is V[i] viewed as floats
// (re, im, ...), row 2i+1 is i·V[i] viewed as floats (-im, re, ...).
// TF32 rounding is symmetric in sign, so the negated entries split
// exactly as their plain version's.
template <bool CPLX>
__global__ void __launch_bounds__(256)
split_transpose_kernel(const float* __restrict__ V, long long ldv,
                       float* __restrict__ Vt, int b, int k, int off,
                       int b_pad, int w_pad) {
  __shared__ float tile[32][33];
  const int kk0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int j = kk0 + i - off, n = n0 + tx;
    float x = 0.0f;
    if (j >= 0 && j < b && n < k) {
      if (CPLX) {
        const bool odd = j & 1;                  // an i·V row
        x = V[(long long)(j >> 1) * ldv + (odd ? n ^ 1 : n)];
        if (odd && !(n & 1)) x = -x;
      } else {
        x = V[(long long)j * ldv + n];
      }
    }
    tile[i][tx] = x;
  }
  __syncthreads();
  const long long plane = (long long)w_pad * b_pad;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    uint32_t hi, lo;
    split_tf32(tile[tx][i], hi, lo);
    const long long o = (long long)(n0 + i) * b_pad + kk0 + tx;
    Vt[o] = __uint_as_float(hi);
    Vt[plane + o] = __uint_as_float(lo);
  }
}

// f32 → bf16 bits, round to nearest even; NaN → 0x7FC0.  Bit for bit what
// torch's .to(torch.bfloat16) does (c10::BFloat16's round_to_nearest_even).
__device__ __forceinline__ uint16_t bf16_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// ---- bf16 pre-pass: round and transpose the V chunk --------------------------
// Vb[n][off + j] = bf16(V[j][n]) for j < b, n < k; zero elsewhere in
// (w_pad × b_pad).  The same 32×32 shared-memory transpose as the f32
// pre-pass.
__global__ void __launch_bounds__(256)
bf16_pack_kernel(const float* __restrict__ V, long long ldv,
                 uint16_t* __restrict__ Vb, int b, int k, int off,
                 int b_pad) {
  __shared__ float tile[32][33];
  const int kk0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int j = kk0 + i - off, n = n0 + tx;
    tile[i][tx] = (j >= 0 && j < b && n < k) ? V[(long long)j * ldv + n]
                                             : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8)
    Vb[(long long)(n0 + i) * b_pad + kk0 + tx] = bf16_rne(tile[tx][i]);
}

// ---- main kernel ------------------------------------------------------------
template <class E>
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
        tma_load_2d(st, &tmH, &full[s], kbase + t * E::BK, m0);
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
          const int r = arow + 8 * (v & 1);
          const int chunk = (2 * ks + (v >> 1)) ^ r8;
          E::set(f, ks, v, Ht[r * 32 + chunk * 4 + q], q, kmin);
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + arow + 8 * h;
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

// a 2-D map of a row-major (rows × cols) array of E's element with row
// stride `ld` elements, read in (BK × 128) boxes (128 bytes × 128 rows)
// with the 128-byte swizzle
template <class E>
CUresult make_map(CUtensorMap* map, const void* base, long long cols,
                  long long rows, long long ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (128 / E::BK)};
  const cuuint32_t box[2] = {E::BK, 128};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled()(map, E::TMA_TYPE, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// error codes beside cudaError_t's (which stay below 1000)
constexpr int ERR_NO_ENCODER = 1000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 2000;       // + the CUresult of a failed encode

// W[0:m, 0:k] (=|+=) H[0:m, col0:col0+b] · B, B given as the pre-pass
// output (E::B_TILES planes of w_pad × b_pad) with off = col0 % E::ALIGN
template <class E>
int launch(const void* H, long long ldh, int col0, const void* Vt, int b_pad,
           int w_pad, float* W, long long ldw, int m, int k, int b,
           int accumulate, cudaStream_t stream) {
  if (m <= 0 || k <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODER;
  CUtensorMap tmH, tmV;
  // exactly H[:m, :col0+b], so TMA zero-fills past the block's last column
  CUresult r = make_map<E>(&tmH, H, col0 + b > 0 ? col0 + b : 1, m, ldh);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  r = make_map<E>(&tmV, Vt, b_pad, (long long)E::B_TILES * w_pad, b_pad);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  // per call: the attribute belongs to the current device's context
  const cudaError_t e = cudaFuncSetAttribute(
      ring_hemm_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<E>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(w_pad / BN, (m + BM - 1) / BM);
  ring_hemm_kernel<E><<<grid, NTHREADS, smem_bytes<E>(), stream>>>(
      tmH, tmV, W, ldw, m, k, b, col0, col0 % E::ALIGN, w_pad, accumulate);
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
  split_transpose_kernel<false><<<grid, dim3(32, 8), 0, stream>>>(
      V, ldv, Vt, b, k, off, b_pad, w_pad);
  return static_cast<int>(cudaGetLastError());
}

// The complex pre-pass: Vt (2 × w_pad × b_pad) of the real (2b × 2k)
// matrix B of a c64 V (b × k, row stride ldv complex elements; see
// split_transpose_kernel), B's row r at Vt column off + r, so that
// ring_hemm_f32 on the float view of a c64 H (row stride 2·ldh floats,
// column 2·col0, K = 2b, width 2k) writes H[:, col0:col0+b]·V as floats.
// w_pad >= 2k and b_pad >= 2b + off.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ring_hemm_split_c64(const float* V, long long ldv, float* Vt,
                                   int b, int k, int off, int b_pad,
                                   int w_pad, cudaStream_t stream) {
  if (b_pad <= 0 || w_pad <= 0) return 0;
  const dim3 grid(b_pad / 32, w_pad / 32);
  split_transpose_kernel<true><<<grid, dim3(32, 8), 0, stream>>>(
      V, 2 * ldv, Vt, 2 * b, 2 * k, off, b_pad, w_pad);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 pre-pass: Vb (w_pad × b_pad bf16, contiguous) from V (b × k
// f32, row stride ldv), V's row j rounded to bf16 at Vb column off + j.
// b_pad a multiple of 64, w_pad of 128.  Launches on `stream`; returns
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
  return launch<Tf32x3>(H, ldh, col0, Vt, b_pad, w_pad, W, ldw, m, k, b,
                        accumulate, stream);
}

// The bf16 route: W (f32) (=|+=) H[0:m, col0:col0+b] (bf16) · V with V
// given as the bf16 pre-pass output Vb with off = col0 % 8 (w_pad × b_pad,
// w_pad = 128·⌈k/128⌉, b_pad = 64·⌈(b + off)/64⌉, at least 64).  H: row
// stride ldh bf16 elements, 16-byte aligned, ldh % 8 == 0.  Otherwise as
// ring_hemm_f32.
extern "C" int ring_hemm_bf16(const uint16_t* H, long long ldh, int col0,
                              const uint16_t* Vb, int b_pad, int w_pad,
                              float* W, long long ldw, int m, int k, int b,
                              int accumulate, cudaStream_t stream) {
  return launch<Bf16>(H, ldh, col0, Vb, b_pad, w_pad, W, ldw, m, k, b,
                      accumulate, stream);
}
