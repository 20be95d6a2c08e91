// ring_hemm — the Chebyshev filter's HEMM, W (=|+=) H[:, col0:col0+b] · V,
// hand-written in CUDA C++ for Hopper (sm_90a): TMA loads into an mbarrier
// pipeline feeding register-A wgmma, with 3xTF32 for f32 accuracy.
//
// Replaces the TPU kernel chase_tpu/ops/pallas_ring.py::_ring_kernel
// (built by make_hemm_local, run by parallel/ring.py::
// chebyshev_filter_ring_pallas).  That kernel computes one device's rows of
// W = H·V on a 1D ring of p devices: at ring step s it multiplies the H
// column block of the V chunk it holds and passes the chunk on; step 0
// stores, later steps add.  This kernel is one such step: `accumulate = 0`
// is the TPU kernel's s == 0 store, `accumulate = 1` its s > 0 add, so the
// multi-GPU ring can feed NCCL-received chunks into the same kernel.  On
// one card (p = 1) a filter step is one call with accumulate = 0, K = N.
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
// Error scheme (measured by a probe on the H100 before this kernel was
// written; PERF.md): x = hi + lo with hi = tf32_rna(x), lo = tf32_rna(x -
// hi), and H·V ≈ lo·Vhi + hi·Vlo + hi·Vhi, small terms first (lo·Vlo, at
// 2^-22 relative, is dropped).  The wgmma accumulator's adder is not IEEE
// round-to-nearest: one accumulator over K = 30000 drifted to 2.1e-4
// relative, 63× cuBLAS.  So each K tile (32 deep, 12 wgmma) sums into a
// fresh accumulator that is then added, in IEEE f32, to a running sum in
// registers (1.6e-6 at K = 30000, ≤ 1.14× cuBLAS at every probed shape;
// every 4th tile failed the 4×-plain bound at K = 200).  Promoting every
// 2nd tile held the bound (2.6× cuBLAS at worst) but ran 5.5% slower at
// (30000, 3000) and 2.4% at (30000, 750) in this kernel (PERF.md).
//
// Design:
//   * split_transpose_kernel (pre-pass): V (b × k, row stride ldv, N-major)
//     → Vt = [hi; lo], each (w_pad × b_pad), K-major and zero-padded.
//     wgmma takes 32-bit B operands only K-major from shared memory (there
//     is no transposed form for tf32), and V is N-major.
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
//   * the main kernel, one 128×128 W tile per block, 384 threads:
//       - warpgroup 2 (one elected thread) is the producer: TMA loads of
//         the f32 H tile (128 rows × 32 K, 128-byte swizzle) and the Vhi /
//         Vlo tiles (128 columns × 32 K each) into a 4-stage ring of 48 KB
//         stages, guarded by full/empty mbarriers; setmaxnreg gives its
//         registers to the consumers (40 / 232);
//       - warpgroups 0 and 1 are consumers, 64 rows each: per K tile they
//         read their A fragments (f32) from the swizzled H tile, split them
//         into hi/lo in registers and issue 12 wgmma m64n128k8 with A from
//         registers — H is split in registers rather than in shared memory,
//         so the H tile stays one f32 TMA load and costs no extra shared
//         memory, barrier or copy; then they wait, release the stage and
//         promote the tile's sum.  The next tile's fragments are read and
//         split while this tile's wgmma run (two register sets), and two
//         consumers keep the tensor cores busy while the other promotes;
//   * grouped raster (GROUP_M = 8 row stripes per group), so the blocks
//     resident at once share H stripes and V tiles in L2.  Measured on the
//     H100 against one block row per column sweep: the pipelined fragments
//     and the grouped raster together took (30000, 3000) from 77.4 to
//     60.0 ms in one call, the same ~+27% at widths 750 and 2250 (PERF.md).
//   * ragged edges: the H descriptor is exactly H[:m, :col0+b] (col0 is a
//     TMA coordinate, not a pointer offset), so TMA zero-fills rows past m
//     and columns past col0+b.  TMA's inner coordinate must be 16-byte
//     aligned, so the boxes start at col0 - off, off = col0 % 4: the
//     pre-pass shifts V's rows by `off` columns of Vt (zeros before them)
//     and the consumers zero the first tile's `off` leading A columns
//     (so a non-finite H entry left of the block cannot leak in as
//     0·inf).  Vt is zero-padded by the pre-pass; the
//     epilogue stores (or adds into) W with masked plain stores, so W may
//     be a strided column window and nothing outside [0,m)×[0,k) is
//     touched.  TMA needs H 16-byte aligned with a row stride that is a
//     multiple of 4 floats (the wrapper checks; DenseOperator pads).
//   * the one driver-API call, cuTensorMapEncodeTiled, is reached through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Shared memory per block: 4 stages × (16 + 16 + 16) KB = 192 KB of
// dynamic shared memory (plus 1 KB for alignment and 64 B of barriers).
// Registers: 168 at launch; setmaxnreg moves the producer to 40 and the
// consumers to 232 (2 × 64 accumulators + 2 × 32 fragments), no spills.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tf32.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                  // W tile rows (2 consumers × 64)
constexpr int BN = 128;                  // W tile columns (wgmma N)
constexpr int BK = 32;                   // K tile: 32 f32 = one 128 B row
constexpr int STAGES = 4;
constexpr int GROUP_M = 8;               // row stripes per raster group
constexpr int TILE_FLOATS = BM * BK;     // 4096 floats = 16 KB
constexpr int STAGE_BYTES = 3 * TILE_FLOATS * 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;

// ---- pre-pass: split and transpose the V chunk ----------------------------
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

// ---- main kernel ------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS, 1)
ring_hemm_tf32x3_kernel(const __grid_constant__ CUtensorMap tmH,
                        const __grid_constant__ CUtensorMap tmV,
                        float* __restrict__ W, long long ldw, int m, int k,
                        int b, int col0, int off, int w_pad,
                        int accumulate) {
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: H tile, Vhi tile, Vlo tile, each TILE_FLOATS, 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * 3 * TILE_FLOATS);
  uint64_t* empty = full + STAGES;

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
  const int ntiles = (b + off + BK - 1) / BK;
  const int kbase = col0 - off;          // 16-byte-aligned TMA coordinate
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
        float* st = smem + s * 3 * TILE_FLOATS;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &tmH, &full[s], kbase + t * BK, m0);
        tma_load_2d(st + TILE_FLOATS, &tmV, &full[s], t * BK, n0);
        tma_load_2d(st + 2 * TILE_FLOATS, &tmV, &full[s], t * BK, w_pad + n0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float run[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = acc[i] = 0.0f;
    // A fragment element (v, ks): row 16 w + l/4 + 8 (v & 1) of this
    // warpgroup's 64, column 8 ks + l%4 + 4 (v >> 1) of the tile; in the
    // swizzled tile the column's 16-byte chunk 2 ks + (v >> 1) sits at
    // chunk (2 ks + (v >> 1)) ^ (row % 8), and row % 8 = l/4.
    const int arow = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int q = lane % 4, r8 = lane / 4;
    // tile t's A fragments: wait for its stage, read, split into hi/lo
    auto load_a = [&](int t, uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4]) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const float* Ht = smem + s * 3 * TILE_FLOATS;
      const int kmin = t == 0 ? off : 0;     // columns left of the block
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = arow + 8 * (v & 1);
          const int chunk = (2 * ks + (v >> 1)) ^ r8;
          const float x = Ht[r * BK + chunk * 4 + q];
          split_tf32(8 * ks + 4 * (v >> 1) + q >= kmin ? x : 0.0f,
                     ahi[ks][v], alo[ks][v]);
        }
    };
    // issue tile t's 12 wgmma into a fresh accumulator, small terms first
    auto mma = [&](int t, uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4]) {
      const float* Ht = smem + (t % STAGES) * 3 * TILE_FLOATS;
      const uint64_t dh = desc_kmajor_sw128(Ht + TILE_FLOATS);
      const uint64_t dl = desc_kmajor_sw128(Ht + 2 * TILE_FLOATS);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_m64n128k8_tf32(acc, alo[ks], dh + 2 * ks, ks == 0 ? 0 : 1);
        wgmma_m64n128k8_tf32(acc, ahi[ks], dl + 2 * ks, 1);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n128k8_tf32(acc, ahi[ks], dh + 2 * ks, 1);
      wgmma_commit();
    };
    // wait for tile t's wgmma, release its stage, promote its sum (IEEE)
    auto finish = [&](int t, uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4]) {
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ahi);
      fence_regs(alo);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] += acc[i];
    };
    // two register sets: tile t + 1's fragments are read and split while
    // tile t's wgmma run (unrolled by two so each set has fixed registers)
    uint32_t a0h[4][4], a0l[4][4], a1h[4][4], a1l[4][4];
    if (ntiles > 0) load_a(0, a0h, a0l);
    for (int t = 0; t < ntiles; t += 2) {
      mma(t, a0h, a0l);
      if (t + 1 < ntiles) load_a(t + 1, a1h, a1l);
      finish(t, a0h, a0l);
      if (t + 1 < ntiles) {
        mma(t + 1, a1h, a1l);
        if (t + 2 < ntiles) load_a(t + 2, a0h, a0l);
        finish(t + 1, a1h, a1l);
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

// a 2-D f32 map of a row-major (rows × cols) array with row stride `ld`
// floats, read in (32 × 128) boxes with the 128-byte swizzle
CUresult make_map(CUtensorMap* map, const float* base, long long cols,
                  long long rows, long long ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// error codes beside cudaError_t's (which stay below 1000)
constexpr int ERR_NO_ENCODER = 1000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 2000;       // + the CUresult of a failed encode

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
  if (m <= 0 || k <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODER;
  CUtensorMap tmH, tmV;
  // exactly H[:m, :col0+b], so TMA zero-fills past the block's last column
  CUresult r = make_map(&tmH, H, col0 + b > 0 ? col0 + b : 1, m, ldh);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  r = make_map(&tmV, Vt, b_pad, 2LL * w_pad, b_pad);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  // per call: the attribute belongs to the current device's context
  const cudaError_t e = cudaFuncSetAttribute(
      ring_hemm_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(w_pad / BN, (m + BM - 1) / BM);
  ring_hemm_tf32x3_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      tmH, tmV, W, ldw, m, k, b, col0, col0 % 4, w_pad, accumulate);
  return static_cast<int>(cudaGetLastError());
}
