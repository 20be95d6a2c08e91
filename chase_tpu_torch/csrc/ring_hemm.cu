// ring_hemm — the Chebyshev filter's HEMM, W (=|+=) H[:, col0:col0+b] · V,
// hand-written in CUDA C++ for Hopper (sm_90a).
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
// What bounds it on an H100: at the solver's shapes (K = N = 30000, width
// k <= 3000) one call is 2·N²·k = 5.4 TFLOP against 3.6 GB of H — about
// 1,500 FLOP per byte of H, so the product is compute-bound on the
// non-tensor f32 pipe (published 67 TFLOP/s at 700 W), not bound by the H
// read (3.35 TB/s: ~1 ms).  The blocks of one 128-row H stripe are
// adjacent in launch order (blockIdx.x is the fast index), so a stripe is
// meant to come from HBM about once and be reused from L2.  Arithmetic is
// IEEE f32 FFMA, not TF32: matmul_precision="highest" is the contract.
// Measured (H100 SXM, 700 W): 33 TFLOP/s at (30000, 3000), cuBLAS SGEMM
// 51 TFLOP/s (PERF.md).
//
// Design (simple and right first; wgmma, TMA and 3xTF32 come later):
//   * one block of 256 threads per 128×128 W tile; each thread keeps an
//     8×8 accumulator in registers (rows ty*4+{0..3} and 64+ty*4+{0..3},
//     columns likewise with tx) so its shared-memory reads are
//     conflict-free float4s;
//   * each thread sums a tile's 16 products in a fresh partial before
//     adding it to its running sum (blocked summation, see the K loop);
//   * the K loop walks 16-deep tiles; the H tile (stored transposed) and
//     the V tile are double-buffered in shared memory with cp.async, the
//     counterpart of the TPU kernel's (2, mt, b) H double buffer;
//   * every ragged edge (rows m, columns k, depth b) is masked: cp.async
//     zero-fills out-of-range elements and the store skips them, so any m
//     works (the TPU kernel needed a divisor row tile) and windows need not
//     be multiples of 128;
//   * V and W may be column windows of a wider block: row strides (ldv,
//     ldw, ldh) are arguments, column stride must be 1.
//
// Shared memory per block (the accumulator lives in registers, not here):
//   H tiles 2 × 16 × (128 + 4) × 4 B = 16,896 B
//   V tiles 2 × 16 × 128 × 4 B       = 16,384 B
//   total                              33,280 B  (< 48 KB static limit)
// Registers: 64 running sums + 64 per-tile partials + 16 operands +
// addressing per thread.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // W tile rows
constexpr int BN = 128;        // W tile columns
constexpr int BK = 16;         // depth of one K tile
constexpr int NTHREADS = 256;
constexpr int AST = BM + 4;    // transposed H tile row stride (floats)

__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem,
                                             bool pred) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 4 : 0;   // 0 bytes read = zero-fill
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(saddr), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__global__ void __launch_bounds__(NTHREADS)
ring_hemm_f32_kernel(const float* __restrict__ H, long long ldh,
                     const float* __restrict__ V, long long ldv,
                     float* __restrict__ W, long long ldw,
                     int m, int k, int b, int accumulate) {
  __shared__ __align__(16) float As[2][BK][AST];   // As[kk][r] = H[r][kk]
  __shared__ __align__(16) float Bs[2][BK][BN];    // Bs[kk][c] = V[kk][c]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // H tile loads: thread reads H[row0 + a_r + 16 i][k0 + a_k], i < 8 —
  // 16 consecutive threads read 64 contiguous bytes of one row.
  const int a_k = tid & 15;
  const int a_r = tid >> 4;
  const float* a_src = H + (long long)(row0 + a_r) * ldh + a_k;
  const long long a_step = 16LL * ldh;
  const int a_rows_left = m - row0 - a_r;    // row i valid iff 16 i < this
  // V tile loads: thread reads V[k0 + b_k + 2 i][col0 + b_c], i < 8.
  const int b_c = tid & 127;
  const int b_k = tid >> 7;
  const float* b_src = V + (long long)b_k * ldv + col0 + b_c;
  const long long b_step = 2LL * ldv;
  const bool b_col_ok = col0 + b_c < k;

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const bool a_k_ok = k0 + a_k < b;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = a_k_ok && 16 * i < a_rows_left;
      const float* src = ok ? a_src + i * a_step + k0 : H;
      cp_async_f32(&As[buf][a_k][a_r + 16 * i], src, ok);
    }
    const float* b_tile = b_src + (long long)k0 * ldv;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = b_k + 2 * i;
      const bool ok = b_col_ok && k0 + kk < b;
      const float* src = ok ? b_tile + i * b_step : V;
      cp_async_f32(&Bs[buf][kk][b_c], src, ok);
    }
    cp_async_commit();
  };

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int ntiles = (b + BK - 1) / BK;
  if (ntiles > 0) load_tile(0, 0);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int buf = kt & 1;
    // the other buffer was last read before the trailing __syncthreads of
    // the previous iteration, so it is free to refill
    if (kt + 1 < ntiles) {
      load_tile(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // blocked summation: the tile's 16 products go into a fresh partial
    // that is then added to the running sum, so rounding error grows like
    // sqrt(16) + sqrt(K/16) rather than sqrt(K) — at K = 1000 a single
    // running sum measured ~5x cuBLAS's error, which splits K itself
    float part[8][8];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = kk == 0 ? a[i] * bv[j] : fmaf(a[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= m) continue;
    float* wrow = W + (long long)r * ldw;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < k) wrow[c] = accumulate ? wrow[c] + acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace

// W[0:m, 0:k] (=|+=) H[0:m, 0:b] · V[0:b, 0:k], all f32, row-major with
// row strides ldh, ldv, ldw and unit column stride; H already points at
// column col0 of the stripe.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronizes.
extern "C" int ring_hemm_f32(const float* H, long long ldh, const float* V,
                             long long ldv, float* W, long long ldw, int m,
                             int k, int b, int accumulate,
                             cudaStream_t stream) {
  if (m <= 0 || k <= 0) return 0;
  const dim3 grid((k + BN - 1) / BN, (m + BM - 1) / BM);
  ring_hemm_f32_kernel<<<grid, NTHREADS, 0, stream>>>(H, ldh, V, ldv, W, ldw,
                                                      m, k, b, accumulate);
  return static_cast<int>(cudaGetLastError());
}
