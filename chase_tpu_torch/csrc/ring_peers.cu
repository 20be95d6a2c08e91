// ring_peers — the (p, 1) ring's chunk transfer in device code: each rank
// pulls its peers' V chunks out of their memory on the card (CUDA IPC
// across processes, the pointer itself within one), lays them out as the
// ring_hemm main kernel's B operand, and the main kernel (ring_hemm.cu)
// then multiplies the whole stripe in one launch.
//
// Replaces the transfer half of the TPU kernel chase_tpu/ops/pallas_ring.py
// ::_ring_kernel: there each device RDMAs its V chunk to its right
// neighbour (make_async_remote_copy, double-buffered in VMEM) and meets
// its neighbours at a semaphore barrier before a buffer is reused.  Here:
//
//   * publish (ring_peers_publish): the owner copies its raw chunk into
//     its exported slot — two slots, by product parity — and raises the
//     slot's ready flag to the product's epoch (st.release.sys);
//   * gather (ring_peers_gather_*): one launch pulls every chunk, in ring
//     order (step s reads rank (me + s) mod p, so at every step each rank
//     reads another peer), waits for the owner's ready flag
//     (ld.acquire.sys) and writes the chunk where it lands as the main
//     kernel's B: TF32 hi/lo split and transposed for f32, the six
//     planes (Re, Im, Re + Im, each split) for c64, rounded to bf16 and
//     transposed for the bf16 route — bit for bit the pre-pass of the
//     whole V (both write B with hopper_tf32.cuh's b_operand_tile and
//     c64_operand_tile);
//   * release: the last block to finish a peer's chunk adds one to that
//     owner's read count of the slot (red.release.sys); the owner's next
//     publish into the slot (two products later) waits until all p − 1
//     readers have counted.
//
// What the TPU design carried that falls away: the relay around the ring
// (ICI's topology; NVLink joins every pair, so a rank pulls each chunk
// from its owner, once per product) and the VMEM double buffer (the
// receive buffer is the B operand in local HBM).  Each chunk crosses the
// link once per reader and product, raw (the f32 split would double the
// bytes); the split happens where the chunk lands.
//
// Protocol.  Epochs are monotone (product e raises its slot's flag to
// e + 1), so a late reader cannot take an old flag for a new one.  Every
// wait is bounded by %globaltimer: on expiry the block records (code,
// rank, product, peer, seen, wanted) in mapped host memory and sets the
// rank's fail word, so that its other blocks and later launches stop
// waiting; a gather block that gives up writes NaN over its part of B, so
// the product is NaN, and PeerChunks.check raises a RuntimeError naming
// them at the next publish or host synchronisation of the solver.  No launch waits on a
// launch queued after it on its own stream: a simulation of p ranks on
// one stream queues every rank's publish before any rank's gather.
//
// What bounds it on an H100: bytes.  A gather at (N, k) = (30000, 3000)
// reads N·k·4 bytes of chunks (360 MB; c64 twice) and writes the
// split (8·N·k bytes, the f32 route's hi and lo planes; 24·N·k, c64's six)
// or pack (2·N·k);
// at 3.35 TB/s that is 0.3–0.6 ms beside a main kernel of 12–50 ms.  A
// simple kernel first: the single-device pre-pass's 32 × 32
// shared-memory transposes (b_operand_tile), one 256-thread block per 32
// K rows × 256 columns.  The overlapped form (copier warps pulling chunk s + 1 while
// the main kernel multiplies chunk s) is later work (ROADMAP).
//
// The publish replaces the send half of _ring_kernel's
// make_async_remote_copy: the owner's write of its chunk where its peers
// read it.  It reads b·k floats and writes as many (2·b·k for c64): 360 MB
// at (b, k) = (15000, 3000) f32, 0.107 ms at 3.35 TB/s, so bytes bound it.
// The first design (a block per row, 4-byte loads and stores) kept one
// 4-byte load in flight per thread, too few bytes per SM to cover HBM's
// latency, and reached 57–62% of that bound; neither its grid nor its
// read-count polls cost anything measurable (probes/publish_design.py).
// This one keeps PUBLISH_UNROLL 16-byte loads (ld.global.nc.v4) in flight
// per thread before their stores, over as many 256-thread blocks as the
// card holds at once (SMs × resident blocks, fewer for a small chunk).  A
// contiguous chunk (ldv = cols = the slot's row stride) is one flat range
// whose blocks walk contiguous tiles of 16 KB, grid-strided; a strided one
// (a column window of a wider V) goes a row per warp, stored 16 bytes at a
// time from the slot row's first 16-byte boundary with a scalar head and
// tail.  Loads are 16 bytes wide where the source has the slot's
// alignment, float by float where it has not.  The slot's rows stay
// packed (row stride k floats, 2k for c64: parallel/peers.slot_row_floats),
// so a contiguous chunk of any width, odd k included, is one aligned range.
// Hopper's 1-D bulk copy (cp.async.bulk through shared memory) was tried
// and moved these chunks within 1.5% of the tiled 16-byte copy, which
// every other layout needs anyway (the probe).  What stays above a plain
// copy_ (2.7–3.6 µs a launch on an H100) is the protocol's end: the block
// counter and the sys-scope release of the ready flag after the last
// store.  The
// protocol is the first design's: every block's thread 0 waits for the
// slot's read count before any of the block's bytes move (so a wait that
// times out leaves the slot unwritten), and the last block to finish
// raises the ready flag.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_tf32.cuh"

namespace {

using namespace hopper;

constexpr int MAXP = 32;                 // ranks of a ring (ops/ring_hemm.py)
constexpr int TY = 8;                    // 32-column tiles per gather block
constexpr int PUBLISH_THREADS = 256;
constexpr int PUBLISH_UNROLL = 4;        // 16-byte loads in flight a thread
constexpr int ERR_ARGS = 3000;           // beside cudaError_t (< 1000)
constexpr int NOT_PUBLISHED = 1;         // error record codes
constexpr int SLOT_BUSY = 2;

// A rank's flags block (exported): u64 ready[2], u64 reads[2]; from byte
// 64 its own u32 words: the gather's per-chunk block counts done[MAXP],
// the publish's block count, and the fail word.
__device__ __forceinline__ unsigned long long* ready_of(void* flags,
                                                         int slot) {
  return static_cast<unsigned long long*>(flags) + slot;
}
__device__ __forceinline__ unsigned long long* reads_of(void* flags,
                                                         int slot) {
  return static_cast<unsigned long long*>(flags) + 2 + slot;
}
__device__ __forceinline__ unsigned* words_of(void* flags) {
  return reinterpret_cast<unsigned*>(static_cast<char*>(flags) + 64);
}

struct Peers {
  const float* data[MAXP];      // rank q's chunk: b rows, row stride ld[q]
  long long ld[MAXP];           // floats
  void* flags[MAXP];            // rank q's flags block
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void red_add_release_sys(unsigned long long* p,
                                                    unsigned long long v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel_gpu(unsigned* p,
                                                         unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag >= want.  False when the wait passed timeout_ns — the
// first such block records the error and sets *fail — or another block
// has failed.
__device__ bool wait_at_least(const unsigned long long* flag,
                              unsigned long long want, unsigned* fail,
                              volatile long long* err, int code, int rank,
                              long long product, int peer,
                              unsigned long long timeout_ns) {
  const unsigned long long t0 = globaltimer();
  unsigned ns = 32;
  for (;;) {
    const unsigned long long v = ld_acquire_sys(flag);
    if (v >= want) return true;
    if (*static_cast<volatile unsigned*>(fail)) return false;
    if (globaltimer() - t0 > timeout_ns) {
      if (atomicCAS(fail, 0u, 1u) == 0u) {
        err[1] = rank;
        err[2] = product;
        err[3] = peer;
        err[4] = static_cast<long long>(v);
        err[5] = static_cast<long long>(want);
        __threadfence_system();
        err[0] = code;
        __threadfence_system();
      }
      return false;
    }
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
  }
}

__device__ __forceinline__ float4 ld_nc_v4(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// Four floats from a source that is 4-byte aligned only.
__device__ __forceinline__ float4 ld_nc_4(const float* p) {
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// d4[i] = s[4i … 4i + 3] for lo <= i < hi, by the threads t = 0 … T − 1
// of a team, U 16-byte loads in flight a thread before their stores —
// float4 loads where s is 16-byte aligned (ALIGNED), else float loads.
template <int U, bool ALIGNED>
__device__ __forceinline__ void copy_body(const float* __restrict__ s,
                                          float4* __restrict__ d4,
                                          long long lo, long long hi,
                                          long long t, long long T) {
  long long i = lo + t;
  for (; i + (U - 1) * T < hi; i += U * T) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = ALIGNED ? ld_nc_v4(reinterpret_cast<const float4*>(s) + i + u * T)
                     : ld_nc_4(s + 4 * (i + u * T));
#pragma unroll
    for (int u = 0; u < U; ++u) d4[i + u * T] = x[u];
  }
  for (; i < hi; i += T)
    d4[i] = ALIGNED ? ld_nc_v4(reinterpret_cast<const float4*>(s) + i)
                    : ld_nc_4(s + 4 * i);
}

// d[i] = s[i] for i < n, d 16-byte aligned, by the whole grid: each block
// walks contiguous tiles of U·blockDim float4s, grid-strided; block 0
// copies the last n mod 4 floats.
template <int U>
__device__ __forceinline__ void copy_flat(const float* __restrict__ s,
                                          float* __restrict__ d,
                                          long long n) {
  const long long n4 = n >> 2, tile = static_cast<long long>(U) * blockDim.x;
  float4* d4 = reinterpret_cast<float4*>(d);
  const bool aligned = (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  for (long long lo = blockIdx.x * tile; lo < n4; lo += gridDim.x * tile) {
    const long long hi = lo + tile < n4 ? lo + tile : n4;
    if (aligned)
      copy_body<U, true>(s, d4, lo, hi, threadIdx.x, blockDim.x);
    else
      copy_body<U, false>(s, d4, lo, hi, threadIdx.x, blockDim.x);
  }
  if (blockIdx.x == 0)
    for (long long j = 4 * n4 + threadIdx.x; j < n; j += blockDim.x)
      d[j] = s[j];
}

// d[i] = s[i] for i < n by the 32 lanes of a warp: d's floats before its
// first 16-byte boundary and after its last one one by one, the body as
// float4 stores.
template <int U>
__device__ __forceinline__ void copy_row(const float* __restrict__ s,
                                         float* __restrict__ d, long long n,
                                         int lane) {
  const long long head = min(
      n, static_cast<long long>(
             ((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15) >> 2));
  if (lane < head) d[lane] = s[lane];
  s += head;
  d += head;
  n -= head;
  const long long n4 = n >> 2;
  float4* d4 = reinterpret_cast<float4*>(d);
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0)
    copy_body<U, true>(s, d4, 0, n4, lane, 32);
  else
    copy_body<U, false>(s, d4, 0, n4, lane, 32);
  for (long long j = 4 * n4 + lane; j < n; j += 32) d[j] = s[j];
}

// slot[r][c] = V[r][c] for r < rows, c < cols (floats; slot row stride
// lds), after the slot's earlier readers have counted (reads >= need);
// then ready = epoch.
template <int U>
__global__ void __launch_bounds__(PUBLISH_THREADS)
publish_kernel(const float* __restrict__ V, long long ldv,
               float* __restrict__ slot_data, long long lds, int rows,
               int cols, void* flags, int slot, unsigned long long epoch,
               unsigned long long need, long long* err, int rank,
               unsigned long long timeout_ns) {
  __shared__ int go;
  unsigned* words = words_of(flags);
  if (threadIdx.x == 0)
    go = wait_at_least(reads_of(flags, slot), need, words + MAXP + 1, err,
                       SLOT_BUSY, rank, static_cast<long long>(epoch) - 1,
                       -1, timeout_ns);
  __syncthreads();
  if (!go) return;
  if (rows == 1 || (ldv == cols && lds == cols)) {
    copy_flat<U>(V, slot_data, static_cast<long long>(rows) * cols);
  } else {
    const int per_block = blockDim.x / 32;
    const long long warps = static_cast<long long>(gridDim.x) * per_block;
    for (long long r = static_cast<long long>(blockIdx.x) * per_block +
                       threadIdx.x / 32;
         r < rows; r += warps)
      copy_row<U>(V + r * ldv, slot_data + r * lds, cols, threadIdx.x & 31);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atom_add_acq_rel_gpu(words + MAXP, 1u) == gridDim.x - 1) {
      words[MAXP] = 0;
      st_release_sys(ready_of(flags, slot), epoch);
    }
  }
}

// MODE 0: f32 → Vt (2 × w_pad × b_pad) hi/lo; 1: c64 → Vt (6 × w_pad ×
// b_pad), the c64 route's six planes (c64_operand_tile); 2: f32 → Vb
// (w_pad × b_pad) bf16 (b_operand_tile's modes, hopper_tf32.cuh).  Chunk
// src lands at K rows [src·b, (src+1)·b); the last chunk's blocks also
// zero the K padding up to b_pad, every block the columns past k.  A
// block whose wait failed writes NaN over its part of the chunk, so that
// the product comes out NaN rather than from stale memory, and does not
// count as a reader.
template <int MODE>
__global__ void __launch_bounds__(256)
gather_kernel(const Peers pr, int p, int me, int slot,
              unsigned long long epoch, void* __restrict__ out, int b, int k,
              int b_pad, int w_pad, long long* err,
              unsigned long long timeout_ns) {
  __shared__ float tile[MODE == 1 ? 2 : 1][32][33];
  __shared__ int go;
  const int src = (me + static_cast<int>(blockIdx.z)) % p;
  const int start = src * b, end = src == p - 1 ? b_pad : start + b;
  const int ntiles = (end - start + 31) / 32;
  if (static_cast<int>(blockIdx.x) >= ntiles) return;
  unsigned* words = words_of(pr.flags[me]);
  const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
  if (lead)
    go = src == me ||
         wait_at_least(ready_of(pr.flags[src], slot), epoch, words + MAXP + 1,
                       err, NOT_PUBLISHED, me,
                       static_cast<long long>(epoch) - 1, src, timeout_ns);
  __syncthreads();
  const float* V = go ? pr.data[src] : nullptr;
  const int kk0 = blockIdx.x * 32;
  const long long plane = (long long)w_pad * b_pad;
  for (int t = 0; t < TY; ++t) {
    const int n0 = (blockIdx.y * TY + t) * 32;
    if (n0 >= w_pad) break;
    if constexpr (MODE == 1)
      c64_operand_tile(tile, V, pr.ld[src], kk0, b, n0, k, 0,
                       static_cast<float*>(out), start + kk0, end, b_pad,
                       plane);
    else
      b_operand_tile<MODE>(tile[0], V, pr.ld[src], kk0, b, n0, k, out,
                           start + kk0, end, b_pad, plane);
  }
  if (go && src != me && lead) {
    // this block has read its part of the chunk; the last one releases
    // the owner's slot
    __threadfence();
    unsigned* done = words + src;
    if (atom_add_acq_rel_gpu(done, 1u) ==
        static_cast<unsigned>(ntiles) * gridDim.y - 1) {
      *done = 0;
      red_add_release_sys(reads_of(pr.flags[src], slot), 1ull);
    }
  }
}

template <int MODE>
int launch_gather(const Peers* pr, int p, int me, int slot,
                  unsigned long long epoch, void* out, int b, int k,
                  int b_pad, int w_pad, long long* err,
                  unsigned long long timeout_ns, cudaStream_t stream) {
  const int last = b_pad - (p - 1) * b;       // the last chunk's K rows
  if (p < 1 || p > MAXP || me < 0 || me >= p || slot < 0 || slot > 1 ||
      b <= 0 || k <= 0 || last < b || w_pad % 32)
    return ERR_ARGS;
  const dim3 grid((last + 31) / 32, (w_pad + 32 * TY - 1) / (32 * TY), p);
  gather_kernel<MODE><<<grid, dim3(32, 8), 0, stream>>>(
      *pr, p, me, slot, epoch, out, b, k, b_pad, w_pad, err, timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The text of an error code of this library.
extern "C" const char* ring_peers_error(int err) {
  return err == ERR_ARGS ? "bad arguments"
                         : cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---- memory: the exported blocks and their mappings --------------------------
// Each returns 0 or a cudaError_t.

// A zeroed device block of `bytes` on `device` (its own cudaMalloc, so
// that an IPC handle maps exactly it).
extern "C" int ring_peers_alloc(int device, long long bytes, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

extern "C" int ring_peers_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFree(ptr);
  return static_cast<int>(e);
}

// The 64-byte IPC handle of a block from ring_peers_alloc.
extern "C" int ring_peers_export(int device, void* ptr, char* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(e);
}

// Another process's block mapped into this one (peer access enabled
// lazily, for a block on another card).
extern "C" int ring_peers_open(int device, const char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(e);
}

extern "C" int ring_peers_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(e);
}

// Zeroed pinned host memory that kernels write through `dev` (the error
// record) and the host reads without a synchronisation.
extern "C" int ring_peers_host_alloc(long long bytes, void** host,
                                     void** dev) {
  cudaError_t e = cudaHostAlloc(host, bytes,
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e == cudaSuccess) {
    memset(*host, 0, bytes);
    e = cudaHostGetDevicePointer(dev, *host, 0);
  }
  return static_cast<int>(e);
}

extern "C" int ring_peers_host_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

// ---- the launches -------------------------------------------------------------
// Each launches on `stream`, never synchronises, and returns
// cudaGetLastError() (or ERR_ARGS).

// Publish product `epoch` − 1: V (rows × cols floats, row stride ldv)
// into this rank's slot `slot` (slot_data, row stride lds) once its read
// count reaches `need`, then ready[slot] = epoch.  The grid: the blocks
// the card holds at once (SMs × resident blocks of the kernel), fewer
// when the chunk gives them no work.
extern "C" int ring_peers_publish(const float* V, long long ldv,
                                  float* slot_data, long long lds, int rows,
                                  int cols, void* flags, int slot,
                                  unsigned long long epoch,
                                  unsigned long long need, long long* err,
                                  int rank, unsigned long long timeout_ns,
                                  cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || slot < 0 || slot > 1 || epoch == 0 ||
      (rows > 1 && (ldv < cols || lds < cols)) ||
      (reinterpret_cast<uintptr_t>(slot_data) & 15))
    return ERR_ARGS;
  const auto kernel = publish_kernel<PUBLISH_UNROLL>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      PUBLISH_THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the blocks that have work — a tile of the flat range, or a row a warp
  // — at most as many as the card holds at once
  const bool flat = rows == 1 || (ldv == cols && lds == cols);
  const long long tile = 4LL * PUBLISH_UNROLL * PUBLISH_THREADS;  // floats
  const long long work =
      flat ? (static_cast<long long>(rows) * cols + tile - 1) / tile
           : (rows + PUBLISH_THREADS / 32 - 1) / (PUBLISH_THREADS / 32);
  const long long card = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(work < card ? work : card);
  kernel<<<blocks, PUBLISH_THREADS, 0, stream>>>(
      V, ldv, slot_data, lds, rows, cols, flags, slot, epoch, need, err, rank,
      timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

// Gather product `epoch` − 1 for rank `me` of p: every rank's chunk (b ×
// k elements: f32, or c64 for the _c64 entry; pr->data[me] is the rank's
// own V) in the main kernel's B layout `out` — Vt (2 × w_pad × b_pad f32)
// for f32, Vt (6 × w_pad × b_pad f32) for c64, Vb (w_pad × b_pad bf16)
// for bf16 — with b_pad the padded K extent of the whole (p·b) and w_pad
// a multiple of 32 of at least k.
extern "C" int ring_peers_gather_f32(const void* pr, int p, int me, int slot,
                                     unsigned long long epoch, float* out,
                                     int b, int k, int b_pad, int w_pad,
                                     long long* err,
                                     unsigned long long timeout_ns,
                                     cudaStream_t stream) {
  return launch_gather<0>(static_cast<const Peers*>(pr), p, me, slot, epoch,
                          out, b, k, b_pad, w_pad, err, timeout_ns, stream);
}

extern "C" int ring_peers_gather_c64(const void* pr, int p, int me, int slot,
                                     unsigned long long epoch, float* out,
                                     int b, int k, int b_pad, int w_pad,
                                     long long* err,
                                     unsigned long long timeout_ns,
                                     cudaStream_t stream) {
  return launch_gather<1>(static_cast<const Peers*>(pr), p, me, slot, epoch,
                          out, b, k, b_pad, w_pad, err, timeout_ns, stream);
}

extern "C" int ring_peers_gather_bf16(const void* pr, int p, int me,
                                      int slot, unsigned long long epoch,
                                      uint16_t* out, int b, int k, int b_pad,
                                      int w_pad, long long* err,
                                      unsigned long long timeout_ns,
                                      cudaStream_t stream) {
  return launch_gather<2>(static_cast<const Peers*>(pr), p, me, slot, epoch,
                          out, b, k, b_pad, w_pad, err, timeout_ns, stream);
}
