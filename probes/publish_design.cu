// Variants of the peer route's publish (chase_tpu_torch/csrc/ring_peers.cu)
// for probes/publish_design.py: the kept source's publish_kernel at other
// unroll depths and grids, the first design (a block per row, 4-byte
// accesses) as it was, flat copies that change one thing at a time — the
// access width, the loads in flight per thread, the grid, the read-count
// poll, cache hints, contiguous tiles — and Hopper's 1-D bulk copy with the
// publish's protocol, at several stage counts and tile sizes and with each
// part of the protocol switched.  Every variant keeps the publish's block counter and
// ready flag; a poll waits for a read count of 0 (passes at once).

#include "../chase_tpu_torch/csrc/ring_peers.cu"

namespace {

// The first design: a block per row (min(rows, 1024) blocks), 4-byte
// loads and stores, thread 0 of every block polling the read count.
template <bool POLL>
__global__ void __launch_bounds__(256)
first_kernel(const float* __restrict__ V, long long ldv,
             float* __restrict__ dst, int rows, int cols, void* flags,
             unsigned long long epoch, long long* err) {
  __shared__ int go;
  unsigned* words = words_of(flags);
  if (threadIdx.x == 0)
    go = !POLL || wait_at_least(reads_of(flags, 0), 0, words + MAXP + 1, err,
                                SLOT_BUSY, 0, 0, -1, 1000000000ull);
  __syncthreads();
  if (!go) return;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* s = V + (long long)r * ldv;
    float* d = dst + (long long)r * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) d[c] = s[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atom_add_acq_rel_gpu(words + MAXP, 1u) == gridDim.x - 1) {
      words[MAXP] = 0;
      st_release_sys(ready_of(flags, 0), epoch);
    }
  }
}

// A flat range of n floats (a multiple of 4, 16-byte aligned) over the
// given grid, grid-strided over all its threads: VEC the kept source's
// copy_body (16-byte accesses), else 4-byte loads and stores; U loads in
// flight a thread either way.
template <int U, bool VEC, bool POLL>
__global__ void __launch_bounds__(256)
flat_kernel(const float* __restrict__ V, float* __restrict__ dst,
            long long n, void* flags, unsigned long long epoch,
            long long* err) {
  __shared__ int go;
  unsigned* words = words_of(flags);
  if (threadIdx.x == 0)
    go = !POLL || wait_at_least(reads_of(flags, 0), 0, words + MAXP + 1, err,
                                SLOT_BUSY, 0, 0, -1, 1000000000ull);
  __syncthreads();
  if (!go) return;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long T = static_cast<long long>(gridDim.x) * blockDim.x;
  if (VEC) {
    copy_body<U, true>(V, reinterpret_cast<float4*>(dst), 0, n / 4, t, T);
  } else {
    long long i = t;
    for (; i + (U - 1) * T < n; i += U * T) {
      float x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = __ldg(V + i + u * T);
#pragma unroll
      for (int u = 0; u < U; ++u) dst[i + u * T] = x[u];
    }
    for (; i < n; i += T) dst[i] = V[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atom_add_acq_rel_gpu(words + MAXP, 1u) == gridDim.x - 1) {
      words[MAXP] = 0;
      st_release_sys(ready_of(flags, 0), epoch);
    }
  }
}

template <int U>
int launch_publish(const float* V, long long ldv, float* dst, long long lds,
                   int rows, int cols, void* flags, unsigned long long epoch,
                   long long* err, int blocks, cudaStream_t stream) {
  publish_kernel<U><<<blocks, PUBLISH_THREADS, 0, stream>>>(
      V, ldv, dst, lds, rows, cols, flags, 0, epoch, 0, err, 0,
      1000000000ull);
  return static_cast<int>(cudaGetLastError());
}

template <int U, bool VEC, bool POLL>
int launch_flat(const float* V, float* dst, long long n, void* flags,
                unsigned long long epoch, long long* err, int blocks,
                cudaStream_t stream) {
  flat_kernel<U, VEC, POLL><<<blocks, 256, 0, stream>>>(V, dst, n, flags,
                                                        epoch, err);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte load with an L2 prefetch size: PF 0 none, 1 128 bytes, 2 256.
template <int PF>
__device__ __forceinline__ float4 ld_hint(const float4* p) {
  float4 v;
  if (PF == 1)
    asm("ld.global.nc.L1::no_allocate.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  else if (PF == 2)
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  else
    v = ld_nc_v4(p);
  return v;
}

// A flat, 16-byte aligned range of n4 float4s: U loads in flight a
// thread, with the L2 prefetch hint PF, streaming (.cs) stores with CS;
// TILED: each block walks tiles of 256·U contiguous float4s (grid-stride
// over tiles) instead of the grid-stride over float4s.  Poll, counter
// and ready flag as the publish's.
template <int U, int PF, bool CS, bool TILED>
__global__ void __launch_bounds__(256)
hint_kernel(const float4* __restrict__ s4, float4* __restrict__ d4,
            long long n4, void* flags, unsigned long long epoch,
            long long* err) {
  __shared__ int go;
  unsigned* words = words_of(flags);
  if (threadIdx.x == 0)
    go = wait_at_least(reads_of(flags, 0), 0, words + MAXP + 1, err,
                       SLOT_BUSY, 0, 0, -1, 1000000000ull);
  __syncthreads();
  if (!go) return;
  const long long B = blockDim.x;
  const long long t = TILED ? threadIdx.x : blockIdx.x * B + threadIdx.x;
  const long long T = TILED ? B : gridDim.x * B;
  const long long tile = TILED ? U * B : n4;
  for (long long base = TILED ? blockIdx.x * tile : 0; base < n4;
       base += TILED ? gridDim.x * tile : n4) {
    const long long end = base + tile < n4 ? base + tile : n4;
    long long i = base + t;
    for (; i + (U - 1) * T < end; i += U * T) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = ld_hint<PF>(s4 + i + u * T);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (CS)
          __stcs(d4 + i + u * T, x[u]);
        else
          d4[i + u * T] = x[u];
      }
    }
    for (; i < end; i += T) d4[i] = ld_hint<PF>(s4 + i);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atom_add_acq_rel_gpu(words + MAXP, 1u) == gridDim.x - 1) {
      words[MAXP] = 0;
      st_release_sys(ready_of(flags, 0), epoch);
    }
  }
}

struct HintArgs {
  const float4* s4;
  float4* d4;
  long long n4;
  void* flags;
  unsigned long long epoch;
  long long* err;
  int blocks;
  cudaStream_t stream;
};

template <int U, int PF, bool CS, bool TILED>
int launch_hint(const HintArgs& a) {
  hint_kernel<U, PF, CS, TILED><<<a.blocks, 256, 0, a.stream>>>(
      a.s4, a.d4, a.n4, a.flags, a.epoch, a.err);
  return static_cast<int>(cudaGetLastError());
}

template <int U, int PF>
int hint_cs(bool cs, bool tiled, const HintArgs& a) {
  if (cs) return tiled ? launch_hint<U, PF, true, true>(a)
                       : launch_hint<U, PF, true, false>(a);
  return tiled ? launch_hint<U, PF, false, true>(a)
               : launch_hint<U, PF, false, false>(a);
}

template <int U>
int hint_pf(int pf, bool cs, bool tiled, const HintArgs& a) {
  switch (pf) {
    case 0: return hint_cs<U, 0>(cs, tiled, a);
    case 1: return hint_cs<U, 1>(cs, tiled, a);
    case 2: return hint_cs<U, 2>(cs, tiled, a);
    default: return ERR_ARGS;
  }
}

// The block counter and ready flag written as COUNT says: 1 the kept
// form (__threadfence, atom.acq_rel.gpu, the last block st.release.sys),
// 2 without the __threadfence, 3 without the ready store, 4
// atom.release.gpu and in the last block fence.acq_rel.gpu then
// st.release.sys, 5 the kept form releasing at gpu scope (a measurement,
// not a protocol: a peer on another card acquires at sys scope).
template <int COUNT>
__device__ __forceinline__ void count_block(unsigned* words, void* flags,
                                            unsigned long long epoch) {
  if (COUNT != 2 && COUNT != 4) __threadfence();
  unsigned old;
  if (COUNT == 4)
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(words + MAXP) : "memory");
  else
    old = atom_add_acq_rel_gpu(words + MAXP, 1u);
  if (old != gridDim.x - 1) return;
  words[MAXP] = 0;
  if (COUNT == 4) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  if (COUNT == 5)
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(ready_of(flags, 0)), "l"(epoch) : "memory");
  else if (COUNT != 3)
    st_release_sys(ready_of(flags, 0), epoch);
}

// Hopper's 1-D bulk copy of a flat range of n floats (a multiple of 4,
// both ends 16-byte aligned): thread 0 of each block keeps STAGES tiles of
// TILE bytes in flight global → shared (cp.async.bulk, each stage
// completing on its mbarrier) and writes each back shared → global
// (cp.async.bulk … bulk_group) as it lands, loading a stage again once its
// store has read it; tiles grid-strided over the blocks.  Its protocol
// parts switched: POLL the read-count wait (after the first loads: nothing
// lands in the destination before it), FENCE the proxy fence after the
// stores complete (their generic-proxy release follows), COUNT the block
// counter and the ready flag (0: none; else count_block's forms).
template <int STAGES, int TILE, bool POLL, bool FENCE, int COUNT>
__global__ void __launch_bounds__(32)
bulk_parts_kernel(const float* __restrict__ V, float* __restrict__ dst,
                  long long n, void* flags, unsigned long long epoch,
                  long long* err) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t bar[STAGES];
  if (threadIdx.x != 0) return;
  unsigned* words = words_of(flags);
  const char* src = reinterpret_cast<const char*>(V);
  char* d = reinterpret_cast<char*>(dst);
  const long long nbytes = 16 * (n / 4);
  const long long step = gridDim.x;
  const long long ntiles = (nbytes + TILE - 1) / TILE;
  const long long mine = blockIdx.x < ntiles
                             ? (ntiles - blockIdx.x + step - 1) / step : 0;
  for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s], 1);
  mbar_init_fence();
  auto offset = [&](long long j) { return (blockIdx.x + j * step) * TILE; };
  auto bytes = [&](long long j) {
    const long long rest = nbytes - offset(j);
    return static_cast<uint32_t>(rest < TILE ? rest : TILE);
  };
  auto load = [&](long long j) {
    const int s = static_cast<int>(j % STAGES);
    mbar_arrive_expect_tx(&bar[s], bytes(j));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(stage + s * TILE)), "l"(src + offset(j)),
           "r"(bytes(j)), "r"(smem_u32(&bar[s]))
        : "memory");
  };
  for (long long j = 0; j < STAGES && j < mine; ++j) load(j);
  if (POLL && !wait_at_least(reads_of(flags, 0), 0, words + MAXP + 1, err,
                             SLOT_BUSY, 0, 0, -1, 1000000000ull)) {
    for (long long j = 0; j < STAGES && j < mine; ++j) mbar_wait(&bar[j], 0);
    return;
  }
  for (long long j = 0; j < mine; ++j) {
    const int s = static_cast<int>(j % STAGES);
    mbar_wait(&bar[s], static_cast<uint32_t>((j / STAGES) & 1));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(d + offset(j)), "r"(smem_u32(stage + s * TILE)),
                    "r"(bytes(j))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (j + STAGES < mine) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load(j + STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  if (FENCE) asm volatile("fence.proxy.async.global;" ::: "memory");
  if (COUNT) count_block<COUNT>(words, flags, epoch);
}

template <int STAGES, int TILE, bool POLL, bool FENCE, int COUNT>
int launch_parts(const float* V, float* dst, long long n, void* flags,
                 unsigned long long epoch, long long* err, int blocks,
                 cudaStream_t stream) {
  const int smem = STAGES * TILE;
  cudaError_t e = cudaFuncSetAttribute(
      bulk_parts_kernel<STAGES, TILE, POLL, FENCE, COUNT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bulk_parts_kernel<STAGES, TILE, POLL, FENCE, COUNT>
      <<<blocks, 32, smem, stream>>>(V, dst, n, flags, epoch, err);
  return static_cast<int>(cudaGetLastError());
}

// the whole protocol (poll, fence, the kept counter and flag)
template <int STAGES, int TILE>
int launch_bulk(const float* V, float* dst, long long n, void* flags,
                unsigned long long epoch, long long* err, int blocks,
                cudaStream_t stream) {
  return launch_parts<STAGES, TILE, true, true, 1>(V, dst, n, flags, epoch,
                                                   err, blocks, stream);
}

}  // namespace

// A flat, 16-byte aligned copy of n floats (a multiple of 4) by
// hint_kernel<unroll, pf, cs, tiled>; unroll 2 or 4, pf 0–2.
extern "C" int probe_hint(int unroll, int pf, int cs, int tiled,
                          const float* V, float* dst, long long n,
                          void* flags, unsigned long long epoch,
                          long long* err, int blocks, cudaStream_t stream) {
  const HintArgs a{reinterpret_cast<const float4*>(V),
                   reinterpret_cast<float4*>(dst), n / 4, flags, epoch, err,
                   blocks, stream};
  if (unroll == 2) return hint_pf<2>(pf, cs != 0, tiled != 0, a);
  if (unroll == 4) return hint_pf<4>(pf, cs != 0, tiled != 0, a);
  return ERR_ARGS;
}

// bulk_parts_kernel<stages, tile> with the whole protocol on a flat,
// 16-byte aligned range of n floats: mode 0 4 × 16 KB, 1 2 × 32 KB, 2 3 ×
// 32 KB, 3 6 × 16 KB, 4 8 × 8 KB, 5 2 × 16 KB.
extern "C" int probe_bulk(int mode, const float* V, float* dst, long long n,
                          void* flags, unsigned long long epoch,
                          long long* err, int blocks, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch_bulk<4, 16384>(V, dst, n, flags, epoch, err,
                                         blocks, stream);
    case 1: return launch_bulk<2, 32768>(V, dst, n, flags, epoch, err,
                                         blocks, stream);
    case 2: return launch_bulk<3, 32768>(V, dst, n, flags, epoch, err,
                                         blocks, stream);
    case 3: return launch_bulk<6, 16384>(V, dst, n, flags, epoch, err,
                                         blocks, stream);
    case 4: return launch_bulk<8, 8192>(V, dst, n, flags, epoch, err,
                                        blocks, stream);
    case 5: return launch_bulk<2, 16384>(V, dst, n, flags, epoch, err,
                                         blocks, stream);
    default: return ERR_ARGS;
  }
}

// bulk_parts_kernel<4, 16384, …> with parts = POLL·16 + FENCE·8 + COUNT
// (0–5).
extern "C" int probe_bulk_parts(int parts, const float* V, float* dst,
                                long long n, void* flags,
                                unsigned long long epoch, long long* err,
                                int blocks, cudaStream_t stream) {
#define PARTS(P, F, C)                                                     \
  case P * 16 + F * 8 + C:                                                 \
    return launch_parts<4, 16384, P, F, C>(V, dst, n, flags, epoch, err,  \
                                           blocks, stream);
  switch (parts) {
    PARTS(0, 0, 0) PARTS(0, 0, 1) PARTS(0, 1, 0) PARTS(0, 1, 1)
    PARTS(1, 0, 0) PARTS(1, 0, 1) PARTS(1, 1, 0) PARTS(1, 1, 1)
    PARTS(1, 1, 2) PARTS(1, 1, 3) PARTS(1, 1, 4) PARTS(1, 1, 5)
    default: return ERR_ARGS;
  }
#undef PARTS
}

// Resident blocks per SM of the kept publish_kernel (its launcher's
// grid is SMs × this, fewer for a small chunk).
extern "C" int probe_publish_per_sm(int* per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, publish_kernel<PUBLISH_UNROLL>, PUBLISH_THREADS, 0));
}

// variant 0: the kept publish_kernel<unroll> (rows × cols floats, row
// strides ldv and lds); 1, 2: the first design with and without its poll
// (destination row stride cols); 3–5: a flat range of rows·cols floats —
// 3 16-byte with the poll, 4 16-byte without it, 5 4-byte with it.
// unroll 1, 2, 4 or 8.  ERR_ARGS for anything else.
extern "C" int probe_publish(int variant, int unroll, const float* V,
                             long long ldv, float* dst, long long lds,
                             int rows, int cols, void* flags,
                             unsigned long long epoch, long long* err,
                             int blocks, cudaStream_t stream) {
  const long long n = static_cast<long long>(rows) * cols;
#define PROBE_UNROLL(CALL) \
  switch (unroll) {        \
    case 1: return CALL(1); \
    case 2: return CALL(2); \
    case 4: return CALL(4); \
    case 8: return CALL(8); \
    default: return ERR_ARGS; \
  }
#define PUB(U) launch_publish<U>(V, ldv, dst, lds, rows, cols, flags, epoch, \
                                 err, blocks, stream)
#define VEC_POLL(U) launch_flat<U, true, true>(V, dst, n, flags, epoch, err, \
                                               blocks, stream)
#define VEC_NOPOLL(U) launch_flat<U, true, false>( \
    V, dst, n, flags, epoch, err, blocks, stream)
#define SCALAR_POLL(U) launch_flat<U, false, true>(V, dst, n, flags, epoch, \
                                                   err, blocks, stream)
  switch (variant) {
    case 0: PROBE_UNROLL(PUB)
    case 1:
      first_kernel<true><<<blocks, 256, 0, stream>>>(V, ldv, dst, rows, cols,
                                                     flags, epoch, err);
      return static_cast<int>(cudaGetLastError());
    case 2:
      first_kernel<false><<<blocks, 256, 0, stream>>>(V, ldv, dst, rows, cols,
                                                      flags, epoch, err);
      return static_cast<int>(cudaGetLastError());
    case 3: PROBE_UNROLL(VEC_POLL)
    case 4: PROBE_UNROLL(VEC_NOPOLL)
    case 5: PROBE_UNROLL(SCALAR_POLL)
    default: return ERR_ARGS;
  }
#undef PROBE_UNROLL
#undef PUB
#undef VEC_POLL
#undef VEC_NOPOLL
#undef SCALAR_POLL
}
