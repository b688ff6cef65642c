// ring_resolve: the windowed ring-term lookup of the batched consensus
// round, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ring_resolve` of the JAX package
// (etcd_tpu/ops/pallas_kernels.py:94, body `_resolve_block` :42-58),
// which computes the same function as that package's
// `kernel._terms_at_many`:
//
//     out[r, t] = ring[r, idx[r, t] mod W]   if idx >= 1 and
//                                             last[r] - W < idx <= last[r]
//               = 0                          otherwise
//
// over the flattened (R = G*P rows, TE = trailing elements) problem. On
// the round's main path TE is P = 5 (send assembly: prev index per
// target) or E = 4 (conflict scan: one index per entry slot of an
// append).
//
// Bound: bytes. There is no arithmetic to speak of; at G=100k, P=5,
// TE=5 the call reads idx (10 MB) and writes out (10 MB), reads last
// (2 MB) and the ring words its in-window indices touch, so the least
// time is those bytes over the card's 3.35 TB/s. (Device memory hands
// out a touched ring word as part of its 64-byte row, so the bytes that
// really move are more than the bound counts.)
//
// Design, against what held the first (one thread per element) version
// back:
// 1. 64-bit division per element: index arithmetic here is 32-bit and
//    division-free. A thread owns whole rows, so an element's row is
//    known without dividing; the slot is `idx & (W-1)` when W is a power
//    of two, else a 32-bit `%`. TE = 4 and TE = 5 are template
//    instantiations with their loops unrolled; one generic instantiation
//    takes a runtime TE for every other trailing shape. The plan refuses
//    tensors whose offsets need more than 31 bits.
// 2. A grid larger than the card holds: the grid here is at most the
//    resident blocks (SMs x occupancy from the occupancy API, never more
//    than 2,048 threads per SM), and each persistent block walks tiles
//    blockIdx.x, blockIdx.x + gridDim.x, ... .
// 3. Narrow, serial accesses: a tile is `tile_rows` consecutive rows (a
//    multiple of 4, so every copy is 16-byte aligned in address and
//    size); its idx rows and last words are contiguous and arrive by 1-D
//    TMA bulk copies (`cp.async.bulk`) completing on an mbarrier. Two
//    stages: while the block resolves tile k, the copy of tile k+1 is in
//    flight. Each thread tests its row's window from shared
//    memory and issues all of the row's ring loads (`__ldg`) before it
//    uses any; an index that fails the test never reads the ring.
//    Results overwrite the idx words in shared memory and leave as one
//    bulk store per tile (`cp.async.bulk.global.shared::cta`). A ragged
//    last tile (rows not a multiple of 4), or tensors not 16-byte
//    aligned, are loaded and stored with plain coalesced accesses.
// 4. Host cost per call: the launch plan (instantiation, tile rows,
//    tiles, grid, shared memory) is computed once per shape in
//    Python (ops/ring_resolve.py::launch_plan) and passed packed, with
//    the pointers, stream and device, as two arguments; the device guard
//    is taken here, in C, only when the device is not already current.
//
// C interface (loaded with ctypes): `ring_resolve_launch` returns
// cudaGetLastError() after the launch, so a refused launch is reported
// to the caller; `ring_resolve_occupancy` reports resident blocks per SM;
// `ring_resolve_layout` reports the constants below, which the wrapper's
// plan assumes and checks when it loads the library.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;         // tiles in flight per block
constexpr int kBarrierBytes = 16;  // one 8-byte mbarrier per stage, then
                                   // the stages (16-byte aligned for TMA)
static_assert(kBarrierBytes == 8 * kStages && kBarrierBytes % 16 == 0,
              "stages must start 16-byte aligned after the barriers");

enum Variant { kGeneric = 0, kTe4 = 1, kTe5 = 2, kEmpty = 3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared bulk copy completing on `bar` (bytes and both addresses
// multiples of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared -> global bulk store, tracked by this thread's bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's bulk stores are complete in global memory.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy (bulk copy) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int32_t slot_of(int32_t x, int w, int wmask) {
  return wmask >= 0 ? (x & wmask) : (x % w);  // x >= 1 here
}

// Resolves rows [0, n) of a staged tile in place: sidx holds the tile's
// idx rows (te words each), slast its last words; row0 is the tile's
// first global row. Thread-per-row: each thread tests its row's window,
// issues all of the row's ring loads, then overwrites its idx words.
template <int TE>
__device__ __forceinline__ void resolve_rows(const int32_t* __restrict__ ring,
                                             int32_t* sidx,
                                             const int32_t* slast, int n,
                                             int row0, int w, int wmask) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    int32_t x[TE];
    int32_t* row = sidx + r * TE;
    if constexpr (TE == 4) {
      const int4 q = *reinterpret_cast<const int4*>(row);
      x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < TE; ++j) x[j] = row[j];
    }
    const int32_t l = slast[r];
    const int32_t lo = l - w;
    const int32_t* rr = ring + static_cast<uint32_t>(row0 + r) *
                                   static_cast<uint32_t>(w);
    int32_t v[TE];
#pragma unroll
    for (int j = 0; j < TE; ++j) {
      const bool in = x[j] >= 1 && x[j] > lo && x[j] <= l;
      v[j] = in ? __ldg(rr + slot_of(x[j], w, wmask)) : 0;
    }
    if constexpr (TE == 4) {
      *reinterpret_cast<int4*>(row) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TE; ++j) row[j] = v[j];
    }
  }
}

// Runtime TE: the same, in chunks of 8 elements (all of a chunk's ring
// loads issued before any is used).
__device__ __forceinline__ void resolve_rows_generic(
    const int32_t* __restrict__ ring, int32_t* sidx, const int32_t* slast,
    int n, int row0, int te, int w, int wmask) {
  constexpr int kChunk = 8;
  for (int r = threadIdx.x; r < n; r += kThreads) {
    int32_t* row = sidx + r * te;
    const int32_t l = slast[r];
    const int32_t lo = l - w;
    const int32_t* rr = ring + static_cast<uint32_t>(row0 + r) *
                                   static_cast<uint32_t>(w);
    for (int j0 = 0; j0 < te; j0 += kChunk) {
      int32_t v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        v[j] = 0;
        if (j0 + j < te) {
          const int32_t x = row[j0 + j];
          if (x >= 1 && x > lo && x <= l) v[j] = __ldg(rr + slot_of(x, w, wmask));
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j0 + j < te) row[j0 + j] = v[j];
    }
  }
}

// TE > 0: specialised; TE == 0: te_rt elements per row.
template <int TE>
__global__ void __launch_bounds__(kThreads)
    ring_resolve_tiles(const int32_t* __restrict__ ring,
                       const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ last,
                       int32_t* __restrict__ out, int rows, int te_rt, int w,
                       int wmask, int tile_rows, int tiles) {
  const int te = TE > 0 ? TE : te_rt;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int32_t* stages = reinterpret_cast<int32_t*>(smem + kBarrierBytes);
  const int stage_words = tile_rows * (te + 1);  // idx rows, then last words
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(last) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool lead = threadIdx.x == 0;

  if (lead) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 only: start filling stage s with tile t. A bulk tile's copy
  // completes the barrier's phase; a plain tile is loaded by every
  // thread after the wait, so the phase completes on a bare arrive.
  auto fill = [&](int t, int s) {
    const int n = min(tile_rows, rows - t * tile_rows);
    if (aligned && (n & 3) == 0) {
      int32_t* sidx = stages + s * stage_words;
      const uint32_t bi = static_cast<uint32_t>(n * te) * 4u;
      const uint32_t bl = static_cast<uint32_t>(n) * 4u;
      fence_proxy_async();
      mbar_arrive_expect_tx(&full[s], bi + bl);
      bulk_load(sidx, idx + static_cast<uint32_t>(t * tile_rows) * te, bi,
                &full[s]);
      bulk_load(sidx + tile_rows * te, last + t * tile_rows, bl, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };

  if (lead) {
    for (int s = 0; s < kStages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < tiles) fill(t, s);
    }
  }

  int s = 0;            // this tile's stage
  uint32_t phase = 0;   // parity of the stage's current use
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int32_t* sidx = stages + s * stage_words;
    int32_t* slast = sidx + tile_rows * te;
    const int row0 = t * tile_rows;
    const int n = min(tile_rows, rows - row0);
    const uint32_t e0 = static_cast<uint32_t>(row0) * te;
    const int ne = n * te;
    const bool bulk = aligned && (n & 3) == 0;
    mbar_wait(&full[s], phase);
    if (!bulk) {
      for (int e = threadIdx.x; e < ne; e += kThreads) sidx[e] = idx[e0 + e];
      for (int r = threadIdx.x; r < n; r += kThreads) slast[r] = last[row0 + r];
      __syncthreads();
    }
    if constexpr (TE > 0) {
      resolve_rows<TE>(ring, sidx, slast, n, row0, w, wmask);
    } else {
      resolve_rows_generic(ring, sidx, slast, n, row0, te, w, wmask);
    }
    fence_proxy_async();  // results before the bulk store / next bulk load
    __syncthreads();
    if (bulk) {
      if (lead) bulk_store(out + e0, sidx, static_cast<uint32_t>(ne) * 4u);
    } else {
      for (int e = threadIdx.x; e < ne; e += kThreads) out[e0 + e] = sidx[e];
      __syncthreads();
    }
    const int next = t + kStages * gridDim.x;
    if (lead && next < tiles) {
      bulk_wait_read();  // the store above has read stage s
      fill(next, s);
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  if (lead) bulk_wait_all();
}

__global__ void ring_resolve_empty() {}

const void* kernel_of(int variant) {
  switch (variant) {
    case kGeneric: return (const void*)&ring_resolve_tiles<0>;
    case kTe4: return (const void*)&ring_resolve_tiles<4>;
    case kTe5: return (const void*)&ring_resolve_tiles<5>;
    default: return nullptr;
  }
}

// Lets `variant` take `smem` bytes of dynamic shared memory on the current
// device (above the default 48 KB only after this attribute is raised).
cudaError_t allow_smem(int variant, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_of(variant),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// Makes `device` current for the life of the guard, as torch's device
// guard would, and restores the caller's device after.
struct DeviceGuard {
  int prev = -1, dev;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int d) : dev(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

}  // namespace

// The layout the wrapper's launch plan assumes: {threads per block,
// barrier bytes before the stages, stages, the Variant ids kGeneric,
// kTe4, kTe5, kEmpty}. Returns how many ints it wrote (at most n).
extern "C" int ring_resolve_layout(int* out, int n) {
  const int v[] = {kThreads, kBarrierBytes, kStages, kGeneric,
                   kTe4,     kTe5,          kEmpty};
  const int k = n < 7 ? n : 7;
  for (int j = 0; j < k; ++j) out[j] = v[j];
  return k;
}

// Resident blocks per SM of `variant` at `smem` bytes of shared memory on
// `device`.
extern "C" int ring_resolve_occupancy(int variant, int smem, int device,
                                      int* blocks) {
  if (kernel_of(variant) == nullptr) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = allow_smem(variant, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of(variant), kThreads, smem);
}

// One launch. plan = {variant, rows, te, w, wmask, tile_rows, tiles, grid,
// smem} (ops/ring_resolve.py::_plan_words); ptrs = {ring, idx, last, out,
// stream, device}. Two packed arguments keep the ctypes call short.
// kEmpty launches an empty kernel of the same grid (the launch floor).
extern "C" int ring_resolve_launch(const int* plan, const int64_t* ptrs) {
  const int variant = plan[0], rows = plan[1], te = plan[2], w = plan[3],
            wmask = plan[4], tile_rows = plan[5], tiles = plan[6],
            grid = plan[7], smem = plan[8];
  const int32_t* r = (const int32_t*)ptrs[0];
  const int32_t* i = (const int32_t*)ptrs[1];
  const int32_t* l = (const int32_t*)ptrs[2];
  int32_t* o = (int32_t*)ptrs[3];
  cudaStream_t st = (cudaStream_t)ptrs[4];
  DeviceGuard guard((int)ptrs[5]);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (variant == kEmpty) {
    ring_resolve_empty<<<grid, kThreads, 0, st>>>();
    return (int)cudaGetLastError();
  }
  if (kernel_of(variant) == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(variant, smem);
  if (err != cudaSuccess) return (int)err;
  switch (variant) {
    case kTe4:
      ring_resolve_tiles<4><<<grid, kThreads, smem, st>>>(
          r, i, l, o, rows, te, w, wmask, tile_rows, tiles);
      break;
    case kTe5:
      ring_resolve_tiles<5><<<grid, kThreads, smem, st>>>(
          r, i, l, o, rows, te, w, wmask, tile_rows, tiles);
      break;
    default:
      ring_resolve_tiles<0><<<grid, kThreads, smem, st>>>(
          r, i, l, o, rows, te, w, wmask, tile_rows, tiles);
  }
  return (int)cudaGetLastError();
}
