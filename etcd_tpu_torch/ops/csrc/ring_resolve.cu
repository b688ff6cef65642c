// ring_resolve: the windowed ring-term lookup of the batched consensus
// round, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ring_resolve` of the JAX package
// (etcd_tpu/ops/pallas_kernels.py, body `_resolve_block`), which computes
// the same function as that package's `kernel._terms_at_many`:
//
//     out[r, t] = ring[r, idx[r, t] mod W]   if idx >= 1 and
//                                             last[r] - W < idx <= last[r]
//               = 0                          otherwise
//
// over the flattened (R = G*P rows, TE = trailing elements) problem. On
// the round's main path TE is P (send assembly: prev index per target)
// or E (conflict scan: one index per entry slot of an append).
//
// Bound: memory. There is no arithmetic to speak of; at G=100k, P=5,
// TE=P the call reads idx (10 MB) and writes out (10 MB), reads last
// (2 MB) and the ring words its in-window indices touch, so the least
// time is those bytes over the card's 3.35 TB/s. Design: one thread per
// output element in a grid-stride loop, so neighbouring threads read and
// write neighbouring idx/out words (coalesced); the window test comes
// before the slot is formed, so a negative or out-of-window index never
// reads the ring. Making it faster, or fusing it into a round kernel, is
// later work.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void ring_resolve_kernel(const int32_t* __restrict__ ring,
                                    const int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ last,
                                    int32_t* __restrict__ out,
                                    int64_t n, int te, int w) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = i / te;
    const int32_t x = idx[i];
    const int32_t l = last[r];
    int32_t v = 0;
    if (x >= 1 && x > l - w && x <= l) {
      // x >= 1 here, so C's truncating % equals the floor modulo.
      v = ring[r * w + (x % w)];
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" int ring_resolve_launch(const void* ring, const void* idx,
                                   const void* last, void* out, int rows,
                                   int te, int w, void* stream) {
  const int64_t n = (int64_t)rows * te;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t max_blocks = 132 * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  ring_resolve_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)ring, (const int32_t*)idx, (const int32_t*)last,
      (int32_t*)out, n, te, w);
  return (int)cudaGetLastError();
}
