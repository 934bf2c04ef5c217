// Coverage scatter-add on Hopper, direct: counts[s] += 1 for every index s of
// a batch with 0 <= s < n, one thread per index and one global atomicAdd.
//
// Replaces pantas_tpu/coverage/pallas_kernel.py::coverage_scatter_add. The TPU
// kernel kept counts resident in VMEM as (rows, 8, 128) tiles and applied each
// index as a one-hot read-modify-write of its whole tile, because a TPU has no
// vector scatter and no scalar VMEM store. This card has global atomics, so
// each index is one atomicAdd at its own address: no sort, no shared memory,
// no tile traffic, and counts is neither padded nor copied.
//
// What bounds it: not arithmetic (one add per index). Each atomic goes to the
// L2, so the bound is the L2's atomic throughput on random addresses: a batch
// of 2^20 indices spread over 2^25..2^28 slots (128 MiB..1 GiB, far above the
// 50 MB L2) misses in the L2 almost every time, so each atomic also costs a
// sector read from device memory and a write back. Repeated slots add
// contention: atomics on one address serialise in its L2 slice, so a long
// run of equal slots (a deep-coverage node) is processed one at a time.
// Vectorised index loads and warp aggregation of equal slots are later work.
//
// The batch length stays a multiple of kBlock = 2048 (the TPU kernel's grid
// block, asserted at pallas_kernel.py:43); the wrapper refuses other batches,
// so both packages take the same ones. The kernel itself masks the ragged
// last thread block and drops s < 0 (padding) and s >= n.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// arrive as void*, and the entry point returns the cudaError_t of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 2048;  // indices per TPU grid step: the batch granule
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
direct_scatter(int32_t* __restrict__ counts, int64_t n,
               const int32_t* __restrict__ idx, int64_t m) {
  const int64_t k = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= m) return;
  const int32_t s = idx[k];
  if (s >= 0 && s < n) atomicAdd(&counts[s], 1);
}

}  // namespace

extern "C" int coverage_direct_block() { return kBlock; }

// counts: int32[n] on the device, updated in place. idx: int32[m] slot indices
// in any order, -1 for padding.
extern "C" int coverage_scatter_direct(void* counts, int64_t n, const void* idx, int64_t m,
                                       void* stream) {
  if (m <= 0) return cudaSuccess;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  direct_scatter<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(counts), n, static_cast<const int32_t*>(idx), m);
  return cudaGetLastError();
}
