// Coverage scatter-add on Hopper, direct: counts[s] += 1 for every index s of
// a batch with 0 <= s < n, with no partition of the batch. A persistent grid
// reads the batch with 16-byte streaming loads, and runs of equal neighbouring
// slots are combined in the warp before the global atomic.
//
// Replaces pantas_tpu/coverage/pallas_kernel.py::coverage_scatter_add. The TPU
// kernel kept counts resident in VMEM as (rows, 8, 128) tiles and applied each
// index as a one-hot read-modify-write of its whole tile, because a TPU has no
// vector scatter and no scalar VMEM store. This card has global atomics, so
// an index is an atomic add at its own address: no sort, no tile traffic, and
// counts is neither padded nor copied.
//
// What bounds it: bytes, not arithmetic (one add per index). The batch is
// 4 MB; counts is 128 MiB at 2^25 slots and 1 GiB at 2^28, far above the 50 MB
// L2, so every distinct 32-byte sector of counts that a batch names is read
// from device memory and written back once, at random addresses. On top of
// that, atomics on one address are applied one at a time in that address's
// L2 slice (~0.7 ns each on this card), so a slot named thousands of times in
// a row, a deep exon, serialises unless its adds are combined first. The
// design:
//
//   1. A persistent grid: SMs x the CTAs an SM holds, sized once per device
//      (capping it at 1, 2 or 4 CTAs an SM changed no time). A warp walks the batch in steps of
//      kStep = 128 consecutive indices, one int4 a lane (ld.global.cs: the
//      batch is read once, so it should not displace counts sectors from the
//      L2), kUnroll steps loaded before the first is applied.
//   2. Rows. A lane's int4 is four consecutive indices, but the lanes of one
//      atomic instruction should hold neighbouring indices: a read names
//      neighbouring slots one after the other, and 32 lanes that hit a few
//      sectors cost the L2 less than 32 lanes that hit 32. So each warp turns
//      its step through 512 bytes of shared memory into four rows of 32, lane
//      l of row j holding index 32 * j + l. (On the real slot batches of a
//      10 Mbp graph this layout took 11 us where four consecutive indices a
//      lane took 15; on uniform indices it changes nothing.)
//   3. Runs of equal neighbours are folded before any atomic. A __shfl_up_sync
//      per row (lane 0 takes the row above's last index) tells a lane whether
//      its index starts a run; one ballot per row gives the step's run starts
//      as 128 bits in batch order, and a run's length is the distance to the
//      next set bit. Only a run's first index adds, once, with the run's
//      length: a step of 128 equal indices is one add. The result of
//      atomicAdd is unused, so it compiles to RED, which waits for no return
//      trip.
//
// Measured and not kept: a combining table in shared memory (direct mapped
// (slot, count) pairs claimed with atomicCAS, flushed once a CTA). It cost
// nothing on uniform indices, but with the row layout it made the real
// batches slower (12.3-13.0 us against 10.9-11.1), because there equal slots
// lie a read apart, rarely inside one CTA's share.
//
// idx need not be 16-byte aligned: up to three leading and three trailing
// indices are applied one by one, and the rest is read as int4. Dropped:
// s < 0 (any negative index, not only the -1 padding) and s >= n.
//
// The batch length the wrapper accepts stays a multiple of kBlock = 2048 (the
// TPU kernel's grid block, asserted at pallas_kernel.py:43), so both packages
// take the same batches; the kernel itself takes any length.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// arrive as void*, and the entry point returns the cudaError_t of its launch.
// It makes the tensors' device current, launches on the given stream and
// never synchronises.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "device_guard.cuh"

namespace {

using pantas_kernels::DeviceGuard;
using pantas_kernels::kMaxDevices;

constexpr int kBlock = 2048;  // indices per TPU grid step: the batch granule
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;              // rows of 32 indices in a warp's step
constexpr int kStep = 32 * kRows;     // consecutive indices a warp takes at once
constexpr int kUnroll = 4;            // steps a warp loads before it applies them
constexpr unsigned kAll = 0xffffffffu;

// One step: the warp's kStep consecutive indices as kRows rows of 32, lane l
// of row j holding e[j] = index 32 * j + l of the step. Every lane of the
// warp calls it (it shuffles).
__device__ __forceinline__ void add_step(int32_t* __restrict__ counts, uint32_t n,
                                         int32_t (&e)[kRows]) {
  const int lane = threadIdx.x & 31;
  bool head[kRows];        // this index starts a run of equal neighbours
  unsigned heads[kRows];   // the row's run starts, a bit a lane
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (uint32_t(e[j]) >= n) e[j] = -1;  // s < 0 or s >= n: dropped, and all dropped are equal
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    int32_t left = __shfl_up_sync(kAll, e[j], 1);
    if (j > 0) {
      const int32_t above = __shfl_sync(kAll, e[j - 1], 31);  // the row above ends to my left
      if (lane == 0) left = above;
    }
    head[j] = (j == 0 && lane == 0) || left != e[j];
    heads[j] = __ballot_sync(kAll, head[j]);
  }
  const unsigned right_of_me = ~((2u << lane) - 1u);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!head[j] || e[j] < 0) continue;
    int next = kStep;  // where the next run starts: the run's end
#pragma unroll
    for (int k = kRows - 1; k >= j; --k) {
      const unsigned later = k > j ? heads[k] : heads[k] & right_of_me;
      if (later) next = 32 * k + __ffs(later) - 1;
    }
    atomicAdd(&counts[e[j]], next - (32 * j + lane));  // result unused: a RED
  }
}

// idx + head is 16-byte aligned. idx[head .. head + body), body the largest
// multiple of 4 that fits, is read as int4 by the whole grid; idx[0 .. head)
// and the tail after the vectors are applied one by one by block 0.
__global__ void __launch_bounds__(kThreads)
direct_scatter(int32_t* __restrict__ counts, uint32_t n, const int32_t* __restrict__ idx,
               int32_t m, int head) {
  static_assert(kRows == 4, "a lane's int4 is four consecutive indices");
  __shared__ __align__(16) int32_t stage[kWarps][kStep];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t body = (m - head) / 4 * 4;
  if (blockIdx.x == 0) {
    const int tail = m - head - body;
    const int i = threadIdx.x;
    if (i < head + tail) {
      const int32_t s = idx[i < head ? i : m - tail + (i - head)];
      if (uint32_t(s) < n) atomicAdd(&counts[s], 1);
    }
  }
  const int4* __restrict__ idx4 = reinterpret_cast<const int4*>(idx + head);
  const int32_t steps = (body + kStep - 1) / kStep;
  const int64_t n_warps = int64_t(gridDim.x) * kWarps;
  // the loop's bounds are the same for a whole warp
  for (int64_t s0 = blockIdx.x * kWarps + warp; s0 < steps; s0 += n_warps * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // past `body` for a step the warp does not have, or the ragged last step
      const int64_t k = (s0 + u * n_warps) * kStep + 4 * lane;
      v[u] = k < body ? __ldcs(idx4 + k / 4) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u * n_warps >= steps) break;
      *reinterpret_cast<int4*>(&stage[warp][4 * lane]) = v[u];
      __syncwarp();
      int32_t e[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) e[j] = stage[warp][32 * j + lane];
      __syncwarp();  // the rows are read before the next step overwrites them
      add_step(counts, n, e);
    }
  }
}

struct DirectSetup {
  bool done = false;
  int ctas = 0;  // the most CTAs the device holds at once
};

std::mutex g_setup_mu;
DirectSetup g_setup[kMaxDevices];

// Size the persistent grid, once per device in a process. The current device
// is `dev`.
cudaError_t setup(int dev, int* ctas) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_setup_mu);
  DirectSetup& d = g_setup[dev];
  if (!d.done) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, direct_scatter, kThreads, 0);
    }
    if (e != cudaSuccess) return e;  // not marked done: the next call tries again
    d.ctas = sms * (per_sm > 0 ? per_sm : 1);
    d.done = true;
  }
  *ctas = d.ctas;
  return cudaSuccess;
}

}  // namespace

extern "C" int coverage_direct_block() { return kBlock; }

// CTAs of the persistent grid on `device`, or minus the error.
extern "C" int coverage_direct_grid(int device) {
  DeviceGuard guard(device);
  if (guard.err() != cudaSuccess) return -int(guard.err());
  int ctas = 0;
  const cudaError_t e = setup(device, &ctas);
  return e == cudaSuccess ? ctas : -int(e);
}

// counts: int32[n] on `device`, updated in place. idx: int32[m] slot indices
// in any order, any negative for padding, at any 4-byte aligned address.
extern "C" int coverage_scatter_direct(int device, void* counts, int64_t n, const void* idx,
                                       int64_t m, void* stream) {
  if (m < 0 || m > INT32_MAX || n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  const auto addr = reinterpret_cast<uintptr_t>(idx);
  if (addr % sizeof(int32_t)) return cudaErrorMisalignedAddress;
  if (m == 0) return cudaSuccess;
  DeviceGuard guard(device);
  if (guard.err() != cudaSuccess) return guard.err();
  int ctas = 0;
  cudaError_t e = setup(device, &ctas);
  if (e != cudaSuccess) return e;
  const int64_t busy = (m + int64_t(kStep) * kWarps - 1) / (int64_t(kStep) * kWarps);
  const unsigned grid = unsigned(busy < ctas ? busy : ctas);  // no CTA without a step
  const int64_t to_aligned = ((16 - addr % 16) % 16) / sizeof(int32_t);
  const int head = int(to_aligned < m ? to_aligned : m);
  direct_scatter<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(counts), uint32_t(n), static_cast<const int32_t*>(idx), int32_t(m),
      head);
  return cudaGetLastError();
}
