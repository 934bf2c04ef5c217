// Coverage scatter-add on Hopper: counts[s] += 1 for every slot 0 <= s < n of
// a batch, as a window partition followed by a persistent histogram pass.
//
// Replaces pantas_tpu/coverage/pallas_kernel.py::sorted_coverage_scatter_add.
// The TPU kernel sorted the batch, cut the sorted stream at windows of kWindow
// count slots with searchsorted, and built each window's histogram as a
// one-hot product on the MXU, because the TPU has no vector scatter. This card
// has shared-memory atomics, and it needs only each index's window, not a full
// order, so the batch is bucketed by window with a counting sort on one digit
// (w = s >> 14) and each window's bucket becomes a shared-memory histogram.
//
// What bounds it: bytes of device memory, not arithmetic. The batch is 4 MB
// (2^20 int32 indices); the counts vector is 128 MiB at 2^25 slots and 1 GiB
// at 2^28, far above the 50 MB L2, so every distinct slot a batch names costs
// a sector read and write of `counts`: on a uniform batch the histogram pass
// is as bound by those random read-modify-writes as a direct atomic per
// index is, and the partition is the price of aggregating repeated slots,
// which a batch with long runs or a hot window repays many times over.
//
//   1. window_count: each CTA takes a tile of the batch and counts its window
//      ids in shared memory, warp-aggregated (__match_any_sync: the lanes of
//      a warp that share a window make one shared atomic), then reserves its
//      range in each window it holds with one global atomic per (CTA,
//      window) on win_count, and keeps the offset it got in its row of
//      cta_off.
//   2. window_scan: one CTA turns win_count into bounds (an exclusive scan)
//      and numbers the histogram's work items: one per chunk of at most
//      kChunk entries of each window, so that a heavy window spreads over
//      many SMs.
//   3. window_scatter: each CTA takes the same tile, starts each window at
//      bounds[c] + its offset, and writes its indices into `bucketed` (a
//      warp-aggregated shared atomic hands out the places): bounds[c] ..
//      bounds[c + 1] holds exactly the kept slots of window c, in no
//      particular order. It also writes the work items.
//   4. window_histogram: a persistent grid (SMs x the CTAs per SM that 64 KB of
//      shared memory allows) walks the work items. Each CTA zeroes its 16,384
//      bins once; per item it adds the entries (warp-aggregated on equal
//      slots), then the leader of each warp's group of equal slots claims its
//      bin with atomicExch(bin, 0) and adds the total into counts with one
//      global atomic (two items of one window may run on two SMs at once). So
//      every bin is written back once per item and left zero for the next.
//
// Above kCountCap windows (n above 2^28) the window ids no longer fit in
// shared memory: pass 1 adds into win_count and pass 3 takes its places from
// the cursor pass 2 leaves there, both with warp-aggregated global atomics.
//
// Dropped everywhere: s < 0 (any negative index, not only the -1 padding) and
// s >= n_windows * kWindow; slots in [n, n_windows * kWindow) of the ragged
// last window are bucketed and masked at write-back. counts is never padded or
// copied.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// arrive as void*, and each entry point returns the first cudaError_t of its
// launches. It launches on the given stream and never synchronises.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "device_guard.cuh"

namespace {

using pantas_kernels::DeviceGuard;
using pantas_kernels::kMaxDevices;

constexpr int kWindowShift = 14;
constexpr int kWindow = 1 << kWindowShift;  // slots per window: the TPU kernel's W_TILES * 1024
constexpr int kChunk = 2048;                // most entries of one histogram work item
constexpr int kCountCap = 16384;            // most windows counted in shared memory (64 KB)
constexpr int kPartThreads = 512;
constexpr int kUnroll = 4;                  // indices a thread loads before it processes them
constexpr int kStep = kPartThreads * kUnroll;
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;                 // windows a scan thread takes a round
constexpr int kScanRound = kScanThreads * kScanPer;
constexpr int kHistThreads = 512;
constexpr int kPerThread = kChunk / kHistThreads;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kChunk % kHistThreads == 0, "an item's entries split evenly over the threads");

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ bool leads(unsigned peers) {
  return (threadIdx.x & 31) == unsigned(__ffs(peers) - 1);
}

// the window of a kept slot, -1 for a dropped one
__device__ __forceinline__ int window_of(int32_t s, int64_t limit) {
  return (s >= 0 && s < limit) ? (s >> kWindowShift) : -1;
}

__device__ __forceinline__ void load_step(const int32_t* __restrict__ idx, int64_t k0,
                                          int64_t stop, int32_t (&s)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t k = k0 + u * kPartThreads + threadIdx.x;
    s[u] = k < stop ? idx[k] : -1;
  }
}

// bins[w] += number of tile indices in window w; one atomic per run of equal
// windows in a warp. Every lane reaches every __match_any_sync: the loop bound
// is the same for the whole CTA.
__device__ __forceinline__ void count_tile(const int32_t* __restrict__ idx, int64_t start,
                                           int64_t stop, int64_t limit, int32_t* bins) {
  for (int64_t k0 = start; k0 < stop; k0 += kStep) {
    int32_t s[kUnroll];
    load_step(idx, k0, stop, s);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = window_of(s[u], limit);
      const unsigned peers = __match_any_sync(kAll, w);
      if (w >= 0 && leads(peers)) atomicAdd(&bins[w], __popc(peers));
    }
  }
}

// Shared mode: win_count[c] += this tile's count in window c, and
// cta_off[blockIdx.x][c] = the tile's offset inside window c. Global mode
// (n_windows > kCountCap): win_count alone, cta_off unused.
template <bool kShared>
__global__ void __launch_bounds__(kPartThreads)
window_count(const int32_t* __restrict__ idx, int64_t m, int64_t limit, int n_windows,
             int64_t tile, int32_t* __restrict__ win_count, int32_t* __restrict__ cta_off) {
  extern __shared__ int32_t bins[];
  const int64_t start = int64_t(blockIdx.x) * tile;
  const int64_t stop = start + tile < m ? start + tile : m;
  if constexpr (!kShared) {
    count_tile(idx, start, stop, limit, win_count);
  } else {
    for (int i = threadIdx.x; i < n_windows; i += kPartThreads) bins[i] = 0;
    __syncthreads();
    count_tile(idx, start, stop, limit, bins);
    __syncthreads();
    int32_t* row = cta_off + int64_t(blockIdx.x) * n_windows;
#pragma unroll 4
    for (int i = threadIdx.x; i < n_windows; i += kPartThreads) {
      const int32_t v = bins[i];
      row[i] = v ? atomicAdd(&win_count[i], v) : 0;
    }
  }
}

// Exclusive sum over the CTA of one value per thread; `total` gets the sum.
__device__ __forceinline__ int32_t cta_exclusive_sum(int32_t v, int32_t* warp_sums,
                                                     int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += t;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t y = warp_sums[lane];  // kScanThreads / 32 == 32 warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t t = __shfl_up_sync(kAll, y, d);
      if (lane >= d) y += t;
    }
    warp_sums[lane] = y;  // inclusive over warps
  }
  __syncthreads();
  const int32_t out = x - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

// A scan thread's kScanPer windows lie at stride kScanPer + 1 in shared
// memory: conflict-free banks for the thread-contiguous reads.
__device__ __forceinline__ int staged(int i) { return i + i / kScanPer; }

__device__ __forceinline__ int32_t chunks_of(int32_t len) { return (len + kChunk - 1) / kChunk; }

// One CTA, in rounds of kScanRound windows staged through shared memory so
// that every device-memory access is coalesced. In: win_count[c] = kept
// indices of window c. Out: bounds (n_windows + 1, exclusive scan),
// win_count[c] = bounds[c] (global mode's cursor), win_count[n_windows] = the
// number of work items, and, unless item_start is null, item_start (n_windows
// + 1): the first work item of each window (one per kChunk entries).
__global__ void __launch_bounds__(kScanThreads)
window_scan(int32_t* __restrict__ win_count, int n_windows, int32_t* __restrict__ bounds,
            int32_t* __restrict__ item_start) {
  static_assert(kScanThreads == 32 * 32, "cta_exclusive_sum scans 32 warps");
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t stage[kScanRound + kScanRound / kScanPer];
  int32_t pos_carry = 0, item_carry = 0;
  for (int round = 0; round < n_windows; round += kScanRound) {
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      const int i = j * kScanThreads + threadIdx.x;
      stage[staged(i)] = round + i < n_windows ? win_count[round + i] : 0;
    }
    __syncthreads();
    int32_t v[kScanPer], len = 0, chunks = 0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      v[j] = stage[staged(threadIdx.x * kScanPer + j)];
      len += v[j];
      chunks += chunks_of(v[j]);
    }
    // the sums' barriers also order every read of the stage above before
    // the writes below; each thread rewrites only its own entries
    int32_t total_len, total_items;
    int32_t pos = pos_carry + cta_exclusive_sum(len, warp_sums, &total_len);
    int32_t item = item_carry + cta_exclusive_sum(chunks, warp_sums, &total_items);
    pos_carry += total_len;
    item_carry += total_items;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      stage[staged(threadIdx.x * kScanPer + j)] = pos;
      pos += v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      const int i = j * kScanThreads + threadIdx.x;
      if (round + i < n_windows) bounds[round + i] = win_count[round + i] = stage[staged(i)];
    }
    if (item_start) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kScanPer; ++j) {
        stage[staged(threadIdx.x * kScanPer + j)] = item;
        item += chunks_of(v[j]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kScanPer; ++j) {
        const int i = j * kScanThreads + threadIdx.x;
        if (round + i < n_windows) item_start[round + i] = stage[staged(i)];
      }
    }
    __syncthreads();  // the stage is refilled next round
  }
  if (threadIdx.x == 0) {
    bounds[n_windows] = pos_carry;
    win_count[n_windows] = item_carry;
    if (item_start) item_start[n_windows] = item_carry;
  }
}

// Also writes the histogram's work items (x = window, y / z = the item's range
// of `bucketed`) unless items is null: each CTA those of a slice of the
// windows, a warp a window and a lane every 32nd item of it.
template <bool kShared>
__global__ void __launch_bounds__(kPartThreads)
window_scatter(const int32_t* __restrict__ idx, int64_t m, int64_t limit, int n_windows,
               int64_t tile, int32_t* __restrict__ cursor, const int32_t* __restrict__ bounds,
               const int32_t* __restrict__ cta_off, int32_t* __restrict__ bucketed,
               const int32_t* __restrict__ item_start, int4* __restrict__ items) {
  extern __shared__ int32_t local[];
  const int64_t start = int64_t(blockIdx.x) * tile;
  const int64_t stop = start + tile < m ? start + tile : m;
  if (items) {
    const int per = (n_windows + gridDim.x - 1) / gridDim.x;
    const int c_end = min(int(blockIdx.x + 1) * per, n_windows);
    const int lane = threadIdx.x & 31;
    for (int c = blockIdx.x * per + (threadIdx.x >> 5); c < c_end; c += kPartThreads / 32) {
      const int32_t lo = bounds[c], hi = bounds[c + 1], first = item_start[c];
      for (int64_t k = lo + int64_t(lane) * kChunk; k < hi; k += 32 * kChunk) {
        items[first + (k - lo) / kChunk] =
            make_int4(c, int32_t(k), int32_t(k + kChunk < hi ? k + kChunk : hi), 0);
      }
    }
  }
  if constexpr (kShared) {
    // where this tile's part of each window starts
    const int32_t* row = cta_off + int64_t(blockIdx.x) * n_windows;
    for (int i = threadIdx.x; i < n_windows; i += kPartThreads) local[i] = bounds[i] + row[i];
    __syncthreads();
  }
  int32_t* next = kShared ? local : cursor;
  const unsigned below = lanemask_lt();
  for (int64_t k0 = start; k0 < stop; k0 += kStep) {
    int32_t s[kUnroll];
    load_step(idx, k0, stop, s);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = window_of(s[u], limit);
      const unsigned peers = __match_any_sync(kAll, w);
      int32_t p = 0;
      if (w >= 0 && leads(peers)) p = atomicAdd(&next[w], __popc(peers));
      p = __shfl_sync(kAll, p, __ffs(peers) - 1);
      if (w >= 0) bucketed[p + __popc(peers & below)] = s[u];
    }
  }
}

// An item's entries, kPerThread a thread; -1 past the item's end (a bucketed
// slot is never negative).
__device__ __forceinline__ void load_item(const int32_t* __restrict__ bucketed, int4 item,
                                          int32_t (&e)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t k = int64_t(item.y) + j * kHistThreads + threadIdx.x;
    e[j] = k < item.z ? bucketed[k] : -1;
  }
}

__global__ void __launch_bounds__(kHistThreads, 3)
window_histogram(int32_t* __restrict__ counts, int64_t n, const int32_t* __restrict__ bucketed,
                 const int4* __restrict__ items, const int32_t* __restrict__ n_items) {
  extern __shared__ __align__(16) int32_t hist[];
  const int total = *n_items;
  int it = blockIdx.x;
  if (it >= total) return;  // the same for the whole CTA
  int4* hist4 = reinterpret_cast<int4*>(hist);
  for (int i = threadIdx.x; i < kWindow / 4; i += kHistThreads) hist4[i] = make_int4(0, 0, 0, 0);
  int4 item = items[it];
  int32_t e[kPerThread];
  load_item(bucketed, item, e);
  __syncthreads();
  for (;;) {
    const int next = it + gridDim.x;
    const bool more = next < total;
    const int4 next_item = more ? items[next] : item;  // in flight during the adds
    const int64_t base = int64_t(item.x) << kWindowShift;
    int32_t off[kPerThread];
    unsigned peers[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      off[j] = e[j] >= 0 ? int32_t(e[j] - base) : -1;
      peers[j] = __match_any_sync(kAll, off[j]);
      if (off[j] >= 0 && leads(peers[j])) atomicAdd(&hist[off[j]], __popc(peers[j]));
    }
    __syncthreads();
    if (more) load_item(bucketed, next_item, e);  // in flight during the write-back
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (off[j] >= 0 && leads(peers[j])) {
        const int32_t v = atomicExch(&hist[off[j]], 0);
        if (v > 0 && base + off[j] < n) atomicAdd(&counts[base + off[j]], v);
      }
    }
    if (!more) break;
    __syncthreads();  // every bin is clear before the next item's adds
    it = next;
    item = next_item;
  }
}

struct DeviceSetup {
  bool done = false;
  int hist_grid = 0;
};

std::mutex g_setup_mu;
DeviceSetup g_setup[kMaxDevices];

// Opt the kernels into their dynamic shared memory and size the persistent
// grid, once per device in a process. The current device is `dev`.
cudaError_t setup(int dev, DeviceSetup* out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_setup_mu);
  DeviceSetup& d = g_setup[dev];
  if (!d.done) {
    const int hist_smem = kWindow * int(sizeof(int32_t));
    const int count_smem = kCountCap * int(sizeof(int32_t));
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(window_histogram, attr, hist_smem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(window_count<true>, attr, count_smem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(window_scatter<true>, attr, count_smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_histogram, kHistThreads,
                                                        hist_smem);
    }
    if (e != cudaSuccess) return e;  // not marked done: the next call tries again
    d.hist_grid = sms * (per_sm > 0 ? per_sm : 1);
    d.done = true;
  }
  *out = d;
  return cudaSuccess;
}

// Passes 1-3 with at most `ctas` partition CTAs. win_count has n_windows + 1
// entries; cta_off has ctas * n_windows when n_windows <= kCountCap;
// item_start (n_windows + 1) and items are null or both given.
cudaError_t partition(const int32_t* idx, int64_t m, int n_windows, int ctas,
                      int32_t* bucketed, int32_t* bounds, int32_t* win_count, int32_t* cta_off,
                      int32_t* item_start, int4* items, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(win_count, 0, sizeof(int32_t) * (n_windows + 1), st);
  if (e != cudaSuccess) return e;
  const int64_t limit = int64_t(n_windows) << kWindowShift;
  const bool shared = n_windows <= kCountCap;
  const size_t smem = shared ? sizeof(int32_t) * n_windows : 0;
  const int64_t per_cta = (m + ctas - 1) / ctas;
  const int64_t tile = ((per_cta + kStep - 1) / kStep) * kStep;
  const int64_t grid = m > 0 ? (m + tile - 1) / tile : 0;  // <= ctas
  if (grid > 0) {
    if (shared) {
      window_count<true><<<unsigned(grid), kPartThreads, smem, st>>>(idx, m, limit, n_windows,
                                                                     tile, win_count, cta_off);
    } else {
      window_count<false><<<unsigned(grid), kPartThreads, 0, st>>>(idx, m, limit, n_windows,
                                                                   tile, win_count, cta_off);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  window_scan<<<1, kScanThreads, 0, st>>>(win_count, n_windows, bounds, item_start);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (grid > 0) {
    if (shared) {
      window_scatter<true><<<unsigned(grid), kPartThreads, smem, st>>>(
          idx, m, limit, n_windows, tile, win_count, bounds, cta_off, bucketed, item_start, items);
    } else {
      window_scatter<false><<<unsigned(grid), kPartThreads, 0, st>>>(
          idx, m, limit, n_windows, tile, win_count, bounds, cta_off, bucketed, item_start, items);
    }
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

extern "C" int coverage_scatter_window() { return kWindow; }
extern "C" int coverage_scatter_chunk() { return kChunk; }
extern "C" int coverage_partition_cap() { return kCountCap; }

extern "C" const char* coverage_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs of the persistent histogram grid on `device`, or minus the error.
extern "C" int coverage_histogram_grid(int device) {
  DeviceGuard guard(device);
  if (guard.err() != cudaSuccess) return -int(guard.err());
  DeviceSetup d;
  const cudaError_t e = setup(device, &d);
  return e == cudaSuccess ? d.hist_grid : -int(e);
}

// Passes 1-3 alone. idx: int32[m] on `device`; ctas > 0. bucketed: int32[m];
// bounds: int32[n_windows + 1]; win_count: int32[n_windows + 1] scratch;
// cta_off: int32[ctas * n_windows] scratch when n_windows <= kCountCap.
extern "C" int coverage_window_partition(int device, const void* idx, int64_t m, int n_windows,
                                         int ctas, void* bucketed, void* bounds,
                                         void* win_count, void* cta_off, void* stream) {
  if (m < 0 || m > INT32_MAX || n_windows < 0 || ctas <= 0) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err() != cudaSuccess) return guard.err();
  DeviceSetup d;
  cudaError_t e = setup(device, &d);
  if (e != cudaSuccess) return e;
  return partition(static_cast<const int32_t*>(idx), m, n_windows, ctas,
                   static_cast<int32_t*>(bucketed), static_cast<int32_t*>(bounds),
                   static_cast<int32_t*>(win_count), static_cast<int32_t*>(cta_off), nullptr,
                   nullptr, static_cast<cudaStream_t>(stream));
}

// The whole batch: passes 1-4. counts: int32[n] on `device`, updated in place.
// The rest as above, with n_windows = ceil(n / kWindow); item_start:
// int32[n_windows + 1] and items: int4[min(n_windows, m) + m / kChunk]
// scratch (16-byte aligned).
extern "C" int coverage_scatter_sorted(int device, void* counts, int64_t n, const void* idx,
                                       int64_t m, int ctas, void* bucketed, void* bounds,
                                       void* win_count, void* cta_off, void* item_start,
                                       void* items, void* stream) {
  const int64_t n_windows = (n + kWindow - 1) / kWindow;
  if (m < 0 || m > INT32_MAX || n < 0 || (n_windows << kWindowShift) > INT32_MAX || ctas <= 0) {
    return cudaErrorInvalidValue;
  }
  DeviceGuard guard(device);
  if (guard.err() != cudaSuccess) return guard.err();
  DeviceSetup d;
  cudaError_t e = setup(device, &d);
  if (e != cudaSuccess) return e;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* wc = static_cast<int32_t*>(win_count);
  auto* it = static_cast<int4*>(items);
  e = partition(static_cast<const int32_t*>(idx), m, int(n_windows), ctas,
                static_cast<int32_t*>(bucketed), static_cast<int32_t*>(bounds), wc,
                static_cast<int32_t*>(cta_off), static_cast<int32_t*>(item_start), it, st);
  if (e != cudaSuccess || m == 0 || n_windows == 0) return e;
  window_histogram<<<d.hist_grid, kHistThreads, kWindow * sizeof(int32_t), st>>>(
      static_cast<int32_t*>(counts), n, static_cast<const int32_t*>(bucketed), it,
      wc + n_windows);
  return cudaGetLastError();
}
