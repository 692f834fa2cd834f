// Shared pieces of the port's counting kernels (hist.cu, scan_packed.cu):
// the per-device launch facts, cached at the first launch on a device, and
// a histogram held in shared memory -- one block's, or split across the
// blocks of a thread-block cluster (distributed shared memory) when its
// bins outgrow one block.
//
// A histogram here is a group of G motif columns: entry key = bin * G + c.
// A block keeps `slice` entries; in a cluster of C blocks, rank r keeps
// keys [r * slice, (r + 1) * slice).  Counts are int32 atomics, which
// commute, so every result is exact in any launch order.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace grafimo {

namespace cg = cooperative_groups;

constexpr int kMaxDevices = 64;
// the largest portable cluster: 8 blocks, 8 x 227 KB of bins
constexpr int kMaxCluster = 8;

struct DeviceInfo {
  int sms = 0;
  int smem_block = 0;     // dynamic shared memory a block may opt in to
  int smem_sm = 0;        // shared memory of one SM
  int smem_reserved = 0;  // reserved by the runtime for each block
  int threads_sm = 0;
};

// The launch facts of `dev`, read with cudaDeviceGetAttribute on the first
// call for that device only.
inline cudaError_t device_info(int dev, const DeviceInfo** out) {
  static DeviceInfo info[kMaxDevices];
  static std::atomic<bool> ready[kMaxDevices];
  static std::mutex mu;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev].load(std::memory_order_relaxed)) {
      DeviceInfo d;
      const std::pair<int*, cudaDeviceAttr> attrs[] = {
          {&d.sms, cudaDevAttrMultiProcessorCount},
          {&d.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin},
          {&d.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor},
          {&d.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock},
          {&d.threads_sm, cudaDevAttrMaxThreadsPerMultiProcessor},
      };
      for (const auto& a : attrs) {
        const cudaError_t err = cudaDeviceGetAttribute(a.first, a.second, dev);
        if (err != cudaSuccess) return err;
      }
      info[dev] = d;
      ready[dev].store(true, std::memory_order_release);
    }
  }
  *out = &info[dev];
  return cudaSuccess;
}

// Lift `kernel`'s dynamic shared memory limit to the device's opt-in
// maximum, once per (kernel, device); every later launch fits under it.
template <typename Kernel>
inline cudaError_t allow_max_smem(Kernel kernel, int dev, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, bool> done;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  if (done.count(key)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[key] = true;
  return err;
}

// Clusters of `cluster` blocks of `kernel` at `smem` bytes that the device
// holds at once; asked once per (kernel, device, cluster, smem).
template <typename Kernel>
inline cudaError_t active_clusters(Kernel kernel, int dev, int cluster,
                                   int threads, int smem, int* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> cache;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), dev,
                                   cluster, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    it = cache.emplace(key, n > 0 ? n : 1).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// Blocks of `threads` threads and `smem` bytes one SM holds at once.
inline int blocks_per_sm(const DeviceInfo& d, int threads, int smem) {
  const int by_threads = d.threads_sm / threads;
  const int by_smem = d.smem_sm / (smem + d.smem_reserved);
  const int n = by_threads < by_smem ? by_threads : by_smem;
  return n > 0 ? n : 1;
}

// How M columns of hist_size bins are laid out over blocks: column groups
// whose bins (and, per column, lut_ints_per_col ints of table) fit one
// block; when a single column's bins do not, one column per group, its
// bins split over a cluster of blocks.  A group in one block counts with
// local shared-memory atomics; a cluster's blocks count into each other's
// shared memory, which an H100 took about ten times slower (PERF.md), so
// clusters serve only the bins no block holds.
struct BinPlan {
  int group = 0;    // columns of one group (the last may hold fewer)
  int groups = 0;   // column groups
  int cluster = 0;  // blocks sharing one group's bins
  int slice = 0;    // entries kept by one block
};

inline bool plan_bins(int m, int hist_size, int smem_block,
                      int lut_ints_per_col, BinPlan* p) {
  const int64_t cap = smem_block / 4;  // ints of one block's shared memory
  const int64_t fit = cap / (hist_size + int64_t(lut_ints_per_col));
  if (fit >= 1) {
    int g = m < fit ? m : static_cast<int>(fit);
    p->groups = (m + g - 1) / g;
    p->group = (m + p->groups - 1) / p->groups;  // balance the groups
    p->cluster = 1;
    p->slice = p->group * hist_size;
    return true;
  }
  const int64_t room = cap - lut_ints_per_col;
  p->group = 1;
  p->groups = m;
  p->cluster = static_cast<int>((hist_size + room - 1) / room);
  p->slice = (hist_size + p->cluster - 1) / p->cluster;
  return p->cluster <= kMaxCluster;
}

// Launch `kernel` as clusters of `cluster` blocks along x (plain launch
// when cluster == 1).
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                          int smem, cudaStream_t stream, int cluster,
                          Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (cluster > 1) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// ---------------------------------------------------------------- device

// All threads of the block (kCluster: of the cluster) arrive here before
// any goes on: after zeroing, every peer's bins exist; after counting,
// every count has landed.
template <bool kCluster>
__device__ __forceinline__ void bins_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// `bins` sits on 16 bytes: zeroed four entries a store
template <bool kCluster>
__device__ __forceinline__ void bins_zero(int32_t* bins, int slice) {
  int4* b4 = reinterpret_cast<int4*>(bins);
  for (int i = threadIdx.x; i < slice / 4; i += blockDim.x) {
    b4[i] = make_int4(0, 0, 0, 0);
  }
  for (int i = slice / 4 * 4 + threadIdx.x; i < slice; i += blockDim.x) {
    bins[i] = 0;
  }
  bins_sync<kCluster>();
}

// The entry of `key`: in this block's bins, or (kCluster) in the bins of
// the cluster block that keeps it.
template <bool kCluster>
__device__ __forceinline__ int32_t* bin_of(int32_t* bins, int slice,
                                           int key) {
  if constexpr (kCluster) {
    const int owner = key / slice;
    return cg::this_cluster().map_shared_rank(bins + (key - owner * slice),
                                              owner);
  } else {
    return bins + key;
  }
}

// Add one to `key` (key < 0: nothing).  Merging the lanes of a warp that
// hold the same key first (__match_any_sync, the leader adding the count)
// was measured on an H100 and dropped: it made the run engine's plane 5x
// slower, real CTCF scores included (PERF.md).
template <bool kCluster>
__device__ __forceinline__ void bins_count(int32_t* bins, int slice,
                                           int key) {
  if (key >= 0) atomicAdd(bin_of<kCluster>(bins, slice, key), 1);
}

// Hand each non-zero entry of this block's bins to flush(key, count);
// `first` is the block's first key and `entries` the group's count of
// keys.  Lanes take neighbouring entries, so a warp's global atomics land
// on neighbouring addresses (reading four entries a lane spread them over
// 512 bytes and made the flush slower on an H100).
template <typename Flush>
__device__ __forceinline__ void bins_flush(const int32_t* bins, int slice,
                                           int first, int entries,
                                           Flush flush) {
  const int end = entries - first < slice ? entries - first : slice;
  for (int i = threadIdx.x; i < end; i += blockDim.x) {
    const int count = bins[i];
    if (count) flush(first + i, count);
  }
}

// This block's first key: its rank in the cluster times the slice.
template <bool kCluster>
__device__ __forceinline__ int bins_first_key(int slice) {
  if constexpr (kCluster) {
    return static_cast<int>(cg::this_cluster().block_rank()) * slice;
  } else {
    return 0;
  }
}

}  // namespace grafimo
