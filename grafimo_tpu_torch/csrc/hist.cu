// Exact integer score histogram, per motif column, for Hopper (sm_90a).
//
// Replaces the TPU kernel grafimo_tpu/ops/pallas_hist.py::hist_pallas
// (body _hist_kernel), which the TPU scan runs through
// ops/score_runs.py::_exact_hist in its "bf16lo128" mode, and the layout
// variants hist_pallas2-4 of the same contract:
//
//   out[b, c] = #{ n : scores[n, c] == b },   0 <= b < hist_size
//
// over scores viewed as a contiguous (N, M) int32 array.  Values below 0
// (invalid windows) and at or above hist_size are dropped, as the TPU
// kernel drops its spill row and cuts bins >= hist_size.  With bases (an
// (M,) int32 array, or null), each score is first remapped as it is loaded
// to the run engine's compressed bin: s < 0 ? -1 : max(s - bases[c] + 1, 0)
// (grafimo_tpu/ops/score_runs.py _finish_scores :514-518), so the scan
// hands over its masked scores and no pass over the plane remaps them.
// The output is
// (hist_size, M) int32; the entry zeroes it (cudaMemsetAsync on the
// launch stream) before counting.  hist_size and M are run-time values.
//
// Why the design differs from the TPU kernel.  The TPU has no fast
// scatter, so the Pallas kernel turns counting into a one-hot(hi)^T x
// one-hot(lo) matmul on the MXU over a sequential grid.  Hopper has fast
// shared-memory atomics, so counting is counting, into a histogram each
// block (or cluster) keeps in shared memory and flushes once.
//
// What bounds it on the card: the bytes of the score plane, read once
// (33 MB on the run engine's (2048, 2030, 2) batches: 10 us at 3.35 TB/s),
// and, on real scores, atomics that collide on the few hundred bins around
// a motif's mean score.  At the window engine's 2,653-row batches the work
// is under a microsecond and the launch is the cost.  What the design
// does about each:
//
// - One read of the plane.  Blocks walk the flat N*M plane, 16 bytes a
//   thread (the column is the flat index mod M, kept incrementally), and a
//   block counts every column of its group, so the plane is read once and
//   contiguously.  The grid is persistent: as many blocks as the SMs hold
//   at once, fewer when the input is small (each block zeroes and flushes
//   a whole histogram).
// - Columns whose bins outgrow a block (M = 16 at k = 19: 1.2 MB) are
//   counted in column groups, each in one block's shared memory.  The
//   blocks of all groups are interleaved along the grid, so the groups
//   read the same rows at the same time and all but the first read of a
//   row hit L2.
// - A column whose bins outgrow a block (k > 56) has them split across a
//   thread-block cluster of up to 8 blocks; each block counts into the
//   owner block's shared memory (distributed shared memory).  Each block
//   flushes its non-zero bins once, with int32 atomics.
// - Colliding atomics: real scores pile up on a few thousand bins, but
//   shared-memory atomics take them at close to the read rate; merging
//   equal bins within a warp first cost more than it saved (PERF.md).
// - Host cost: device attributes and the shared-memory opt-in are set on
//   the first launch on a device and cached; a launch is one memset and
//   one kernel.
//
// Integer atomics commute, so the result is bit-identical to the plain
// version on every run.

#include "bins.cuh"

namespace {

using namespace grafimo;

constexpr int kThreads = 1024;
// entries a block counts at least: its zero + flush of a whole histogram
// must not cost more than the counting
constexpr int64_t kMinPerBlock = 16384;

// The base of group column `c` (kBases), staged in shared memory.
template <bool kBases>
__device__ __forceinline__ int base_of(const int32_t* sbase, int c) {
  if constexpr (kBases) {
    return sbase[c];
  } else {
    return 0;
  }
}

// Score v as the value it is counted by: remapped by its column's base
// when kBases, else as it is.
template <bool kBases>
__device__ __forceinline__ int remap(int v, int base) {
  if constexpr (kBases) {
    if (v < 0) return -1;
    const int h = v - base + 1;
    return h > 0 ? h : 0;
  } else {
    return v;
  }
}

template <bool kCluster>
__device__ __forceinline__ void count_value(int32_t* bins, int slice, int v,
                                            int c, int g, int hist_size) {
  // one unsigned compare drops both v < 0 and v >= hist_size
  const int key =
      static_cast<unsigned>(v) < static_cast<unsigned>(hist_size) ? v * g + c
                                                                   : -1;
  bins_count<kCluster>(bins, slice, key);
}

// Column groups of `g` columns, `groups` of them: unit u (a cluster of
// `cluster` blocks, or one block) counts group u % groups, in part
// u / groups of its rows.  `aligned`: scores sit on 16 bytes (vector loads
// of the flat plane).  kBases: remap each score by `bases` on load; the
// group's bases follow the bins in shared memory, and a lane keeps those of
// its columns in registers while the grid's stride leaves its columns
// fixed (a group of a power-of-two width divides the stride).
template <bool kCluster, bool kBases>
__global__ void __launch_bounds__(kThreads)
exact_hist_kernel(const int32_t* __restrict__ scores, int64_t n, int m,
                  int hist_size, const int32_t* __restrict__ bases, int g,
                  int groups, int cluster, int slice, int aligned,
                  int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  int32_t* sbase = bins + slice;
  const int unit = blockIdx.x / cluster;
  const int g0 = unit % groups * g;
  const int gw = m - g0 < g ? m - g0 : g;  // columns of this group
  if constexpr (kBases) {
    for (int i = threadIdx.x; i < gw; i += blockDim.x) {
      sbase[i] = __ldg(bases + g0 + i);
    }
  }
  bins_zero<kCluster>(bins, slice);  // its barrier covers the bases too

  const int lane = threadIdx.x & 31;
  // the group's blocks split its rows; in a cluster, like any others
  const int64_t block = static_cast<int64_t>(unit / groups) * cluster +
                        blockIdx.x % cluster;
  const int64_t n_blocks = static_cast<int64_t>(gridDim.x) / groups;
  const int64_t warp = (block * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (n_blocks * blockDim.x) >> 5;
  if (gw == m) {
    // the flat plane: element e is column e mod m
    const int64_t total = n * m;
    const int64_t n_vec = aligned ? total / 4 : 0;
    const int4* v4 = reinterpret_cast<const int4*>(scores);
    const int64_t step = n_warps * 32 * 4;
    const int step_c = static_cast<int>(step % m);
    int c = static_cast<int>(((warp * 32 + lane) * 4) % m);
    int c1 = c + 1 == m ? 0 : c + 1;
    int c2 = c1 + 1 == m ? 0 : c1 + 1;
    int c3 = c2 + 1 == m ? 0 : c2 + 1;
    int b0 = base_of<kBases>(sbase, c), b1 = base_of<kBases>(sbase, c1);
    int b2 = base_of<kBases>(sbase, c2), b3 = base_of<kBases>(sbase, c3);
    for (int64_t w = warp; w * 32 < n_vec; w += n_warps) {
      const int64_t i = w * 32 + lane;
      int4 x = make_int4(-1, -1, -1, -1);
      if (i < n_vec) x = __ldg(v4 + i);
      count_value<kCluster>(bins, slice, remap<kBases>(x.x, b0), c, m,
                            hist_size);
      count_value<kCluster>(bins, slice, remap<kBases>(x.y, b1), c1, m,
                            hist_size);
      count_value<kCluster>(bins, slice, remap<kBases>(x.z, b2), c2, m,
                            hist_size);
      count_value<kCluster>(bins, slice, remap<kBases>(x.w, b3), c3, m,
                            hist_size);
      if (step_c) {  // uniform over the grid
        c += step_c;
        if (c >= m) c -= m;
        c1 = c + 1 == m ? 0 : c + 1;
        c2 = c1 + 1 == m ? 0 : c1 + 1;
        c3 = c2 + 1 == m ? 0 : c2 + 1;
        b0 = base_of<kBases>(sbase, c), b1 = base_of<kBases>(sbase, c1);
        b2 = base_of<kBases>(sbase, c2), b3 = base_of<kBases>(sbase, c3);
      }
    }
    // the tail past the last whole vector (all of it when unaligned)
    const int64_t done = n_vec * 4;
    const int step1_c = static_cast<int>((n_warps * 32) % m);
    c = static_cast<int>((done + warp * 32 + lane) % m);
    for (int64_t w = warp; done + w * 32 < total; w += n_warps) {
      const int64_t e = done + w * 32 + lane;
      const int v = e < total ? __ldg(scores + e) : -1;
      count_value<kCluster>(bins, slice,
                            remap<kBases>(v, base_of<kBases>(sbase, c)), c, m,
                            hist_size);
      c += step1_c;
      if (c >= m) c -= m;
    }
  } else {
    // one group of several: its columns of each row
    const int64_t total = n * gw;
    const int64_t step = n_warps * 32;
    const int64_t step_r = step / gw;
    const int step_c = static_cast<int>(step % gw);
    int64_t e0 = warp * 32 + lane;
    int64_t row = e0 / gw;
    int c = static_cast<int>(e0 - row * gw);
    int bc = base_of<kBases>(sbase, c);
    for (int64_t w = warp; w * 32 < total; w += n_warps) {
      const int64_t e = w * 32 + lane;
      const int v = e < total ? __ldg(scores + row * m + g0 + c) : -1;
      count_value<kCluster>(bins, slice, remap<kBases>(v, bc), c, gw,
                            hist_size);
      row += step_r;
      if (step_c) {  // uniform over the grid
        c += step_c;
        if (c >= gw) {
          c -= gw;
          ++row;
        }
        bc = base_of<kBases>(sbase, c);
      }
    }
  }

  bins_sync<kCluster>();
  bins_flush(bins, slice, bins_first_key<kCluster>(slice), gw * hist_size,
             [=](int key, int count) {
               int64_t dst = key;
               if (gw != m) {
                 const int b = key / gw;
                 dst = static_cast<int64_t>(b) * m + g0 + (key - b * gw);
               }
               atomicAdd(out + dst, count);
             });
}

template <bool kCluster, bool kBases>
cudaError_t launch_hist(const DeviceInfo& d, int dev, const int32_t* scores,
                        int64_t n, int m, int hist_size, const int32_t* bases,
                        const BinPlan& plan, int32_t* out,
                        cudaStream_t stream) {
  auto kernel = exact_hist_kernel<kCluster, kBases>;
  cudaError_t err = allow_max_smem(kernel, dev, d.smem_block);
  if (err != cudaSuccess) return err;
  const int smem = (plan.slice + (kBases ? plan.group : 0)) * 4;
  int units;  // clusters (or blocks) the device holds at once
  if (kCluster) {
    err = active_clusters(kernel, dev, plan.cluster, kThreads, smem, &units);
    if (err != cudaSuccess) return err;
  } else {
    units = d.sms * blocks_per_sm(d, kThreads, smem);
  }
  // split the resident units over the groups, and keep each block's share
  // of its group's entries above kMinPerBlock
  int64_t per_group = units / plan.groups;
  const int64_t by_work =
      (n * plan.group + kMinPerBlock * plan.cluster - 1) /
      (kMinPerBlock * plan.cluster);
  if (per_group > by_work) per_group = by_work;
  if (per_group < 1) per_group = 1;
  const int64_t blocks = per_group * plan.cluster * plan.groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int aligned = (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  return launch(kernel, dim3(static_cast<unsigned>(blocks)), kThreads, smem,
                stream, plan.cluster, scores, n, m, hist_size, bases,
                plan.group, plan.groups, plan.cluster, plan.slice, aligned,
                out);
}

}  // namespace

// Zero `out` and count `scores` into it on `stream` (a cudaStream_t passed
// as void*), on device `dev`, which must be current; `bases` ((m,) int32)
// remaps each score on load, or is null.  Returns the cudaError_t of the
// memset or launch (0 = success); it does not synchronise.
extern "C" int grafimo_exact_hist(const void* scores, long long n, int m,
                                  int hist_size, const void* bases, void* out,
                                  int dev, void* stream) {
  if (m <= 0 || hist_size <= 0) return 0;
  if (m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(out);
  cudaError_t err = cudaMemsetAsync(
      o, 0, static_cast<size_t>(hist_size) * m * sizeof(int32_t), s);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const DeviceInfo* d = nullptr;
  err = device_info(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  BinPlan plan;
  const auto* bs = static_cast<const int32_t*>(bases);
  // with bases, each column also keeps its base in shared memory
  if (!plan_bins(m, hist_size, d->smem_block, bs ? 1 : 0, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sc = static_cast<const int32_t*>(scores);
  const int64_t rows = static_cast<int64_t>(n);
  if (plan.cluster > 1) {
    err = bs ? launch_hist<true, true>(*d, dev, sc, rows, m, hist_size, bs,
                                       plan, o, s)
             : launch_hist<true, false>(*d, dev, sc, rows, m, hist_size, bs,
                                        plan, o, s);
  } else {
    err = bs ? launch_hist<false, true>(*d, dev, sc, rows, m, hist_size, bs,
                                        plan, o, s)
             : launch_hist<false, false>(*d, dev, sc, rows, m, hist_size, bs,
                                         plan, o, s);
  }
  return static_cast<int>(err);
}

// The largest hist_size a column of the kernels can hold (one cluster of
// kMaxCluster blocks), or 0 when `dev` cannot be queried.
extern "C" int grafimo_max_hist_size(int dev) {
  const DeviceInfo* d = nullptr;
  if (device_info(dev, &d) != cudaSuccess) return 0;
  return kMaxCluster * (d->smem_block / 4);
}

extern "C" const char* grafimo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
