// Fused scoring and counting of 2-bit packed k-windows, per motif column,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel grafimo_tpu/ops/pallas_scan.py::pallas_score_packed
// (body _scan_kernel), the fused form of
// grafimo_tpu/ops/score_jax.py::score_and_histogram_packed's scoring, and
// takes in the histogram that follows it there.  Contract, over packed
// (B, W8) uint8 with W8 = ceil(k/4), flags (B,) uint8, lut (k, 4, M) int32
// and min_scores (M,) int32:
//
//   code(b, j) = (packed[b, j/4] >> 2*(j%4)) & 3          (ops/pack.py)
//   out[b, c]  = sum_{j<k} lut[j, code(b, j), c]
//   flag 1 (window holds an N)  -> out[b, c] = min_scores[c]
//   flag 2 (padding row)        -> out[b, c] = -1
//
// into out (B, M) int32, and, when a histogram is given,
//
//   hist[min(out[b, c], hist_size - 1), c] += 1   for every out[b, c] >= 0
//
// into a caller-owned (hist_size, M) int64 running histogram: the
// reference's clamp-then-count (score_jax.py:75-77), summed over calls.
// k and M are run-time arguments: one build serves every motif width and
// column count.
//
// Why the design differs from the TPU kernel.  The Pallas kernel unpacks in
// shift-major order against a host-permuted PWM and sums through four
// masked float32 matmuls on B padded to a multiple of 1024: Mosaic has no
// cheap gather and the MXU is where a TPU sums.  None of that carries over.
// Here one thread scores one window: it reads the row's ceil(k/4) bytes
// once, walks its k codes and adds int32 LUT entries from shared memory --
// no float, no TF32, exact for any entry in [0, 1020] -- and B is any
// count.  Columns are summed in register groups of RG = 1, 2, 4 or 8, a
// template parameter chosen from M at launch.
//
// What bounds it on the card.  Per window ceil(k/4) + 1 bytes in and 4*M
// bytes out (14 bytes at k = 19, M = 1: 37 KB for the window engine's
// 2,653-row region batch, ~0.01 us at 3.35 TB/s; 3.7 MB for 2^18 rows),
// plus k shared-memory loads per column.  At the window engine's batch
// sizes the launches are the cost: before this kernel counted, a region
// took a copy in, the scoring kernel, a clamp, a zero fill, the histogram
// kernel, a copy out and an int64 add.  Now it takes a copy in, this one
// launch and a copy out:
//
// - each block counts its windows' clamped scores into a histogram in
//   shared memory (bins.cuh: columns whose bins outgrow a block go in
//   column groups along the grid's y, and a column whose bins alone
//   outgrow a block, k > 56, is split over a thread-block cluster) and
//   adds its non-zero bins straight into the int64 running histogram with
//   64-bit atomics, once;
// - the LUT of a block's columns sits beside the bins in shared memory;
//   column groups along y also keep a large LUT (k = 60, M = 300) there;
// - a thread loads its row's bytes together (k <= 32), not one after
//   another, so a small batch's few warps do not wait on a chain of loads;
// - device attributes and the shared-memory opt-in are read and set on
//   the first launch on a device and cached.
//
// Without a histogram (score_batch's scores only) the same kernel runs
// with counting compiled out.

#include "bins.cuh"

namespace {

using namespace grafimo;

constexpr int kThreads = 512;
// windows a counting block scores at least: two a thread, so a region
// batch of a few thousand rows spreads over a few SMs, whose zero + flush
// of a whole histogram run side by side
constexpr int64_t kMinRowsPerBlock = 2 * kThreads;

// The row's codes as one word, 2 bits a base, base j at bits [2j, 2j + 2):
// its ceil(k/4) bytes loaded together rather than one after another.
// k <= 32 only.
__device__ __forceinline__ uint64_t row_bits(const uint8_t* src, int w8) {
  uint64_t bits = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q < w8) bits |= static_cast<uint64_t>(__ldg(src + q)) << (8 * q);
  }
  return bits;
}

template <int RG, bool kCount, bool kCluster>
__global__ void __launch_bounds__(kThreads)
scan_packed_kernel(const uint8_t* __restrict__ packed,
                   const uint8_t* __restrict__ flags,
                   const int32_t* __restrict__ lut,
                   const int32_t* __restrict__ min_scores, int64_t b, int k,
                   int w8, int m, int g, int slice, int hist_size,
                   int32_t* __restrict__ out,
                   unsigned long long* __restrict__ hist) {
  extern __shared__ int32_t smem[];
  const int g0 = blockIdx.y * g;
  const int gw = m - g0 < g ? m - g0 : g;  // columns of this group
  // this group's LUT, slut[(j * 4 + code) * gw + c]; the bins follow it
  int32_t* slut = smem;
  int32_t* bins = smem + k * 4 * g;
  const int lut_n = k * 4 * gw;
  for (int i = threadIdx.x; i < lut_n; i += blockDim.x) {
    const int jc = i / gw;
    slut[i] = __ldg(lut + jc * m + g0 + (i - jc * gw));
  }
  if constexpr (kCount) {
    bins_zero<kCluster>(bins, slice);  // its barrier covers the LUT too
  } else {
    __syncthreads();
  }

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < b; row += stride) {
    const int f = __ldg(flags + row);
    const uint8_t* src = packed + row * w8;
    int32_t* dst = out + row * m + g0;
    const uint64_t bits = f == 0 && k <= 32 ? row_bits(src, w8) : 0;
    for (int c0 = 0; c0 < gw; c0 += RG) {
      int32_t acc[RG];
      if (f == 0 && k <= 32) {
#pragma unroll
        for (int r = 0; r < RG; ++r) acc[r] = 0;
        for (int j = 0; j < k; ++j) {
          const int code = static_cast<int>(bits >> (2 * j)) & 3;
          const int32_t* e = slut + (j * 4 + code) * gw + c0;
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            if (c0 + r < gw) acc[r] += e[r];
          }
        }
      } else if (f == 0) {
#pragma unroll
        for (int r = 0; r < RG; ++r) acc[r] = 0;
        for (int q = 0; q < w8; ++q) {
          const unsigned byte = __ldg(src + q);
          const int jn = (k - 4 * q) < 4 ? (k - 4 * q) : 4;
          for (int t = 0; t < jn; ++t) {
            const int code = (byte >> (2 * t)) & 3;
            const int32_t* e = slut + ((4 * q + t) * 4 + code) * gw + c0;
#pragma unroll
            for (int r = 0; r < RG; ++r) {
              if (c0 + r < gw) acc[r] += e[r];
            }
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          acc[r] = (f == 1 && c0 + r < gw) ? __ldg(min_scores + g0 + c0 + r)
                                           : -1;
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        if (c0 + r < gw) dst[c0 + r] = acc[r];
      }
      if constexpr (kCount) {
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          if (c0 + r < gw && acc[r] >= 0) {
            const int bin = acc[r] < hist_size ? acc[r] : hist_size - 1;
            bins_count<kCluster>(bins, slice, bin * gw + c0 + r);
          }
        }
      }
    }
  }

  if constexpr (kCount) {
    bins_sync<kCluster>();
    bins_flush(bins, slice, bins_first_key<kCluster>(slice), gw * hist_size,
               [=](int key, int count) {
                 const int bin = key / gw;
                 atomicAdd(hist + static_cast<int64_t>(bin) * m + g0 +
                               (key - bin * gw),
                           static_cast<unsigned long long>(count));
               });
  }
}

struct Args {
  const uint8_t* packed;
  const uint8_t* flags;
  const int32_t* lut;
  const int32_t* min_scores;
  int64_t b;
  int k;
  int m;
  int hist_size;
  int32_t* out;
  unsigned long long* hist;
};

template <int RG, bool kCount, bool kCluster>
cudaError_t launch_scan(const DeviceInfo& d, int dev, const Args& a,
                        const BinPlan& plan, cudaStream_t stream) {
  auto kernel = scan_packed_kernel<RG, kCount, kCluster>;
  cudaError_t err = allow_max_smem(kernel, dev, d.smem_block);
  if (err != cudaSuccess) return err;
  const int smem = (a.k * 4 * plan.group + (kCount ? plan.slice : 0)) * 4;
  int units;  // clusters (or blocks) the device holds at once
  if (kCluster) {
    err = active_clusters(kernel, dev, plan.cluster, kThreads, smem, &units);
    if (err != cudaSuccess) return err;
  } else {
    units = d.sms * blocks_per_sm(d, kThreads, smem);
  }
  const int64_t rows_per_block = kCount ? kMinRowsPerBlock : kThreads;
  int64_t per_group = units / plan.groups;
  const int64_t by_rows = (a.b + rows_per_block * plan.cluster - 1) /
                          (rows_per_block * plan.cluster);
  if (per_group > by_rows) per_group = by_rows;
  if (per_group < 1) per_group = 1;
  const dim3 grid(static_cast<unsigned>(per_group * plan.cluster),
                  static_cast<unsigned>(plan.groups));
  return launch(kernel, grid, kThreads, smem, stream, plan.cluster, a.packed,
                a.flags, a.lut, a.min_scores, a.b, a.k, (a.k + 3) / 4, a.m,
                plan.group, plan.slice, a.hist_size, a.out, a.hist);
}

template <int RG>
cudaError_t dispatch(const DeviceInfo& d, int dev, const Args& a,
                     const BinPlan& plan, cudaStream_t s) {
  if (a.hist == nullptr) return launch_scan<RG, false, false>(d, dev, a, plan,
                                                              s);
  if (plan.cluster > 1) return launch_scan<RG, true, true>(d, dev, a, plan, s);
  return launch_scan<RG, true, false>(d, dev, a, plan, s);
}

}  // namespace

// Score `b` packed windows into `out` and, when `hist` is not null, add
// their clamped scores to the int64 running histogram `hist` (hist_size
// bins), on `stream` (a cudaStream_t passed as void*) on device `dev`,
// which must be current.  Returns the cudaError_t of the launch (0 =
// success); it does not synchronise.
extern "C" int grafimo_scan_packed(const void* packed, const void* flags,
                                   const void* lut, const void* min_scores,
                                   long long b, int k, int m, void* out,
                                   void* hist, int hist_size, int dev,
                                   void* stream) {
  if (b <= 0 || m <= 0) return 0;
  if (k <= 0 || m > 65535 || (hist != nullptr && hist_size <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceInfo* d = nullptr;
  cudaError_t err = device_info(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  BinPlan plan;
  if (hist != nullptr) {
    if (!plan_bins(m, hist_size, d->smem_block, 4 * k, &plan)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    // scores only: column groups whose LUT fits a block
    const int fit = d->smem_block / (16 * k);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int g = m < fit ? m : fit;
    plan.groups = (m + g - 1) / g;
    plan.group = (m + plan.groups - 1) / plan.groups;
    plan.cluster = 1;
    plan.slice = 0;
  }
  const Args a{static_cast<const uint8_t*>(packed),
               static_cast<const uint8_t*>(flags),
               static_cast<const int32_t*>(lut),
               static_cast<const int32_t*>(min_scores),
               static_cast<int64_t>(b), k, m, hist_size,
               static_cast<int32_t*>(out),
               static_cast<unsigned long long*>(hist)};
  auto s = static_cast<cudaStream_t>(stream);
  if (plan.group == 1) {
    err = dispatch<1>(*d, dev, a, plan, s);
  } else if (plan.group == 2) {
    err = dispatch<2>(*d, dev, a, plan, s);
  } else if (plan.group <= 4) {
    err = dispatch<4>(*d, dev, a, plan, s);
  } else {
    err = dispatch<8>(*d, dev, a, plan, s);
  }
  return static_cast<int>(err);
}
