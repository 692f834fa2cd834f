// Exact integer score histogram, per motif column, for Hopper (sm_90a).
//
// Replaces the TPU kernel grafimo_tpu/ops/pallas_hist.py::hist_pallas
// (body _hist_kernel), which the TPU scan runs through
// ops/score_runs.py::_exact_hist in its "bf16lo128" mode.  Contract:
//
//   out[b, c] = #{ n : scores[n, c] == b },   0 <= b < hist_size
//
// over scores viewed as a contiguous (N, M) int32 array.  Values below 0
// (invalid windows) and at or above hist_size are dropped, as the TPU
// kernel drops its spill row and cuts bins >= hist_size.  The output is
// (hist_size, M) int32 and must be zeroed by the caller.  hist_size and
// M are run-time arguments: one build serves every motif width and
// column count, including M > 16, where the TPU kernel stops.
//
// Why the design differs from the TPU kernel.  The TPU has no fast
// scatter, so the Pallas kernel turns counting into a one-hot(hi)^T x
// one-hot(lo) matmul on the MXU over a sequential grid.  Hopper has
// fast shared-memory atomics, so counting is counting: each block keeps
// a private int32 histogram of hist_size bins in dynamic shared memory
// (76 KB at k = 19, which needs the opt-in attribute above 48 KB),
// counts its chunk of rows for one column with shared atomics, then
// adds its non-zero bins to the global histogram with global atomics.
// When hist_size * 4 bytes exceeds the block's shared memory (k > 58 on
// an H100), the same kernel counts straight into global memory.
// Integer atomics are exact in any order, so the result is bit-identical
// to the plain version on every run.
//
// What bounds it on the card.  (1) Shared-memory atomic contention:
// real score distributions pile most windows onto a few hundred bins
// around the motif's mean score, so lanes of a warp often hit the same
// bin and their atomics serialise.  (2) Global reads: the grid is
// (row chunks, M), so each column's blocks read the whole (N, M) score
// plane at a stride of M ints -- 4*M bytes fetched per window per
// column, served mostly from L2 for small M.  This first version keeps
// the simple form; warp-aggregated atomics, several columns per block
// and fusing the histogram into the scoring pass are later work once
// card measurements show where the time goes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// rows a block counts at least: below this the per-block zero + flush
// of hist_size bins costs more than the counting itself
constexpr int64_t kMinRowsPerBlock = 8192;

__global__ void __launch_bounds__(kThreads)
exact_hist_kernel(const int32_t* __restrict__ scores, int64_t n, int m,
                  int hist_size, int32_t* __restrict__ out,
                  int64_t rows_per_block, int use_smem) {
  extern __shared__ int32_t bins[];
  const int col = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = row0 + rows_per_block;
  const int64_t row1 = row_end < n ? row_end : n;
  if (use_smem) {
    for (int b = threadIdx.x; b < hist_size; b += blockDim.x) bins[b] = 0;
    __syncthreads();
  }
  for (int64_t r = row0 + threadIdx.x; r < row1; r += blockDim.x) {
    const int v = __ldg(scores + r * m + col);
    // one unsigned compare drops both v < 0 and v >= hist_size
    if (static_cast<unsigned>(v) < static_cast<unsigned>(hist_size)) {
      if (use_smem) {
        atomicAdd(bins + v, 1);
      } else {
        atomicAdd(out + static_cast<int64_t>(v) * m + col, 1);
      }
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int b = threadIdx.x; b < hist_size; b += blockDim.x) {
      const int c = bins[b];
      if (c) atomicAdd(out + static_cast<int64_t>(b) * m + col, c);
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*).  Returns the
// cudaError_t of the launch (0 = success); it does not synchronise.
extern "C" int grafimo_exact_hist(const void* scores, long long n, int m,
                                  int hist_size, void* out, void* stream) {
  if (n <= 0 || m <= 0 || hist_size <= 0) return 0;
  if (m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = static_cast<size_t>(hist_size) * sizeof(int32_t);
  const int use_smem = smem <= static_cast<size_t>(smem_optin) ? 1 : 0;
  if (use_smem) {
    err = cudaFuncSetAttribute(exact_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    smem = 0;
  }
  // about two blocks per SM over all columns, each with enough rows to
  // amortise its zero + flush
  const int64_t want = (2LL * sms + m - 1) / m;
  const int64_t by_rows = (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  int64_t gx = want < by_rows ? want : by_rows;
  if (gx < 1) gx = 1;
  const int64_t rows_per_block = (n + gx - 1) / gx;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(m));
  exact_hist_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(scores), static_cast<int64_t>(n), m,
      hist_size, static_cast<int32_t*>(out), rows_per_block, use_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grafimo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
