// Fused scoring of 2-bit packed k-windows, per motif column, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel grafimo_tpu/ops/pallas_scan.py::pallas_score_packed
// (body _scan_kernel), the fused form of
// grafimo_tpu/ops/score_jax.py::score_and_histogram_packed's scoring.
// Contract, over packed (B, W8) uint8 with W8 = ceil(k/4), flags (B,) uint8,
// lut (k, 4, M) int32 and min_scores (M,) int32:
//
//   code(b, j) = (packed[b, j/4] >> 2*(j%4)) & 3          (ops/pack.py)
//   out[b, c]  = sum_{j<k} lut[j, code(b, j), c]
//   flag 1 (window holds an N)  -> out[b, c] = min_scores[c]
//   flag 2 (padding row)        -> out[b, c] = -1
//
// into out (B, M) int32.  k and M are run-time arguments: one build serves
// every motif width and column count.
//
// Why the design differs from the TPU kernel.  The Pallas kernel unpacks in
// shift-major order against a host-permuted PWM and sums through four
// masked float32 matmuls on B padded to a multiple of 1024: Mosaic has no
// cheap gather and the MXU is where a TPU sums.  None of that carries over.
// Here one thread scores one window: it reads the row's ceil(k/4) bytes
// once, walks its k codes and adds int32 LUT entries -- no float, no TF32,
// exact for any entry in [0, 1020] -- and B is any count.  The (k, 4, M)
// LUT is staged in shared memory (k*4*M*4 bytes; 304 B at k = 19, M = 1),
// or read from global memory through the read-only cache when it does not
// fit a block.  Columns are summed in register groups of G = 1, 2, 4 or 8,
// a template parameter chosen from M at launch.
//
// What bounds it on the card.  Per window about ceil(k/4) + 1 bytes in and
// 4*M bytes out (10 + 4 bytes at k = 19, M = 1: 3.7 MB for 2^18 windows,
// ~1 us at 3.35 TB/s), and k shared-memory loads per column.  At the
// window engine's batch sizes it is launch- and memory-bound; the shared
// LUT lookups are scattered by code but conflict-free across a warp for
// M = 1 only by chance.  This first version keeps the simple form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
scan_packed_kernel(const uint8_t* __restrict__ packed,
                   const uint8_t* __restrict__ flags,
                   const int32_t* __restrict__ lut,
                   const int32_t* __restrict__ min_scores, int64_t b, int k,
                   int w8, int m, int32_t* __restrict__ out, int use_smem) {
  extern __shared__ int32_t slut[];
  const int32_t* table = lut;
  if (use_smem) {
    const int n = k * 4 * m;
    for (int i = threadIdx.x; i < n; i += blockDim.x) slut[i] = __ldg(lut + i);
    __syncthreads();
    table = slut;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < b; row += stride) {
    int32_t* dst = out + row * m;
    const int f = __ldg(flags + row);
    if (f == 2) {
      for (int c = 0; c < m; ++c) dst[c] = -1;
      continue;
    }
    if (f == 1) {
      for (int c = 0; c < m; ++c) dst[c] = __ldg(min_scores + c);
      continue;
    }
    const uint8_t* src = packed + row * w8;
    for (int c0 = 0; c0 < m; c0 += G) {
      int32_t acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = 0;
      for (int q = 0; q < w8; ++q) {
        const unsigned byte = __ldg(src + q);
        const int jn = (k - 4 * q) < 4 ? (k - 4 * q) : 4;
        for (int t = 0; t < jn; ++t) {
          const int code = (byte >> (2 * t)) & 3;
          const int32_t* e = table + ((4 * q + t) * 4 + code) * m + c0;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (c0 + g < m) acc[g] += e[g];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (c0 + g < m) dst[c0 + g] = acc[g];
      }
    }
  }
}

template <int G>
cudaError_t launch(const uint8_t* packed, const uint8_t* flags,
                   const int32_t* lut, const int32_t* min_scores, int64_t b,
                   int k, int m, int32_t* out, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  size_t smem = static_cast<size_t>(k) * 4 * m * sizeof(int32_t);
  const int use_smem = smem <= static_cast<size_t>(smem_optin) ? 1 : 0;
  if (use_smem) {
    err = cudaFuncSetAttribute(scan_packed_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  } else {
    smem = 0;
  }
  // one thread per window, capped at 16 blocks per SM; the grid-stride
  // loop takes the rest
  const int64_t by_rows = (b + kThreads - 1) / kThreads;
  const int64_t cap = 16LL * sms;
  const int64_t gx = by_rows < cap ? by_rows : cap;
  scan_packed_kernel<G><<<static_cast<unsigned>(gx), kThreads, smem, stream>>>(
      packed, flags, lut, min_scores, b, k, (k + 3) / 4, m, out, use_smem);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*).  Returns the
// cudaError_t of the launch (0 = success); it does not synchronise.
extern "C" int grafimo_scan_packed(const void* packed, const void* flags,
                                   const void* lut, const void* min_scores,
                                   long long b, int k, int m, void* out,
                                   void* stream) {
  if (b <= 0 || m <= 0) return 0;
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* f = static_cast<const uint8_t*>(flags);
  const auto* l = static_cast<const int32_t*>(lut);
  const auto* mins = static_cast<const int32_t*>(min_scores);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(b);
  cudaError_t err;
  if (m == 1) {
    err = launch<1>(p, f, l, mins, n, k, m, o, s);
  } else if (m == 2) {
    err = launch<2>(p, f, l, mins, n, k, m, o, s);
  } else if (m <= 4) {
    err = launch<4>(p, f, l, mins, n, k, m, o, s);
  } else {
    err = launch<8>(p, f, l, mins, n, k, m, o, s);
  }
  return static_cast<int>(err);
}
