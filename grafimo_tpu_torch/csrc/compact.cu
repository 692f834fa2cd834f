// On-device hit compaction of a block's window scores, for Hopper (sm_90a).
//
// Replaces the hit packaging of the TPU scan: grafimo_tpu/ops/score_runs.py
// _finish_scores' hit bits (:522-528), _topk_package_tiered (:684) and
// absorb_slice (:1000).  Those are XLA, not Pallas: the TPU has no fast
// scatter, so they rank hits with cumsums over packed bytes, extract a
// fixed 32 slots a row (_ROW_SLOTS) and scatter the slots.  Here, over
// scores viewed as (B, Noff, M) int32 and cutoffs (M,):
//
//   hit(b, o, c)  = scores[b, o, c] >= cutoffs[c] && scores[b, o, c] >= 0
//   *count        = #hits
//   idx_a[p]      = the flat index (b * Noff + o) * M + c of hit number p,
//                   p < cap_a; idx_b[p - cap_a] for cap_a <= p < cap_a + cap_b
//   bits[b, o8, c] bit j = hit(b, 8 * o8 + j, c)   (0 past Noff)
//
// Hit numbers are handed out by atomicAdd on the count, so the indices come
// out in no fixed order; the caller sorts them.  The
// capacity is the block's, so the reference's per-row slot limit has no
// counterpart: a block with more hits than cap_a + cap_b is read from its
// bits, which are always written.
//
// What bounds it on the card: the bytes of the score plane, read once (33
// MB on the run engine's (2048, 2030, 2) blocks: 10 us at 3.35 TB/s), plus
// the bits written (1/32 of that).  Real scans hold about one hit in 10^4
// windows, so index stores cost nothing; a dense block (-t 1) makes every
// warp take hit numbers.  What the design does about it:
//
// - One read of the plane, no bool mask.  A warp takes 32 consecutive
//   offsets of one row and one column at a time; its ballot is the four
//   bytes of bits of those offsets, which lanes 0-3 store.  Lanes read at a
//   stride of M ints, and the same warp reads the other columns of the
//   same lines next, from L1, so DRAM sees each line once.
// - Few instructions a window: a task is kChunks such chunks of one row,
//   so the row and offset come from one division per task, and a warp
//   issues the loads of all kChunks chunks of a column before it tests
//   any, which keeps enough bytes in flight to stream.
// - One atomicAdd per task and column that holds a hit, for the hit
//   numbers of all its chunks.
// - A persistent grid of as many blocks as the SMs hold, fewer when the
//   plane is small.
//
// The count is zeroed on the launch stream before the kernel runs.

#include "bins.cuh"

namespace {

using namespace grafimo;

constexpr int kThreads = 256;
constexpr int kChunks = 8;  // 32-offset chunks of a row per task

__global__ void __launch_bounds__(kThreads)
compact_hits_kernel(const int32_t* __restrict__ scores, unsigned noff,
                    unsigned m, unsigned segs, unsigned tasks,
                    const int32_t* __restrict__ cutoffs,
                    int32_t* __restrict__ count, int32_t* __restrict__ idx_a,
                    int cap_a, int32_t* __restrict__ idx_b, int cap_b,
                    uint8_t* __restrict__ bits) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned nb = (noff + 7) >> 3;  // bytes of bits of a row
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned n_warps = (gridDim.x * blockDim.x) >> 5;
  for (unsigned t = warp; t < tasks; t += n_warps) {
    // task t: chunks [seg * kChunks, (seg + 1) * kChunks) of row t / segs
    const unsigned row = t / segs;
    const unsigned o0 = (t - row * segs) * kChunks * 32;
    const unsigned e0 = row * noff;  // the row's first window
    for (unsigned c = 0; c < m; ++c) {
      int v[kChunks];
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        const unsigned o = o0 + u * 32 + lane;
        v[u] = o < noff ? __ldg(scores + (e0 + o) * m + c) : -1;
      }
      const int cut = __ldg(cutoffs + c);
      unsigned ballot[kChunks];
      int total = 0;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        ballot[u] = __ballot_sync(0xffffffffu, v[u] >= 0 && v[u] >= cut);
        total += __popc(ballot[u]);
        const unsigned o8 = (o0 + u * 32) / 8 + lane;
        if (lane < 4 && o8 < nb) {
          bits[((row * nb) + o8) * m + c] =
              static_cast<uint8_t>(ballot[u] >> (8 * lane));
        }
      }
      if (total == 0) continue;  // the same for every lane of the warp
      int base = 0;
      if (lane == 0) base = atomicAdd(count, total);
      base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        if ((ballot[u] >> lane) & 1u) {
          const int p = base + __popc(ballot[u] & ((1u << lane) - 1u));
          const int e = static_cast<int>((e0 + o0 + u * 32 + lane) * m + c);
          if (p < cap_a) {
            idx_a[p] = e;
          } else if (p - cap_a < cap_b) {
            idx_b[p - cap_a] = e;
          }
        }
        base += __popc(ballot[u]);
      }
    }
  }
}

}  // namespace

// Zero *count and compact the hits of `scores` ((b, noff, m) int32) into
// count, idx_a / idx_b and bits on `stream` (a cudaStream_t passed as
// void*), on device `dev`, which must be current.  The caller keeps
// b * noff * m below 2^31.  Returns the cudaError_t of the memset or launch
// (0 = success); it does not synchronise.
extern "C" int grafimo_compact_hits(const void* scores, int b, int noff,
                                    int m, const void* cutoffs, void* count,
                                    void* idx_a, int cap_a, void* idx_b,
                                    int cap_b, void* bits, int dev,
                                    void* stream) {
  if (b < 0 || noff <= 0 || m <= 0 || cap_a < 0 || cap_b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (err != cudaSuccess || b == 0) return static_cast<int>(err);
  if (static_cast<int64_t>(b) * noff * m >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t segs = ((noff + 31) / 32 + kChunks - 1) / kChunks;
  const int64_t n_tasks = static_cast<int64_t>(b) * segs;
  const DeviceInfo* d = nullptr;
  err = device_info(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps_per_block = kThreads / 32;
  const int64_t by_work = (n_tasks + warps_per_block - 1) / warps_per_block;
  int64_t blocks = static_cast<int64_t>(d->sms) * (d->threads_sm / kThreads);
  if (blocks > by_work) blocks = by_work;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(launch(
      compact_hits_kernel, dim3(static_cast<unsigned>(blocks)), kThreads, 0,
      s, 1, static_cast<const int32_t*>(scores), static_cast<unsigned>(noff),
      static_cast<unsigned>(m), static_cast<unsigned>(segs),
      static_cast<unsigned>(n_tasks),
      static_cast<const int32_t*>(cutoffs), static_cast<int32_t*>(count),
      static_cast<int32_t*>(idx_a), cap_a, static_cast<int32_t*>(idx_b),
      cap_b, static_cast<uint8_t*>(bits)));
}
