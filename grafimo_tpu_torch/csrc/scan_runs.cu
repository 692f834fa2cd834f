// The run engine's scoring core, for Hopper (sm_90a): expand a slice
// block's rows, score every stride-1 window and apply the N and validity
// masks, one launch for any of the five batch kinds.
//
// Replaces what the TPU scan runs in jnp before its histogram (XLA fuses
// it into a few TPU programs; there is no Pallas kernel for it):
// grafimo_tpu/ops/score_runs.py
//   - the window expansion: _aligned_words, _expand_resident,
//     _decode_span, _expand_strided, _expand_resident_bits (:101-173, :230),
//     _apply_patches and _clear_at_patches (:878-938), and the expansion
//     bodies of scan_runs_device_topk (:554), scan_runs_resident_topk
//     (:789), scan_runs_resident_strided_topk (:819),
//     scan_runs_resident_patched_topk (:901) and
//     scan_runs_resident_spliced_topk (:946);
//   - the scoring: _window_scores (:410) and _conv_onehot (:454);
//   - the N and validity masks of _finish_scores (:483-502).
// The histogram remap of _finish_scores (:503-518) is applied by hist.cu
// as it loads each score; the hit bits are compact.cu's.
//
// Contract, for row b of the block, offset o < Noff = R - k + 1 and motif
// column c < M:
//
//   out[b, o, c] = -1                if offset o of row b is not valid
//                = min_scores[c]     else if codes(b, o .. o+k-1) hold an N
//                = sum_j lut[j, code(b, o + j), c]   otherwise
//
// Row b's codes come from (source):
//   kPacked   packed[b, j/4] bits 2(j%4) (4 codes a byte), N bits nbits[b, j/8]
//   kGathered genome position gstart[b] + j
//   kStrided  genome position lo + b * stride + j
// then, in order: the splice pairs (position gstart[b] + shift_s + j for
// the last pair s with bound_s <= j, as int16 with sign extension; bound
// 0x7FFF counts shift 0), the patches (slot p, in slot order: entry e >= 0
// sets code e & 3 at position e >> 2), and, when clear_n is set (the
// spliced kind only, as the reference), the N indicator is cleared at each
// patched position.  Genome codes are 2 bits of the int64 words (holding
// uint32 values) at word floor(p / 16); N bits 1 bit at word floor(p / 32).
// Word indices are clamped into the plane, as the reference clamps its
// gathers: a clamped word only feeds positions the caller masks, and a read
// past the plane would fault.  vbits holds one bit an offset, little-endian
// in a byte.  Integer throughout: no float, no one-hot, so TF32 cannot
// touch a score.
//
// What bounds it on the card.  At the main path's block (8192 rows,
// R = 2048, CTCF forward + reverse complement, M = 2, k = 19) it writes the
// 133 MB score plane (0.040 ms at 3.35 TB/s) and reads ~6 MB of
// descriptors, masks and genome words; and it reads the LUT from shared
// memory 8192 * 2030 * 19 times for M / 2 two-column vectors: at one
// conflict-free warp-wide read per clock per SM (132 SMs at ~1.75 GHz)
// ~0.09 ms.  So the shared-memory reads bound it, then the store stream.
// What the design does about each:
//
// - Each row is expanded once, into shared memory (one byte a code and a
//   32-bit N word per 32 positions, built by a warp ballot), so the k reads
//   of a window's codes are shared-memory reads.  A block owns a row, or
//   up to 8 rows when a row has too few offsets to occupy 256 threads.
// - The LUT tile lives in shared memory, its rows padded to an odd number
//   of V-column vectors, so the four rows that one j can select (one per
//   base) fall in four different banks: a warp's LUT read is conflict-free.
//   Columns are read V = 4, 2 or 1 at a time (the largest that divides M),
//   and a thread sums up to 8 columns in registers per pass over j (one
//   vector when a tile is one vector wide: at M = 2, four vectors a pass
//   issued three dead predicated loads a position: 0.35-0.39 ms on the
//   main path's block on an H100).
// - A thread owns an offset and writes its columns as V-wide vector
//   stores, neighbouring threads on neighbouring offsets, so the plane is
//   written in whole lines.
// - Masked windows (invalid, or covering an N) skip the sum.
// - LUTs too large for the block's budget are tiled over columns along the
//   grid's y dimension; each tile re-expands its rows (a few percent of the
//   scoring work).
//
// k, R, M, the patch slots and the splice pairs are run-time values: one
// build serves every shape.

#include "bins.cuh"

namespace {

using namespace grafimo;

constexpr int kThreads = 256;
constexpr int kMaxRowsPerBlock = 8;
constexpr int kAccInts = 8;            // columns a thread sums per pass
constexpr int kLutBudget = 96 * 1024;  // shared-memory bytes for a LUT tile

enum Source : int { kPacked = 0, kGathered = 1, kStrided = 2 };

struct ScanArgs {
  int source;
  const uint8_t* packed;  // (b, packed_w)
  int packed_w;
  const uint8_t* nbits;  // (b, nbits_w) or null
  int nbits_w;
  const long long* genome;  // (n_words,) uint32 values
  long long n_words;
  const long long* ngenome;  // (n_nwords,) or null
  long long n_nwords;
  const int32_t* gstart;  // (b,)
  long long lo;
  long long stride;
  const int16_t* patches;  // (b, n_patch) or null
  int n_patch;
  const int16_t* splice;  // (b, 2 * n_pairs) or null
  int n_pairs;
  int clear_n;
  const uint8_t* vbits;  // (b, vbits_w) or null
  int vbits_w;
  const int32_t* lut;         // (k, 4, m)
  const int32_t* min_scores;  // (m,)
  long long b;
  int r;
  int k;
  int m;
  int noff;
  int rows_per_block;
  int tile;        // columns of a column tile (a multiple of V)
  int lut_stride;  // ints of a LUT row in shared memory
  int32_t* out;    // (b, noff, m)
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = int;
  static __device__ __forceinline__ void add(T& a, T b) { a += b; }
  static __device__ __forceinline__ T zero() { return 0; }
};
template <>
struct Vec<2> {
  using T = int2;
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x += b.x;
    a.y += b.y;
  }
  static __device__ __forceinline__ T zero() { return make_int2(0, 0); }
};
template <>
struct Vec<4> {
  using T = int4;
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ T zero() { return make_int4(0, 0, 0, 0); }
};

// The 2-bit code (bits = 2) or N bit (bits = 1) at genome position p; the
// word index is clamped into the plane.
template <int kBits>
__device__ __forceinline__ unsigned genome_at(const long long* __restrict__ w,
                                              long long n, long long p) {
  constexpr int kPer = 32 / kBits;
  constexpr int kShift = kBits == 2 ? 4 : 5;
  long long i = p >> kShift;  // floor division, p may be negative
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  const unsigned word = static_cast<unsigned>(__ldg(w + i));
  return (word >> ((p & (kPer - 1)) * kBits)) & ((1u << kBits) - 1u);
}

// The shift of position j under a row's splice pairs: that of the last
// pair whose bound is <= j (0 for an unused pair, bound 0x7FFF).
__device__ __forceinline__ int splice_shift(const int16_t* __restrict__ sp,
                                            int n_pairs, int j) {
  int shift = 0;
  for (int s = 0; s < n_pairs; ++s) {
    const int bound = __ldg(sp + 2 * s);
    if (j >= bound) shift = bound == 0x7FFF ? 0 : __ldg(sp + 2 * s + 1);
  }
  return shift;
}

// Whether the N words hold a set bit in positions [o, o + k).
__device__ __forceinline__ bool window_has_n(const uint32_t* nmask, int o,
                                             int k) {
  const int first = o >> 5;
  const int last = (o + k - 1) >> 5;
  const int end = (o + k - 1) & 31;
  for (int w = first; w <= last; ++w) {
    uint32_t bits = nmask[w];
    if (w == first) bits &= 0xffffffffu << (o & 31);
    if (w == last && end != 31) bits &= (1u << (end + 1)) - 1u;
    if (bits) return true;
  }
  return false;
}

// kCh: vectors a thread sums per pass over j (1 when a tile is one
// vector wide, as at M = 2, so no dead vector is loaded)
template <int V, int kCh>
__global__ void __launch_bounds__(kThreads)
scan_runs_kernel(const ScanArgs a) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_ints = a.k * 4 * a.lut_stride;
  int32_t* s_lut = reinterpret_cast<int32_t*>(smem);
  int32_t* s_mins = s_lut + lut_ints;
  const int nmw = (a.r + 31) >> 5;
  uint32_t* s_nmask =
      reinterpret_cast<uint32_t*>(s_mins + ((a.tile + 3) & ~3));
  uint8_t* s_codes =
      reinterpret_cast<uint8_t*>(s_nmask + a.rows_per_block * nmw);
  const int code_stride = (a.r + 15) & ~15;

  // the tile's LUT columns and minima
  const int c0 = blockIdx.y * a.tile;
  const int tw = a.m - c0 < a.tile ? a.m - c0 : a.tile;
  for (int i = threadIdx.x; i < a.k * 4 * tw; i += blockDim.x) {
    const int row = i / tw;
    const int c = i - row * tw;
    s_lut[row * a.lut_stride + c] =
        __ldg(a.lut + static_cast<long long>(row) * a.m + c0 + c);
  }
  for (int c = threadIdx.x; c < tw; c += blockDim.x) {
    s_mins[c] = __ldg(a.min_scores + c0 + c);
  }

  // this thread's row and its place in the row
  const int tpr = blockDim.x / a.rows_per_block;  // a multiple of 32
  const int lr = threadIdx.x / tpr;
  const int lt = threadIdx.x - lr * tpr;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * a.rows_per_block + lr;
  const bool live = row < a.b;
  uint8_t* codes = s_codes + lr * code_stride;
  uint32_t* nmask = s_nmask + lr * nmw;
  const bool with_n =
      a.source == kPacked ? a.nbits != nullptr : a.ngenome != nullptr;

  // expand the row: a warp takes 32 positions at a time, each lane one
  // code, and the warp's ballot is the N word of the 32
  long long start = 0;
  if (live && a.source == kGathered) start = __ldg(a.gstart + row);
  if (live && a.source == kStrided) start = a.lo + row * a.stride;
  const int16_t* sp =
      a.splice != nullptr && live ? a.splice + row * 2 * a.n_pairs : nullptr;
  for (int j0 = lt & ~31; j0 < a.r; j0 += tpr) {
    const int j = j0 + lane;
    unsigned code = 0, nbit = 0;
    if (live && j < a.r) {
      if (a.source == kPacked) {
        code = (__ldg(a.packed + row * a.packed_w + (j >> 2)) >>
                ((j & 3) * 2)) & 3u;
        if (with_n) {
          nbit = (__ldg(a.nbits + row * a.nbits_w + (j >> 3)) >> (j & 7)) & 1u;
        }
      } else {
        const long long p =
            start + j + (sp != nullptr ? splice_shift(sp, a.n_pairs, j) : 0);
        code = genome_at<2>(a.genome, a.n_words, p);
        if (with_n) nbit = genome_at<1>(a.ngenome, a.n_nwords, p);
      }
      codes[j] = static_cast<uint8_t>(code);
    }
    const unsigned word = __ballot_sync(0xffffffffu, nbit != 0);
    if (lane == 0) nmask[j0 >> 5] = word;
  }
  __syncthreads();
  // the patches, in slot order (a later slot wins), one thread a row
  if (a.patches != nullptr && live && lt == 0) {
    const int16_t* pt = a.patches + row * a.n_patch;
    for (int p = 0; p < a.n_patch; ++p) {
      const int ent = __ldg(pt + p);  // int16 -> int: sign-extended
      if (ent < 0) continue;
      const int pos = ent >> 2;
      if (pos >= a.r) continue;
      codes[pos] = static_cast<uint8_t>(ent & 3);
      if (a.clear_n) nmask[pos >> 5] &= ~(1u << (pos & 31));
    }
  }
  __syncthreads();
  if (!live) return;

  // score: a thread an offset, its tile's columns kCh vectors a pass
  const int nv = tw / V;
  const T* lut_v = reinterpret_cast<const T*>(s_lut);
  const int row_v = a.lut_stride / V;  // vectors of a LUT row
  for (int o = lt; o < a.noff; o += tpr) {
    bool valid = true;
    if (a.vbits != nullptr) {
      valid = (__ldg(a.vbits + row * a.vbits_w + (o >> 3)) >> (o & 7)) & 1u;
    }
    const bool has_n = valid && with_n && window_has_n(nmask, o, a.k);
    T* dst = reinterpret_cast<T*>(
        a.out + (row * a.noff + o) * static_cast<long long>(a.m) + c0);
    for (int cv = 0; cv < nv; cv += kCh) {
      T acc[kCh];
#pragma unroll
      for (int u = 0; u < kCh; ++u) acc[u] = Vec<V>::zero();
      if (valid && !has_n) {
#pragma unroll 4
        for (int j = 0; j < a.k; ++j) {
          const T* lrow = lut_v + (j * 4 + codes[o + j]) * row_v + cv;
#pragma unroll
          for (int u = 0; u < kCh; ++u) {
            if (cv + u < nv) Vec<V>::add(acc[u], lrow[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCh; ++u) {
        if (cv + u >= nv) break;
        T v = acc[u];
        if (!valid || has_n) {
          int* e = reinterpret_cast<int*>(&v);
          const int* mins = s_mins + (cv + u) * V;
#pragma unroll
          for (int i = 0; i < V; ++i) e[i] = valid ? mins[i] : -1;
        }
        dst[cv + u] = v;
      }
    }
  }
}

template <int V>
cudaError_t launch_scan(const DeviceInfo& d, int dev, ScanArgs a,
                        cudaStream_t stream) {
  // rows a block owns: as many as leave each at least its offsets' threads
  int rpb = 1;
  while (rpb < kMaxRowsPerBlock && kThreads / (2 * rpb) >= a.noff) rpb *= 2;
  a.rows_per_block = rpb;
  const int nmw = (a.r + 31) >> 5;
  const int64_t rows_bytes =
      static_cast<int64_t>(rpb) * (nmw * 4 + ((a.r + 15) & ~15));
  const int64_t budget =
      (d.smem_block < kLutBudget + rows_bytes ? d.smem_block
                                              : kLutBudget + rows_bytes);
  // a tile of tv vectors: its LUT rows padded to an odd count of vectors,
  // and its minima
  auto bytes_for = [&](int64_t tv) {
    const int64_t sv = tv % 2 ? tv : tv + 1;
    return 4 * (static_cast<int64_t>(a.k) * 4 * sv * V + ((tv * V + 3) & ~3)) +
           rows_bytes;
  };
  const int64_t nvec = a.m / V;
  int64_t tv = nvec;
  if (bytes_for(tv) > budget) {
    tv = (budget - rows_bytes) / (4 * (static_cast<int64_t>(a.k) * 4 * V + V)) -
         1;
    while (tv > 0 && bytes_for(tv) > budget) --tv;
  }
  if (tv < 1) return cudaErrorInvalidValue;
  const int64_t tiles = (nvec + tv - 1) / tv;
  const int64_t blocks = (a.b + rpb - 1) / rpb;
  if (tiles > 65535 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  a.tile = static_cast<int>(tv * V);
  a.lut_stride = static_cast<int>((tv % 2 ? tv : tv + 1) * V);
  const int smem = static_cast<int>(bytes_for(tv));
  auto kernel = tv == 1 ? scan_runs_kernel<V, 1>
                        : scan_runs_kernel<V, kAccInts / V>;
  const cudaError_t err = allow_max_smem(kernel, dev, d.smem_block);
  if (err != cudaSuccess) return err;
  return launch(kernel,
                dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles)),
                kThreads, smem, stream, 1, a);
}

}  // namespace

// Masked window scores of one slice block into `out` ((b, r - k + 1, m)
// int32) on `stream` (a cudaStream_t passed as void*), on device `dev`,
// which must be current.  `source` is 0 (packed rows), 1 (genome rows at
// gstart) or 2 (genome rows at lo + i * stride); the pointers a source does
// not use, and nbits / ngenome / patches / splice / vbits when absent, are
// null.  Returns the cudaError_t of the launch (0 = success); it does not
// synchronise.
extern "C" int grafimo_scan_runs(
    int source, const void* packed, int packed_w, const void* nbits,
    int nbits_w, const void* genome, long long n_words, const void* ngenome,
    long long n_nwords, const void* gstart, long long lo, long long stride,
    const void* patches, int n_patch, const void* splice, int n_pairs,
    int clear_n, const void* vbits, int vbits_w, const void* lut,
    const void* min_scores, long long b, int r, int k, int m, void* out,
    int dev, void* stream) {
  if (source < kPacked || source > kStrided || r <= 0 || k <= 0 || k > r ||
      m <= 0 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  if (source == kPacked ? packed == nullptr
                        : genome == nullptr || n_words <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (source == kGathered && gstart == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceInfo* d = nullptr;
  cudaError_t err = device_info(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  ScanArgs a = {};
  a.source = source;
  a.packed = static_cast<const uint8_t*>(packed);
  a.packed_w = packed_w;
  a.nbits = static_cast<const uint8_t*>(nbits);
  a.nbits_w = nbits_w;
  a.genome = static_cast<const long long*>(genome);
  a.n_words = n_words;
  a.ngenome = static_cast<const long long*>(ngenome);
  a.n_nwords = n_nwords;
  a.gstart = static_cast<const int32_t*>(gstart);
  a.lo = lo;
  a.stride = stride;
  a.patches = n_patch > 0 ? static_cast<const int16_t*>(patches) : nullptr;
  a.n_patch = n_patch;
  a.splice = n_pairs > 0 ? static_cast<const int16_t*>(splice) : nullptr;
  a.n_pairs = n_pairs;
  a.clear_n = clear_n;
  a.vbits = static_cast<const uint8_t*>(vbits);
  a.vbits_w = vbits_w;
  a.lut = static_cast<const int32_t*>(lut);
  a.min_scores = static_cast<const int32_t*>(min_scores);
  a.b = b;
  a.r = r;
  a.k = k;
  a.m = m;
  a.noff = r - k + 1;
  a.out = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m % 4 == 0) err = launch_scan<4>(*d, dev, a, s);
  else if (m % 2 == 0) err = launch_scan<2>(*d, dev, a, s);
  else err = launch_scan<1>(*d, dev, a, s);
  return static_cast<int>(err);
}
