// The run engine's scoring core, for Hopper (sm_90a): expand a slice
// block's rows, score every stride-1 window and apply the N and validity
// masks for any of the five batch kinds -- and, in the fused launch the
// run engine takes, count and compact the masked scores in the same pass,
// so the (B, Noff, M) score plane is never written.
//
// Replaces what the TPU scan runs in jnp around its histogram (XLA fuses
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
//   - the N and validity masks of _finish_scores (:483-502);
//   - in the fused launch also the histogram of _exact_hist (:311, the
//     Pallas hist_pallas of ops/pallas_hist.py:90, with the remap of
//     _finish_scores :503-518, as hist.cu counts it) and the hit packaging
//     of _finish_scores (:522-528), _topk_package_tiered (:684) and
//     absorb_slice (:1000), as compact.cu writes it.
//
// Contract, for row b of the block, offset o < Noff = R - k + 1 and motif
// column c < M:
//
//   s(b, o, c) = -1                if offset o of row b is not valid
//              = min_scores[c]     else if codes(b, o .. o+k-1) hold an N
//              = sum_j lut[j, code(b, o + j), c]   otherwise
//
// grafimo_scan_runs writes s to out[b, o, c].  grafimo_scan_runs_fused
// writes instead hist[bin, c] = #{(b, o) : bin(s(b, o, c)) = bin} with
// bin(s) = s < 0 ? -1 : max(s - bases[c] + 1, 0) (s itself without bases),
// bins outside [0, comp_size) dropped (hist.cu's contract), and the hits
// s >= cutoffs[c] && s >= 0 as compact.cu writes them: hit bits, the exact
// count, and flat indices (b * Noff + o) * M + c in any order.
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
// What bounds the fused launch on the card.  At the main path's block (8192
// rows, R = 2048, CTCF forward + reverse complement, M = 2, k = 19) it
// reads ~6 MB of descriptors, masks and genome words and writes 4 MB of
// hit bits (~0.003 ms at 3.35 TB/s): the plane's 133 MB (0.040 ms written,
// then read again by hist.cu and compact.cu) are gone.  What is left is
// instruction issue, a window at a time: the table reads and adds of its
// sum, then its masks, bin, count, hit test, ballot and bit store.  What
// the design does about them:
//
// - A pair table: entry (pair jp, codes x, y) = lut[2jp][x] + lut[2jp+1][y],
//   16 entries a pair and column word, so a window's sum is one
//   shared-memory read a position pair (12 at k = 19, the pairs rounded up
//   to a multiple of 4 with zero entries so the loop has no remainder),
//   each selected by four bits of the row's 2-bit codes.  16 consecutive
//   words: a warp's read is conflict-free whatever codes its lanes hold.
//   The same integer terms are summed, so the sum is exact.
// - Two columns a table word when no window sum of the group can pass 16
//   bits (every LUT entry in [0, 65535 / k]; checked by the block as it
//   builds the table): at M = 2 one read and one add serve both strands.
// - The row's codes stay 2 bits a position in shared memory; a lane takes
//   16 codes a 32-bit read (a funnel shift to its offset), and the warp's
//   lanes share those reads (broadcast).  Validity and N bits are words of
//   32 offsets or positions.
// - The score never leaves its register: its bin goes to the block's
//   shared-memory histogram (bins.cuh, as hist.cu keeps it), and the warp's
//   ballot of s >= cutoff is four bytes of hit bits.  A warp's task is four
//   32-offset chunks of a row, so hit numbers take one atomicAdd a task and
//   table word that holds a hit (compact.cu's scheme), and the window masks
//   are tested once a task, not once a column.
// - A block of 256 to 1024 threads, the size that keeps the most warps
//   resident at its shared memory and registers, a grid of as many blocks
//   as the SMs hold: the pair table and histogram are built once a block,
//   and the non-zero bins flushed once with global atomics.  The block's
//   sub-blocks of 256 threads each expand and score their own row groups
//   behind their own named barrier, so one sub-block's expansion (global
//   loads) overlaps the others' scoring.
// - The expansion stages each row's start and splice pairs in shared
//   memory, and builds a word split by a splice bound from one funnel
//   shift per run of equal shift, not a code at a time.
// - Columns whose bins and tables outgrow a block are taken in column
//   groups along the grid's y (each re-expands its rows).  A column whose
//   bins alone outgrow one block takes the three launches instead: the
//   caller's plan (ops/score_runs.fused_plan) sends it there, and hist.cu
//   splits its bins over a cluster.
//
// The unfused launch (grafimo_scan_runs) stays for the three-launch route
// and its callers' (hist, scores) contract.  What bounds it: the 133 MB
// plane written (0.040 ms) and its LUT reads, one a window position and
// column vector.  Its design:
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

// The shift of position j under a row's splice pairs (in global or shared
// memory): that of the last pair whose bound is <= j (0 for an unused
// pair, bound 0x7FFF).
__device__ __forceinline__ int splice_shift(const int16_t* sp, int n_pairs,
                                            int j) {
  int shift = 0;
  for (int s = 0; s < n_pairs; ++s) {
    const int bound = sp[2 * s];
    if (j >= bound) shift = bound == 0x7FFF ? 0 : sp[2 * s + 1];
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


// ---------------------------------------------------------------- fused
//
// One launch a slice block: expand, score, mask, count and compact.  The
// score of window (b, o, c) lives in a register from its sum to its bin
// and its hit bit; the (b, Noff, M) plane is never written.

constexpr int kMaxFusedThreads = 1024;
constexpr int kSubThreads = 256;  // threads of a sub-block
constexpr int kTaskChunks = 4;    // 32-offset chunks of a row a task
constexpr int kTasksPerWarp = 4;  // of a sub-block's row group
constexpr int kMaxRowsPerGroup = 64;
// a row's start (2 ints) and up to kStagedPairs splice pairs (int16 pairs
// in 4 ints) staged in shared memory beside its codes
constexpr int kStagedPairs = 4;
constexpr int kDescInts = 6;

struct FusedArgs {
  ScanArgs s;              // the rows, masks, LUT and minima (s.out unused)
  const int32_t* cutoffs;  // (m,)
  const int32_t* bases;    // (m,) or null: bins as the scores are
  int comp_size;           // bins a column
  int group;               // columns of a column group (grid y)
  int rows_per_group;      // rows a sub-block expands and scores together
  int npairs;              // position pairs a window reads: ceil(k / 2),
                           // rounded up to a multiple of 4 (zero entries)
  int code_words;          // shared-memory words of a row's codes,
  int nmask_words;         //   its N bits,
  int valid_words;         //   its validity bits (then kDescInts)
  int32_t* hist;           // (comp_size, m), zeroed
  int32_t* count;          // zeroed
  int32_t* idx_a;
  int cap_a;
  int32_t* idx_b;
  int cap_b;
  uint8_t* bits;  // (b, ceil(noff / 8), m)
};

// The threads of sub-block `sub` (kSubThreads of them) wait for each
// other; sub-blocks go on independently (named barriers 1..).
__device__ __forceinline__ void sub_sync(int sub) {
  asm volatile("bar.sync %0, %1;" ::"r"(sub + 1), "r"(kSubThreads)
               : "memory");
}

// 32 consecutive kBits-wide codes of a genome word plane from position p
// (16 codes of 2 bits, 32 N bits): two words, each index clamped into the
// plane as genome_at clamps it, funnel-shifted.
template <int kBits>
__device__ __forceinline__ uint32_t genome_word(
    const long long* __restrict__ w, long long n, long long p) {
  constexpr int kPer = 32 / kBits;
  constexpr int kShift = kBits == 2 ? 4 : 5;
  long long i = p >> kShift;
  const long long i0 = i < 0 ? 0 : (i >= n ? n - 1 : i);
  ++i;
  const long long i1 = i < 0 ? 0 : (i >= n ? n - 1 : i);
  const uint32_t lo = static_cast<uint32_t>(__ldg(w + i0));
  const uint32_t hi = static_cast<uint32_t>(__ldg(w + i1));
  return __funnelshift_r(lo, hi, static_cast<int>(p & (kPer - 1)) * kBits);
}

// Bytes [4w, 4w + 4) of a byte row of `width` bytes as a little-endian
// word (bytes past the row read 0).
__device__ __forceinline__ uint32_t byte_word(const uint8_t* __restrict__ p,
                                              int width, int w) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int at = 4 * w + i;
    if (at < width) word |= static_cast<uint32_t>(__ldg(p + at)) << (8 * i);
  }
  return word;
}

// Word w of a row's codes (kBits = 2: positions 16w..16w+15) or N bits
// (kBits = 1: positions 32w..32w+31) from a genome plane, the row starting
// at `start`.  A splice bound inside the word changes the shift within
// it: such a word is put together from one funnel-shifted read for each
// run of positions that share a shift.
template <int kBits>
__device__ __forceinline__ uint32_t row_word(const ScanArgs& a,
                                             const long long* plane,
                                             long long n, long long start,
                                             const int16_t* sp, int w) {
  constexpr int kPer = 32 / kBits;
  const int j0 = w * kPer;
  if (sp == nullptr) return genome_word<kBits>(plane, n, start + j0);
  uint32_t word = 0;
  int j = j0;
#pragma unroll 1
  while (j < j0 + kPer) {
    // the run [j, next): to the word's end or the next bound after j
    int next = j0 + kPer;
    for (int s = 0; s < a.n_pairs; ++s) {
      const int bound = sp[2 * s];
      if (bound > j && bound < next) next = bound;
    }
    const uint32_t run = genome_word<kBits>(
        plane, n, start + splice_shift(sp, a.n_pairs, j) + j0);
    const int lo = (j - j0) * kBits;
    const int hi = (next - j0) * kBits;
    const uint32_t mask =
        (hi == 32 ? 0xffffffffu : (1u << hi) - 1u) & (0xffffffffu << lo);
    word |= run & mask;
    j = next;
  }
  return word;
}

// Sub-block `sub` (thread st of it) expands rows [row0, row0 + rows) into
// its shared memory, row lr at rows_s + lr * (code_words + nmask_words +
// valid_words + kDescInts): its codes (2 bits a position, 16 a word), then
// its N bits and its validity bits (1 a position or offset, 32 a word);
// words past the row read 0.  Each row's start and splice pairs are staged
// first, one thread a row, so the words read them from shared memory.
// Then the patches, in slot order, one thread a row.
__device__ __forceinline__ void expand_rows(const FusedArgs& f, int row0,
                                            int rows, uint32_t* rows_s,
                                            bool with_n, int sub, int st) {
  const ScanArgs& a = f.s;
  const int words = f.code_words + f.nmask_words + f.valid_words;
  const int per_row = words + kDescInts;
  const bool staged = a.n_pairs <= kStagedPairs;
  if (st < rows) {
    const long long row = row0 + st;
    int* desc = reinterpret_cast<int*>(rows_s + st * per_row + words);
    long long start = 0;
    if (a.source == kGathered) start = __ldg(a.gstart + row);
    if (a.source == kStrided) start = a.lo + row * a.stride;
    desc[0] = static_cast<int>(start);
    desc[1] = static_cast<int>(start >> 32);
    if (a.splice != nullptr && staged) {
      int16_t* sp = reinterpret_cast<int16_t*>(desc + 2);
      for (int s = 0; s < 2 * a.n_pairs; ++s) {
        sp[s] = __ldg(a.splice + row * 2 * a.n_pairs + s);
      }
    }
  }
  sub_sync(sub);
#pragma unroll 1
  for (int i = st; i < rows * words; i += kSubThreads) {
    const int lr = i / words;
    const int at = i - lr * words;
    const long long row = row0 + lr;
    uint32_t* rw = rows_s + lr * per_row;
    const int* desc = reinterpret_cast<const int*>(rw + words);
    const long long start =
        static_cast<long long>(static_cast<unsigned>(desc[0])) |
        (static_cast<long long>(desc[1]) << 32);
    const int16_t* sp =
        a.splice == nullptr
            ? nullptr
            : (staged ? reinterpret_cast<const int16_t*>(desc + 2)
                      : a.splice + row * 2 * a.n_pairs);
    uint32_t word = 0;
    if (at < f.code_words) {
      if (at * 16 < a.r) {
        word = a.source == kPacked
                   ? byte_word(a.packed + row * a.packed_w, a.packed_w, at)
                   : row_word<2>(a, a.genome, a.n_words, start, sp, at);
      }
    } else if (at < f.code_words + f.nmask_words) {
      const int w = at - f.code_words;
      if (with_n && w * 32 < a.r) {
        word = a.source == kPacked
                   ? byte_word(a.nbits + row * a.nbits_w, a.nbits_w, w)
                   : row_word<1>(a, a.ngenome, a.n_nwords, start, sp, w);
      }
    } else {
      word = a.vbits != nullptr
                 ? byte_word(a.vbits + row * a.vbits_w, a.vbits_w,
                             at - f.code_words - f.nmask_words)
                 : 0xffffffffu;
    }
    rw[at] = word;
  }
  if (a.patches == nullptr) return;
  sub_sync(sub);
  if (st < rows) {
    uint32_t* codes = rows_s + st * per_row;
    uint32_t* nmask = codes + f.code_words;
    const int16_t* pt =
        a.patches + static_cast<long long>(row0 + st) * a.n_patch;
    for (int p = 0; p < a.n_patch; ++p) {
      const int ent = __ldg(pt + p);  // int16 -> int: sign-extended
      if (ent < 0) continue;
      const int pos = ent >> 2;
      if (pos >= a.r) continue;
      const int sh = (pos & 15) * 2;
      codes[pos >> 4] = (codes[pos >> 4] & ~(3u << sh)) |
                        (static_cast<uint32_t>(ent & 3) << sh);
      if (a.clear_n && with_n) nmask[pos >> 5] &= ~(1u << (pos & 31));
    }
  }
}

// Window o of a row holds an N: its k bits of the row's N words.
__device__ __forceinline__ bool has_n_at(const uint32_t* nmask, int o,
                                         int k) {
  int w = o >> 5;
  const int sh = o & 31;
  uint32_t bits = __funnelshift_r(nmask[w], nmask[w + 1], sh);
  if (k < 32) return (bits & ((1u << k) - 1u)) != 0;
#pragma unroll 1
  for (int rem = k - 32; rem > 0 && bits == 0; rem -= 32) {
    ++w;
    bits = __funnelshift_r(nmask[w], nmask[w + 1], sh);
    if (rem < 32) bits &= (1u << rem) - 1u;
  }
  return bits != 0;
}

// Score the chunks [ch0, ch0 + kTaskChunks) of row `row` (32 offsets a
// chunk, a lane an offset) for every column of the group, from the row's
// codes in shared memory and the pair table: a window's sum is one table
// read a position pair, selected by four bits of the row's codes.  kPack:
// a table word holds two columns, 16 bits each (every column's window sum
// fits 16 bits).  Each score is counted into the block's shared-memory
// histogram as it is made, and the warp's ballot of its hits is four
// bytes of hit bits; the hits of a table word's columns over the task's
// chunks take one hit-number reservation from the count.
template <bool kPack>
__device__ __forceinline__ void score_task(
    const FusedArgs& f, const uint32_t* tab, int32_t* bins,
    const int32_t* s_mins, const int32_t* s_cuts, const int32_t* s_bases,
    const uint32_t* codes, const uint32_t* nmask, const uint32_t* vmask,
    bool with_n, int row, int ch0, int gw, int c0, int lane) {
  const ScanArgs& a = f.s;
  constexpr int kCols = kPack ? 2 : 1;  // columns of a table word
  const int words = kPack ? (gw + 1) >> 1 : gw;
  const int nb = (a.noff + 7) >> 3;
  const int left = ((a.noff + 31) >> 5) - ch0;
  const int n_ch = left < kTaskChunks ? left : kTaskChunks;
  const bool remap = f.bases != nullptr;
  // the task's windows: bit cc of `valid` set for a valid offset, of
  // `summed` also clear of N
  unsigned valid = 0, summed = 0;
#pragma unroll
  for (int cc = 0; cc < kTaskChunks; ++cc) {
    const int o = (ch0 + cc) * 32 + lane;
    if (cc < n_ch && o < a.noff && ((vmask[ch0 + cc] >> lane) & 1u)) {
      valid |= 1u << cc;
      if (!with_n || !has_n_at(nmask, o, a.k)) summed |= 1u << cc;
    }
  }
  // this lane's hit-bit bytes: row `row`, offsets 8 * (4 * ch0 + lane)..
  uint8_t* bits = f.bits +
                  (static_cast<long long>(row) * nb + 4 * ch0 + lane) * a.m +
                  c0;
  const int tw = f.npairs * 16;  // table entries of one word
#pragma unroll 1
  for (int w = 0; w < words; ++w) {
    const uint32_t* t0 = tab + w * tw;
    int cut[kCols], mn[kCols], base[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = kCols * w + u < gw ? kCols * w + u : gw - 1;
      cut[u] = s_cuts[c];
      mn[u] = s_mins[c];
      base[u] = s_bases[c];
    }
    unsigned ballots[kTaskChunks][kCols];
#pragma unroll
    for (int cc = 0; cc < kTaskChunks; ++cc) {
#pragma unroll
      for (int u = 0; u < kCols; ++u) ballots[cc][u] = 0;
      if (cc >= n_ch) continue;  // the same for every lane of the warp
      uint32_t acc = 0;
      if ((summed >> cc) & 1u) {
        const int o = (ch0 + cc) * 32 + lane;
        const uint32_t* t = t0;
        const int sh = (o & 15) * 2;
        int q = o >> 4;
        int jp = 0;
#pragma unroll 1
        for (; jp + 8 <= f.npairs; jp += 8, ++q, t += 128) {
          const uint32_t cw = __funnelshift_r(codes[q], codes[q + 1], sh);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            acc += t[p * 16 + ((cw >> (4 * p)) & 15u)];
          }
        }
        if (jp < f.npairs) {  // four pairs left: npairs is a multiple of 4
          const uint32_t cw = __funnelshift_r(codes[q], codes[q + 1], sh);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc += t[p * 16 + ((cw >> (4 * p)) & 15u)];
          }
        }
      }
      const bool is_valid = (valid >> cc) & 1u;
      const bool is_summed = (summed >> cc) & 1u;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = kCols * w + u;
        if (c >= gw) break;  // the same for every lane of the warp
        const int s =
            is_summed ? (kPack ? static_cast<int>((acc >> (16 * u)) & 0xffffu)
                               : static_cast<int>(acc))
                      : (is_valid ? mn[u] : -1);
        int bin = s;
        if (remap && s >= 0) {
          bin = s - base[u] + 1;
          bin = bin > 0 ? bin : 0;
        }
        // one unsigned compare drops both bin < 0 and bin >= comp_size
        if (static_cast<unsigned>(bin) < static_cast<unsigned>(f.comp_size)) {
          atomicAdd(bins + bin * gw + c, 1);
        }
        const unsigned ballot =
            __ballot_sync(0xffffffffu, s >= 0 && s >= cut[u]);
        if (lane < 4 && 4 * (ch0 + cc) + lane < nb) {
          bits[cc * 4 * a.m + c] = static_cast<uint8_t>(ballot >> (8 * lane));
        }
        ballots[cc][u] = ballot;
      }
    }
    int total = 0;
#pragma unroll
    for (int cc = 0; cc < kTaskChunks; ++cc) {
#pragma unroll
      for (int u = 0; u < kCols; ++u) total += __popc(ballots[cc][u]);
    }
    if (total == 0) continue;  // the same for every lane of the warp
    int hit = 0;
    if (lane == 0) hit = atomicAdd(f.count, total);
    hit = __shfl_sync(0xffffffffu, hit, 0);
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int cc = 0; cc < kTaskChunks; ++cc) {
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const unsigned ballot = ballots[cc][u];
        if ((ballot >> lane) & 1u) {
          const int p = hit + __popc(ballot & below);
          const int e = (row * a.noff + (ch0 + cc) * 32 + lane) * a.m + c0 +
                        kCols * w + u;
          if (p < f.cap_a) {
            f.idx_a[p] = e;
          } else if (p - f.cap_a < f.cap_b) {
            f.idx_b[p - f.cap_a] = e;
          }
        }
        hit += __popc(ballot);
      }
    }
  }
}

// Blocks along x take row groups of the slice block, blocks along y
// column groups.  A block keeps its group's pair table and histogram in
// shared memory across its rows and flushes the non-zero bins once; its
// sub-blocks of kSubThreads threads each expand and score their own row
// groups, synchronising among themselves only, so one sub-block's
// expansion (global-memory latency) overlaps the others' scoring.
__global__ void __launch_bounds__(kMaxFusedThreads)
scan_runs_fused_kernel(const __grid_constant__ FusedArgs f) {
  const ScanArgs& a = f.s;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* bins = reinterpret_cast<int32_t*>(smem);
  const int slice = f.group * f.comp_size;
  uint32_t* tab = reinterpret_cast<uint32_t*>(bins + ((slice + 3) & ~3));
  int32_t* s_mins = reinterpret_cast<int32_t*>(tab + f.group * f.npairs * 16);
  int32_t* s_cuts = s_mins + f.group;
  int32_t* s_bases = s_cuts + f.group;
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(s_bases + f.group);
  const int row_ints =
      f.code_words + f.nmask_words + f.valid_words + kDescInts;
  const int c0 = blockIdx.y * f.group;
  const int gw = a.m - c0 < f.group ? a.m - c0 : f.group;
  const bool with_n =
      a.source == kPacked ? a.nbits != nullptr : a.ngenome != nullptr;

  // the group's minima, cutoffs and bases; two columns share a table word
  // when no window sum of the group can pass 16 bits
  bool wide = false;
  for (int i = threadIdx.x; i < a.k * 4 * gw; i += blockDim.x) {
    const int lrow = i / gw;
    const int v = __ldg(a.lut + static_cast<long long>(lrow) * a.m + c0 +
                        (i - lrow * gw));
    wide |= v < 0 || static_cast<long long>(v) * a.k > 0xffff;
  }
  for (int c = threadIdx.x; c < gw; c += blockDim.x) {
    s_mins[c] = __ldg(a.min_scores + c0 + c);
    s_cuts[c] = __ldg(f.cutoffs + c0 + c);
    s_bases[c] = f.bases != nullptr ? __ldg(f.bases + c0 + c) : 0;
  }
  const bool pack = !__syncthreads_or(wide);
  // the pair table: entry (word, pair jp, codes x of position 2jp and y of
  // 2jp + 1 as x | y << 2) = lut[2jp][x] + lut[2jp + 1][y] (0 past k)
  const int words = pack ? (gw + 1) >> 1 : gw;
  const int tw = f.npairs * 16;
  for (int i = threadIdx.x; i < words * tw; i += blockDim.x) {
    const int w = i / tw;
    const int jp = (i - w * tw) >> 4;
    const int x = i & 3;
    const int y = (i >> 2) & 3;
    uint32_t e = 0;
    for (int u = 0; u < (pack ? 2 : 1) && 2 * jp < a.k; ++u) {
      const int c = pack ? 2 * w + u : w;
      if (c >= gw) break;
      const int32_t* col = a.lut + c0 + c;
      uint32_t v = static_cast<uint32_t>(
          __ldg(col + static_cast<long long>(8 * jp + x) * a.m));
      if (2 * jp + 1 < a.k) {
        v += static_cast<uint32_t>(
            __ldg(col + static_cast<long long>(8 * jp + 4 + y) * a.m));
      }
      e += v << (16 * u);
    }
    tab[i] = e;
  }
  bins_zero<false>(bins, slice);  // its barrier covers the table too

  const int subs = blockDim.x / kSubThreads;
  const int sub = threadIdx.x / kSubThreads;
  const int st = threadIdx.x - sub * kSubThreads;
  uint32_t* mine = rows_s + sub * f.rows_per_group * row_ints;
  const int n_groups = (a.b + f.rows_per_group - 1) / f.rows_per_group;
  const int tasks = (((a.noff + 31) >> 5) + kTaskChunks - 1) / kTaskChunks;
  const int lane = st & 31;
  const int warp = st >> 5;
  for (int g = blockIdx.x * subs + sub; g < n_groups; g += gridDim.x * subs) {
    const int row0 = g * f.rows_per_group;
    const int rows = a.b - row0 < f.rows_per_group
                         ? static_cast<int>(a.b - row0)
                         : f.rows_per_group;
    sub_sync(sub);  // the sub-block's previous group is scored
    expand_rows(f, row0, rows, mine, with_n, sub, st);
    sub_sync(sub);
    for (int t = warp; t < rows * tasks; t += kSubThreads / 32) {
      const int lr = t / tasks;
      const int ch0 = (t - lr * tasks) * kTaskChunks;
      const uint32_t* codes = mine + lr * row_ints;
      const uint32_t* nmask = codes + f.code_words;
      const uint32_t* vmask = nmask + f.nmask_words;
      if (pack) {
        score_task<true>(f, tab, bins, s_mins, s_cuts, s_bases, codes,
                         nmask, vmask, with_n, row0 + lr, ch0, gw, c0, lane);
      } else {
        score_task<false>(f, tab, bins, s_mins, s_cuts, s_bases, codes,
                          nmask, vmask, with_n, row0 + lr, ch0, gw, c0, lane);
      }
    }
  }

  __syncthreads();
  int32_t* hist = f.hist;
  const int m = a.m;
  bins_flush(bins, slice, 0, gw * f.comp_size, [=](int key, int count) {
    const int bin = key / gw;
    atomicAdd(hist + static_cast<int64_t>(bin) * m + c0 + (key - bin * gw),
              count);
  });
}

// The fused launch's layout for a block of rows of r positions, k-wide
// windows, m columns and comp_size bins a column, within smem_block bytes
// of shared memory a block: rows a sub-block's group and the row strides,
// and the column groups whose bins (plan_bins), pair tables, minima,
// cutoffs and bases fit beside the rows of a block's kMaxFusedThreads /
// kSubThreads sub-blocks.  False when a column does not fit one block (the
// caller's plan takes the three launches there).
bool plan_fused(int m, int k, int r, int comp_size, int smem_block,
                FusedArgs* f) {
  const int noff = r - k + 1;
  const int chunks = (noff + 31) / 32;
  const int tasks = (chunks + kTaskChunks - 1) / kTaskChunks;  // a row's
  int rpg = kTasksPerWarp * (kSubThreads / 32) / tasks;
  rpg = rpg < 1 ? 1 : (rpg > kMaxRowsPerGroup ? kMaxRowsPerGroup : rpg);
  f->rows_per_group = rpg;
  f->npairs = ((k + 1) / 2 + 3) & ~3;
  // reads past the row: a window's last pairs of codes, one word on
  f->code_words = (r + 15) / 16 + 3;
  f->nmask_words = (r + 31) / 32 + 2;
  f->valid_words = chunks;
  const int64_t rows_ints =
      static_cast<int64_t>(kMaxFusedThreads / kSubThreads) * rpg *
      (f->code_words + f->nmask_words + f->valid_words + kDescInts);
  // 3 ints of rounding after the bins
  const int64_t room = static_cast<int64_t>(smem_block) - 4 * (rows_ints + 3);
  if (room <= 0) return false;
  BinPlan p;
  if (!plan_bins(m, comp_size, static_cast<int>(room), f->npairs * 16 + 3,
                 &p) ||
      p.cluster != 1) {
    return false;
  }
  f->group = p.group;
  return true;
}

int fused_smem(const FusedArgs& f) {
  const int rows_ints =
      kMaxFusedThreads / kSubThreads * f.rows_per_group *
      (f.code_words + f.nmask_words + f.valid_words + kDescInts);
  return 4 * (((f.group * f.comp_size + 3) & ~3) +
              f.group * (f.npairs * 16 + 3) + rows_ints);
}

// The block size (a multiple of kSubThreads) that keeps the most warps of
// the fused kernel resident at `smem` bytes a block (registers and shared
// memory both bound it), the larger block on a tie (one histogram to zero
// and flush for more sub-blocks), and those blocks a SM;
// asked once per (device, smem).
cudaError_t fused_threads(int dev, int smem, int* threads, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, std::pair<int, int>> cache;
  const auto key = std::make_pair(dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    int best_t = 0, best_n = 0;
    for (int t = kSubThreads; t <= kMaxFusedThreads; t += kSubThreads) {
      int n = 0;
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, scan_runs_fused_kernel, t, smem);
      if (err != cudaSuccess) return err;
      if (n * t >= best_n * best_t) {  // ties: the larger block
        best_t = t;
        best_n = n;
      }
    }
    if (best_n < 1) return cudaErrorInvalidConfiguration;
    it = cache.emplace(key, std::make_pair(best_t, best_n)).first;
  }
  *threads = it->second.first;
  *blocks = it->second.second;
  return cudaSuccess;
}

cudaError_t launch_fused(const DeviceInfo& d, int dev, const FusedArgs& f,
                         cudaStream_t stream) {
  cudaError_t err =
      allow_max_smem(scan_runs_fused_kernel, dev, d.smem_block);
  if (err != cudaSuccess) return err;
  const int smem = fused_smem(f);
  int threads, per_sm;
  err = fused_threads(dev, smem, &threads, &per_sm);
  if (err != cudaSuccess) return err;
  // blocks along x: as many as the device holds for each column group, no
  // more than its sub-blocks have row groups
  const int groups = (f.s.m + f.group - 1) / f.group;
  const int64_t row_groups =
      (f.s.b + f.rows_per_group - 1) / f.rows_per_group;
  const int64_t subs = threads / kSubThreads;
  int64_t gx = static_cast<int64_t>(d.sms) * per_sm / groups;
  if (gx > (row_groups + subs - 1) / subs) gx = (row_groups + subs - 1) / subs;
  if (gx < 1) gx = 1;
  if (groups > 65535) return cudaErrorInvalidValue;
  return launch(scan_runs_fused_kernel,
                dim3(static_cast<unsigned>(gx), static_cast<unsigned>(groups)),
                threads, smem, stream, 1, f);
}

// The row arguments of both entries as ScanArgs (the checks both share).
cudaError_t scan_args(int source, const void* packed, int packed_w,
                      const void* nbits, int nbits_w, const void* genome,
                      long long n_words, const void* ngenome,
                      long long n_nwords, const void* gstart, long long lo,
                      long long stride, const void* patches, int n_patch,
                      const void* splice, int n_pairs, int clear_n,
                      const void* vbits, int vbits_w, const void* lut,
                      const void* min_scores, long long b, int r, int k,
                      int m, ScanArgs* a) {
  if (source < kPacked || source > kStrided || r <= 0 || k <= 0 || k > r ||
      m <= 0 || b < 0) {
    return cudaErrorInvalidValue;
  }
  if (b > 0 && (source == kPacked ? packed == nullptr
                                  : genome == nullptr || n_words <= 0)) {
    return cudaErrorInvalidValue;
  }
  if (b > 0 && source == kGathered && gstart == nullptr) {
    return cudaErrorInvalidValue;
  }
  *a = ScanArgs{};
  a->source = source;
  a->packed = static_cast<const uint8_t*>(packed);
  a->packed_w = packed_w;
  a->nbits = static_cast<const uint8_t*>(nbits);
  a->nbits_w = nbits_w;
  a->genome = static_cast<const long long*>(genome);
  a->n_words = n_words;
  a->ngenome = static_cast<const long long*>(ngenome);
  a->n_nwords = n_nwords;
  a->gstart = static_cast<const int32_t*>(gstart);
  a->lo = lo;
  a->stride = stride;
  a->patches = n_patch > 0 ? static_cast<const int16_t*>(patches) : nullptr;
  a->n_patch = n_patch;
  a->splice = n_pairs > 0 ? static_cast<const int16_t*>(splice) : nullptr;
  a->n_pairs = n_pairs;
  a->clear_n = clear_n;
  a->vbits = static_cast<const uint8_t*>(vbits);
  a->vbits_w = vbits_w;
  a->lut = static_cast<const int32_t*>(lut);
  a->min_scores = static_cast<const int32_t*>(min_scores);
  a->b = b;
  a->r = r;
  a->k = k;
  a->m = m;
  a->noff = r - k + 1;
  return cudaSuccess;
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
  ScanArgs a;
  cudaError_t err = scan_args(
      source, packed, packed_w, nbits, nbits_w, genome, n_words, ngenome,
      n_nwords, gstart, lo, stride, patches, n_patch, splice, n_pairs,
      clear_n, vbits, vbits_w, lut, min_scores, b, r, k, m, &a);
  if (err != cudaSuccess || b == 0) return static_cast<int>(err);
  const DeviceInfo* d = nullptr;
  err = device_info(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.out = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m % 4 == 0) err = launch_scan<4>(*d, dev, a, s);
  else if (m % 2 == 0) err = launch_scan<2>(*d, dev, a, s);
  else err = launch_scan<1>(*d, dev, a, s);
  return static_cast<int>(err);
}

// Score, count and compact one slice block in one launch on `stream`: the
// histogram of its masked scores into `hist` ((comp_size, m) int32; each
// score remapped by `bases` ((m,) int32) as hist.cu remaps it, or as it is
// when null), its hits into *count, idx_a / idx_b and `bits` ((b,
// ceil((r - k + 1) / 8), m) uint8) as compact.cu writes them.  The row
// arguments are grafimo_scan_runs's; `cutoffs` is (m,) int32.  Zeroes
// `hist` and *count first.  Returns the cudaError_t of the memsets or the
// launch (0 = success), cudaErrorInvalidValue when no layout fits (the
// caller's plan sends those shapes to the three launches); it does not
// synchronise.
extern "C" int grafimo_scan_runs_fused(
    int source, const void* packed, int packed_w, const void* nbits,
    int nbits_w, const void* genome, long long n_words, const void* ngenome,
    long long n_nwords, const void* gstart, long long lo, long long stride,
    const void* patches, int n_patch, const void* splice, int n_pairs,
    int clear_n, const void* vbits, int vbits_w, const void* lut,
    const void* min_scores, long long b, int r, int k, int m,
    const void* cutoffs, const void* bases, int comp_size, void* hist,
    void* count, void* idx_a, int cap_a, void* idx_b, int cap_b, void* bits,
    int dev, void* stream) {
  FusedArgs f = {};
  cudaError_t err = scan_args(
      source, packed, packed_w, nbits, nbits_w, genome, n_words, ngenome,
      n_nwords, gstart, lo, stride, patches, n_patch, splice, n_pairs,
      clear_n, vbits, vbits_w, lut, min_scores, b, r, k, m, &f.s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (comp_size <= 0 || cap_a < 0 || cap_b < 0 || m > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(hist, 0, static_cast<size_t>(comp_size) * m * 4, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (err != cudaSuccess || b == 0) return static_cast<int>(err);
  if (b * (r - k + 1) * static_cast<int64_t>(m) >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceInfo* d = nullptr;
  err = device_info(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_fused(m, k, r, comp_size, d->smem_block, &f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  f.cutoffs = static_cast<const int32_t*>(cutoffs);
  f.bases = static_cast<const int32_t*>(bases);
  f.comp_size = comp_size;
  f.hist = static_cast<int32_t*>(hist);
  f.count = static_cast<int32_t*>(count);
  f.idx_a = static_cast<int32_t*>(idx_a);
  f.cap_a = cap_a;
  f.idx_b = static_cast<int32_t*>(idx_b);
  f.cap_b = cap_b;
  f.bits = static_cast<uint8_t*>(bits);
  return static_cast<int>(launch_fused(*d, dev, f, s));
}

// The dynamic shared memory a block may opt in to on `dev` (the fused
// route's plan reads it), or 0 when `dev` cannot be queried.
extern "C" int grafimo_smem_block(int dev) {
  const DeviceInfo* d = nullptr;
  if (device_info(dev, &d) != cudaSuccess) return 0;
  return d->smem_block;
}
