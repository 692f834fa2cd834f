// graphite.cpp — native engine for grafimo_tpu.
//
// Hosts the hot host-side paths of the framework:
//   * strict left-to-right tail sums of the Staden score distribution
//     (parity with the reference's numba-sequential reduction,
//     reference score_sequences.py:390-391);
//   * variation-graph window enumeration + haplotype counting
//     (replaces the external `vg find -p -H -K -E` subprocess fan-out,
//     reference extract_regions.py:180,225).
//
// Compiled on demand by grafimo_tpu/native/__init__.py with g++ -O3 and
// bound through ctypes (no pybind11 in this environment).

#include <array>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <atomic>
#include <functional>
#include <thread>

namespace {

// ---------------------------------------------------------------------------
// Run-compressed window extraction (mirrors grafimo_tpu/graph/runs.py —
// the python implementation is the semantic reference; this is the
// production-speed engine, differentially tested against it).
// ---------------------------------------------------------------------------

struct SiteView {
  int64_t start, end;       // trimmed ref span (end == start: insertion)
  int64_t allele_off;       // first allele index
  int32_t n_alleles;        // alleles incl. ref (index 0)
};

struct RunOut {
  std::vector<uint8_t> codes;   // 0..3, 4 = N
  std::vector<uint8_t> valid;   // one byte per window offset
  int32_t cluster_idx;          // -1 = backbone
  int32_t combo_idx;
  // substitution-only combinations are genome-aligned: codes[j] ==
  // seq[flank_l + j] except at `patches` (run offset, base) — such rows
  // ship to the device as descriptors instead of packed bytes
  bool patchable = false;
  int64_t flank_l = 0;
  std::vector<std::pair<int64_t, uint8_t>> patches;
  // indel combinations are genome-aligned PIECEWISE: codes[j] ==
  // seq[flank_l + j + shift] with shift stepping at `breaks`
  // ((run offset, shift after) pairs) and `patches` overriding
  // inserted/substituted bases — the span-splice resident
  // representation (ops/score_runs.scan_runs_resident_spliced_topk)
  bool spliceable = false;
  std::vector<std::pair<int64_t, int64_t>> breaks;
};

struct RunSet {
  std::vector<RunOut> runs;
  int32_t status = 0;  // 0 ok; 1 >=1 cluster hit the combination cap
  // clusters whose candidate enumeration overflowed — the caller runs
  // the exact per-window fallback for THESE clusters only; all other
  // clusters' runs are emitted normally (cluster-local degradation)
  std::vector<int32_t> overflow_clusters;
  // (cluster, anchor) pairs of anchored-decomposition anchors whose
  // window-sharing combination count exceeded DENSE_ANCHOR_COMBOS —
  // the caller per-window-enumerates those anchors' rows only
  std::vector<int32_t> dense_anchor_fallbacks;
};

// Anchored decomposition of over-dense clusters (mirrors
// graph/runs.dense_cluster_runs — the python generator is the spec and
// the differential oracle).  Emitted rows carry a lazily-resolvable
// ref spread over BOTH int32 meta fields (the chaining rule's
// accumulated-deletable slack merges a whole 1KGP chromosome into one
// multi-million-site cluster, so the anchor index alone can overflow
// one field):
//   cluster_idx = -3 - (ci * DENSE_CLUSTER_MULT + anchor_block)
//   combo_idx   = (anchor % DENSE_ANCHOR_BLOCK) * DENSE_COMBO_STRIDE
//                 + ordinal,  anchor_block = anchor / DENSE_ANCHOR_BLOCK
// where ordinal 0 is the anchor's ownership-filtered all-ref row and
// 1+x is _anchored_combos()[x]; graph/runs.build_single_run decodes it
// for hit reconstruction.  Capacity: clusters to 128 * 2^18 = 33.5 M
// sites, 16.7 M clusters per region.  Constants MUST stay equal to
// graph/runs.py.
constexpr int64_t DENSE_ANCHOR_COMBOS = int64_t(1) << 12;
constexpr int64_t DENSE_COMBO_STRIDE = DENSE_ANCHOR_COMBOS + 2;
constexpr int64_t DENSE_ANCHOR_BLOCK = int64_t(1) << 18;
constexpr int64_t DENSE_CLUSTER_MULT = 128;

struct GraphView {
  const uint8_t* seq;
  int64_t L;
  std::vector<SiteView> sites;
  const int64_t* allele_off;
  const int64_t* allele_len;
  const uint8_t* allele_blob;
};

int64_t site_deletable(const GraphView& g, const SiteView& s) {
  int64_t span = s.end - s.start;
  int64_t min_len = INT64_MAX;
  for (int32_t a = 0; a < s.n_alleles; ++a)
    min_len = std::min(min_len, g.allele_len[s.allele_off + a]);
  return std::max<int64_t>(0, span - min_len);
}

// build one (cluster, combination) run; returns false if it has no valid
// window (mirrors _build_cluster_run, runs.py).  own_ctx >= 0 applies
// the anchored all-ref ownership filter of dense_cluster_runs: keep
// only windows determined by the site at cluster index own_ctx and by
// NO earlier cluster site (runs.py dense_cluster_runs r0 filtering).
bool build_cluster_run(const GraphView& g,
                       const std::vector<int>& cluster,  // site indices
                       const std::vector<int>& combo,
                       int64_t region_start, int64_t region_end, int64_t k,
                       RunOut* out, int own_ctx = -1) {
  const SiteView& first = g.sites[cluster.front()];
  const SiteView& last = g.sites[cluster.back()];
  int64_t flank_l = std::max<int64_t>(0, first.start - (k - 1));
  int64_t flank_r = std::min<int64_t>(g.L, last.end + (k - 1));

  std::vector<uint8_t>& codes = out->codes;
  codes.clear();
  std::vector<int64_t> pos_begin;
  std::vector<int64_t> pos_end;  // pos_end[j+1] = end coord after base j
  pos_end.push_back(flank_l);
  // per cluster site: determined interval [lo, hi] and allele index
  struct Det { int64_t lo, hi; int a_idx; };
  std::vector<Det> det;

  auto emit_ref = [&](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      codes.push_back(g.seq[c]);
      pos_begin.push_back(c);
      pos_end.push_back(c + 1);
    }
  };

  emit_ref(flank_l, first.start);
  out->flank_l = flank_l;
  // piecewise genome alignment: genome_pos = flank_l + dst + shift,
  // with shift stepping after every length-changing allele.
  //   patchable: shift stays 0 and every patched base is ACGT over ACGT
  //     reference (the patched kernel keeps the genome N plane);
  //   spliceable: shift steps ride `breaks`, ALL alt-region mismatches
  //     are ACGT patches (the spliced kernel zeroes N at patched
  //     offsets, so the reference base under a patch may be anything).
  out->patchable = true;
  out->spliceable = true;
  out->patches.clear();
  out->breaks.clear();
  int64_t shift = 0;
  int64_t cursor = first.start;
  for (size_t i = 0; i < cluster.size(); ++i) {
    const SiteView& s = g.sites[cluster[i]];
    int a_idx = combo[i];
    emit_ref(cursor, s.start);
    int64_t alen = g.allele_len[s.allele_off + a_idx];
    int64_t rlen = s.end - s.start;
    const uint8_t* aseq = g.allele_blob + g.allele_off[s.allele_off + a_idx];
    int64_t a_start = (int64_t)codes.size();
    if (out->spliceable) {
      for (int64_t o = 0; o < alen; ++o) {
        int64_t dst = a_start + o;
        int64_t gpos = flank_l + dst + shift;
        uint8_t refc = gpos < g.L ? g.seq[gpos] : (uint8_t)255;
        if (aseq[o] == refc) continue;
        if (aseq[o] >= 4) {  // not 2-bit encodable as a patch
          out->patchable = false;
          out->spliceable = false;
          out->patches.clear();
          break;
        }
        if (refc >= 4) out->patchable = false;  // N plane would leak
        out->patches.emplace_back(dst, aseq[o]);
      }
    }
    if (alen != rlen) {
      out->patchable = false;
      shift += rlen - alen;
      out->breaks.emplace_back(a_start + alen, shift);
    }
    if (alen == 0) {
      det.push_back({a_start - k + 1, a_start - 1, a_idx});
    } else {
      for (int64_t o = 0; o < alen; ++o) {
        codes.push_back(aseq[o]);
        pos_begin.push_back(std::min(s.start + o, s.end));
        pos_end.push_back(o + 1 == alen ? s.end
                                        : std::min(s.start + o + 1, s.end));
      }
      det.push_back({a_start - k + 1, a_start + alen - 1, a_idx});
    }
    cursor = s.end;
  }
  emit_ref(cursor, flank_r);

  int64_t Lr = (int64_t)codes.size();
  if (Lr < k) return false;
  int64_t noff = Lr - k + 1;
  std::vector<uint8_t>& valid = out->valid;
  valid.assign(noff, 1);
  std::vector<uint8_t> any_det(noff, 0);
  for (const Det& d : det) {
    int64_t lo = std::max<int64_t>(d.lo, 0);
    int64_t hi = std::min<int64_t>(d.hi, noff - 1);
    for (int64_t o = lo; o <= hi; ++o) any_det[o] = 1;
    if (d.a_idx != 0) {
      for (int64_t o = 0; o < noff; ++o)
        if (o < lo || o > hi) valid[o] = 0;
      if (lo > hi) return false;  // non-ref choice never determined
    }
  }
  bool any = false;
  for (int64_t o = 0; o < noff; ++o) {
    if (!any_det[o]) valid[o] = 0;
    if (pos_begin[o] < region_start) valid[o] = 0;
    if (pos_end[o + k] > region_end) valid[o] = 0;
    any |= (valid[o] != 0);
  }
  if (any && own_ctx >= 0) {
    const Det& dc = det[own_ctx];
    int64_t olo = std::max<int64_t>(dc.lo, 0);
    int64_t ohi = std::min<int64_t>(dc.hi, noff - 1);
    any = false;
    for (int64_t o = 0; o < noff; ++o) {
      bool own = o >= olo && o <= ohi;
      for (int c = 0; own && c < own_ctx; ++c)
        if (o >= std::max<int64_t>(det[c].lo, 0) &&
            o <= std::min<int64_t>(det[c].hi, noff - 1))
          own = false;
      if (!own) valid[o] = 0;
      any |= (valid[o] != 0);
    }
  }
  return any;
}

bool build_backbone_run(const GraphView& g,
                        const std::vector<std::vector<int>>& clusters,
                        int64_t region_start, int64_t region_end, int64_t k,
                        RunOut* out) {
  int64_t lo = std::max<int64_t>(0, region_start);
  int64_t hi = std::min<int64_t>(g.L, region_end);
  int64_t Lr = hi - lo;
  if (Lr < k) return false;
  int64_t noff = Lr - k + 1;
  out->codes.assign(g.seq + lo, g.seq + hi);
  out->valid.assign(noff, 1);
  bool any = false;
  for (const auto& cl : clusters) {
    for (int si : cl) {
      const SiteView& s = g.sites[si];
      // offsets (begin coords) are lo + o
      int64_t d_lo, d_hi;
      if (s.end > s.start) {
        d_lo = s.start - k + 1 - lo;   // o + k > s.start
        d_hi = s.end - 1 - lo;         // o < s.end
      } else {
        d_lo = s.start - k + 1 - lo;   // o + k > s.start
        d_hi = s.start - 1 - lo;       // o < s.start
      }
      d_lo = std::max<int64_t>(d_lo, 0);
      d_hi = std::min<int64_t>(d_hi, noff - 1);
      for (int64_t o = d_lo; o <= d_hi; ++o) out->valid[o] = 0;
    }
  }
  for (int64_t o = 0; o < noff; ++o) any |= (out->valid[o] != 0);
  return any;
}

// Candidate combination enumeration (mirrors runs.candidate_combos —
// the python spec): a combination can yield a valid window only when the
// determined intervals of all its non-reference choices intersect, so a
// DFS over non-ref supports with running interval intersection visits
// only contributing combos.  Returns false on overflow: full combination
// count does not fit the int32 combo-idx identity, or the candidate
// count exceeds max_combos (callers fall back to exact per-window
// enumeration).  Output is sorted by mixed-radix combo index and always
// contains the all-reference combo.
bool enumerate_candidates(
    const GraphView& g, const std::vector<int>& cl, int64_t k,
    int64_t max_combos,
    std::vector<std::pair<int64_t, std::vector<int>>>* out) {
  const size_t n = cl.size();
  std::vector<int64_t> weights(n, 1);
  int64_t w = 1;
  for (size_t i = n; i-- > 0;) {
    weights[i] = w;
    w *= g.sites[cl[i]].n_alleles;
    // (cluster, combo) hit identities ride int32 metadata — mirrors the
    // python spec's COMBO_IDX_MAX check; also guards int64 overflow of w
    if (w > (int64_t)INT32_MAX) return false;
  }
  int64_t flank_l = std::max<int64_t>(0, g.sites[cl[0]].start - (k - 1));
  // all-reference path offset of each site's allele region (ref alleles
  // span the site exactly, so prefix deltas come only from chosen alts)
  std::vector<int64_t> base(n);
  int64_t rd = 0;
  for (size_t i = 0; i < n; ++i) {
    const SiteView& s = g.sites[cl[i]];
    base[i] = s.start - flank_l + rd;
    rd += g.allele_len[s.allele_off] - (s.end - s.start);
  }
  out->clear();
  out->emplace_back(0, std::vector<int>(n, 0));
  std::vector<int> combo(n, 0);
  bool ok = true;
  // recursion depth is bounded by the non-ref sites sharing one window
  // (the interval shrinks to < k + max allele length after the first
  // choice and sites are disjoint), not by cluster length
  std::function<void(size_t, int64_t, int64_t, int64_t, int64_t)> extend =
      [&](size_t start_i, int64_t ilo, int64_t ihi, int64_t delta,
          int64_t idx) {
        for (size_t i = start_i; i < n && ok; ++i) {
          const SiteView& s = g.sites[cl[i]];
          int64_t lo = base[i] + delta - k + 1;
          if (lo > ihi) break;  // later sites start even further right
          int64_t span_d = base[i] + delta;
          for (int a = 1; a < s.n_alleles && ok; ++a) {
            int64_t alen = g.allele_len[s.allele_off + a];
            int64_t hi = alen == 0 ? span_d - 1 : span_d + alen - 1;
            int64_t nlo = std::max(ilo, lo);
            int64_t nhi = std::min(ihi, hi);
            if (nlo > nhi) continue;
            combo[i] = a;
            int64_t nidx = idx + a * weights[i];
            out->emplace_back(nidx, combo);
            if ((int64_t)out->size() > max_combos) { ok = false; break; }
            extend(i + 1, nlo, nhi,
                   delta + alen - g.allele_len[s.allele_off], nidx);
            combo[i] = 0;
          }
        }
      };
  const int64_t big = int64_t(1) << 62;
  extend(0, -big, big, 0, 0);
  if (!ok) return false;
  std::sort(out->begin(), out->end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  return true;
}

// All allele combinations over cluster[i0..j] whose support shares one
// window AND includes site i0 (forced non-ref) — mirrors
// runs._anchored_combos EXACTLY, pre-order DFS, python's overflow point
// included (the cap check fires only inside the recursive extension,
// matching the python generator's raise site so native and python agree
// on WHICH anchors fall back).  Returns false on overflow.
bool anchored_combos(const GraphView& g, const std::vector<int>& cl,
                     size_t i0, size_t j, int64_t k,
                     std::vector<std::vector<int>>* out) {
  const size_t n = j - i0 + 1;
  int64_t flank_l = std::max<int64_t>(0, g.sites[cl[i0]].start - (k - 1));
  std::vector<int64_t> base(n);
  int64_t rd = 0;
  for (size_t t = 0; t < n; ++t) {
    const SiteView& s = g.sites[cl[i0 + t]];
    base[t] = s.start - flank_l + rd;
    rd += g.allele_len[s.allele_off] - (s.end - s.start);
  }
  out->clear();
  std::vector<int> combo(n, 0);
  bool ok = true;
  std::function<void(size_t, int64_t, int64_t, int64_t)> extend =
      [&](size_t start_i, int64_t ilo, int64_t ihi, int64_t delta) {
        for (size_t t = start_i; t < n && ok; ++t) {
          const SiteView& s = g.sites[cl[i0 + t]];
          int64_t lo = base[t] + delta - k + 1;
          if (lo > ihi) break;  // later sites start even further right
          int64_t span_d = base[t] + delta;
          for (int a = 1; a < s.n_alleles && ok; ++a) {
            int64_t alen = g.allele_len[s.allele_off + a];
            int64_t hi = alen == 0 ? span_d - 1 : span_d + alen - 1;
            int64_t nlo = std::max(ilo, lo);
            int64_t nhi = std::min(ihi, hi);
            if (nlo > nhi) continue;
            combo[t] = a;
            out->push_back(combo);
            if ((int64_t)out->size() > DENSE_ANCHOR_COMBOS) {
              ok = false;
              break;
            }
            extend(t + 1, nlo, nhi,
                   delta + alen - g.allele_len[s.allele_off]);
            combo[t] = 0;
          }
        }
      };
  const SiteView& s0 = g.sites[cl[i0]];
  for (int a = 1; a < s0.n_alleles && ok; ++a) {
    int64_t alen = g.allele_len[s0.allele_off + a];
    int64_t hi0 = alen == 0 ? base[0] - 1 : base[0] + alen - 1;
    int64_t lo0 = base[0] - k + 1;
    combo[0] = a;
    // python appends WITHOUT a cap check at the top level — mirror it
    out->push_back(combo);
    extend(1, lo0, hi0, alen - g.allele_len[s0.allele_off]);
    combo[0] = 0;
  }
  return ok;
}

// anchor geometry (mirrors runs._anchor_bounds): [l, j] = left-context
// start and rightward window-sharing reach of anchor i
void anchor_bounds(const GraphView& g, const std::vector<int>& cl,
                   const std::vector<int64_t>& del_pref, size_t i,
                   int64_t k, size_t* l_out, size_t* j_out) {
  const size_t n = cl.size();
  size_t j = i;
  while (j + 1 < n) {
    const SiteView& nx = g.sites[cl[j + 1]];
    int64_t slack = del_pref[j + 1] - del_pref[i];
    if (nx.start - g.sites[cl[i]].end < k + slack)
      ++j;
    else
      break;
  }
  size_t l = i;
  while (l > 0 &&
         g.sites[cl[l - 1]].end > g.sites[cl[i]].start - k + 1)
    --l;
  *l_out = l;
  *j_out = j;
}

// anchored decomposition of ONE over-dense cluster (mirrors
// runs.dense_cluster_runs): per anchor i, an ownership-filtered all-ref
// row (ordinal 0) plus one row per window-sharing combination rooted at
// i (ordinal 1+x); anchors past DENSE_ANCHOR_COMBOS are recorded for
// the exact per-window python fallback.
void dense_cluster_runs_native(const GraphView& g,
                               const std::vector<int>& cl, int32_t ci,
                               int64_t region_start, int64_t region_end,
                               int64_t k, RunSet* rs) {
  const size_t n = cl.size();
  std::vector<int64_t> del_pref(n + 1, 0);
  for (size_t t = 0; t < n; ++t)
    del_pref[t + 1] = del_pref[t] + site_deletable(g, g.sites[cl[t]]);
  std::vector<std::vector<int>> combos;
  std::vector<int> sub_full, combo_full;
  for (size_t i = 0; i < n; ++i) {
    size_t l, j;
    anchor_bounds(g, cl, del_pref, i, k, &l, &j);
    size_t ctx = i - l;
    sub_full.assign(cl.begin() + l, cl.begin() + j + 1);
    combo_full.assign(sub_full.size(), 0);
    const int32_t c_field = (int32_t)(
        -3 - ((int64_t)ci * DENSE_CLUSTER_MULT
              + (int64_t)i / DENSE_ANCHOR_BLOCK));
    const int64_t a_rem = (int64_t)i % DENSE_ANCHOR_BLOCK;
    RunOut r0;
    if (build_cluster_run(g, sub_full, combo_full, region_start,
                          region_end, k, &r0, (int)ctx)) {
      r0.cluster_idx = c_field;
      r0.combo_idx = (int32_t)(a_rem * DENSE_COMBO_STRIDE);
      rs->runs.push_back(std::move(r0));
    }
    if (!anchored_combos(g, cl, i, j, k, &combos)) {
      rs->dense_anchor_fallbacks.push_back(ci);
      rs->dense_anchor_fallbacks.push_back((int32_t)i);
      continue;
    }
    for (size_t x = 0; x < combos.size(); ++x) {
      for (size_t t = 0; t < sub_full.size(); ++t)
        combo_full[t] = t < ctx ? 0 : combos[x][t - ctx];
      RunOut r;
      if (build_cluster_run(g, sub_full, combo_full, region_start,
                            region_end, k, &r)) {
        r.cluster_idx = c_field;
        r.combo_idx =
            (int32_t)(a_rem * DENSE_COMBO_STRIDE + 1 + (int64_t)x);
        rs->runs.push_back(std::move(r));
      }
    }
  }
}

RunSet* build_runs_impl(const GraphView& g, int64_t region_start,
                        int64_t region_end, int64_t k, int64_t max_combos,
                        bool dense_native = false) {
  auto* rs = new RunSet();
  // cluster decomposition (mirrors cluster_sites, runs.py).  Sites are
  // sorted and non-overlapping, so binary-search the first candidate
  // instead of scanning the whole chromosome per region.
  std::vector<std::vector<int>> clusters;
  int64_t d_cur = 0;
  size_t first = std::lower_bound(
                     g.sites.begin(), g.sites.end(), region_start,
                     [](const SiteView& s, int64_t v) { return s.end < v; }) -
                 g.sites.begin();
  for (size_t i = first; i < g.sites.size(); ++i) {
    const SiteView& s = g.sites[i];
    if (s.start > region_end) break;
    if (s.end < region_start) continue;
    if (!clusters.empty() &&
        s.start - g.sites[clusters.back().back()].end < k + d_cur + 1) {
      clusters.back().push_back((int)i);
      d_cur += site_deletable(g, s);
    } else {
      clusters.push_back({(int)i});
      d_cur = site_deletable(g, s);
    }
  }
  RunOut bb;
  if (build_backbone_run(g, clusters, region_start, region_end, k, &bb)) {
    bb.cluster_idx = -1;
    bb.combo_idx = 0;
    rs->runs.push_back(std::move(bb));
  }
  std::vector<std::pair<int64_t, std::vector<int>>> cands;
  for (size_t ci = 0; ci < clusters.size(); ++ci) {
    const auto& cl = clusters[ci];
    if (!enumerate_candidates(g, cl, k, max_combos, &cands)) {
      // over-dense cluster: anchored decomposition in-process (the
      // python generator is the spec; MHC-class pockets AND the
      // chained mega-clusters of whole 1KGP chromosomes build here at
      // native speed with no python Run materialisation) unless its
      // blocked (cluster, anchor, ordinal) identity would not fit the
      // two int32 meta fields — then the legacy python fallback
      if (dense_native &&
          (int64_t)cl.size() <=
              DENSE_CLUSTER_MULT * DENSE_ANCHOR_BLOCK &&
          (int64_t)ci * DENSE_CLUSTER_MULT + DENSE_CLUSTER_MULT <
              (int64_t)INT32_MAX - 3) {
        dense_cluster_runs_native(g, cl, (int32_t)ci, region_start,
                                  region_end, k, rs);
        continue;
      }
      rs->status = 1;
      rs->overflow_clusters.push_back((int32_t)ci);
      continue;
    }
    // mixed-radix combo indices, last site fastest (matches
    // runs.candidate_combos / nth_combination order)
    for (const auto& [xi, combo] : cands) {
      RunOut out;
      if (build_cluster_run(g, cl, combo, region_start, region_end, k,
                            &out)) {
        out.cluster_idx = (int32_t)ci;
        out.combo_idx = (int32_t)xi;
        rs->runs.push_back(std::move(out));
      }
    }
  }
  return rs;
}

// ---------------------------------------------------------------------------
// Full batch pipeline: regions -> device-ready bucketed bit-packed batches
// (mirrors runscan.batch_runs; removes all per-chunk python work)
// ---------------------------------------------------------------------------

struct BucketBuf {
  int64_t R = 0;
  int64_t rows = 0;
  std::vector<uint8_t> packed;  // rows x R/4
  std::vector<uint8_t> nbits;   // rows x R/8
  std::vector<uint8_t> vbits;   // rows x ceil((R-k+1)/8)
  std::vector<int32_t> meta;    // rows x 4: region, cluster, combo, chunk_off
  // device-resident patched rows (substitution-only cluster chunks):
  // 4B genome offset + slots x 2B patch descriptors instead of packed
  // bytes — the host->device link is bandwidth-bound, bytes are the lever
  int64_t slots = 0;  // 0 = patching disabled for this bucket
  int64_t rows_p = 0;
  std::vector<int64_t> gstart_p;   // rows_p
  std::vector<int16_t> pat_p;      // rows_p x slots, -1 = empty
  std::vector<uint8_t> vbits_p;    // rows_p x ceil((R-k+1)/8)
  std::vector<int32_t> meta_p;     // rows_p x 4
  // span-spliced rows (indel cluster chunks): genome offset + up to
  // SPLICE_BREAKS (bound, shift) int16 pairs + patch slots — the row is
  // genome[gstart + shift_seg : ...] piecewise with inserted/changed
  // bases patched (ops/score_runs.scan_runs_resident_spliced_topk)
  int64_t rows_s = 0;
  std::vector<int64_t> gstart_s;   // rows_s
  std::vector<int16_t> splice_s;   // rows_s x (2*SPLICE_BREAKS)
  std::vector<int16_t> pat_s;      // rows_s x slots, -1 = empty
  std::vector<uint8_t> vbits_s;    // rows_s x ceil((R-k+1)/8)
  std::vector<int32_t> meta_s;     // rows_s x 4
};

// max genome-alignment steps (indels) per spliced chunk; bound 0x7fff
// marks an unused pair.  One indel per window is the overwhelmingly
// common case (candidate combos put all non-ref choices in one window).
constexpr int64_t SPLICE_BREAKS = 2;
constexpr int16_t SPLICE_UNUSED = 0x7fff;

struct BatchSet {
  std::vector<BucketBuf> buckets;
  int64_t k = 0;
  // flattened (region_idx, cluster_idx) pairs whose candidate
  // enumeration overflowed; every other cluster's runs ARE in the
  // buckets — the caller per-window-enumerates only these clusters
  std::vector<int32_t> overflow_pairs;
  // flattened (region_idx, cluster_idx, anchor_idx) triples of dense
  // anchors past DENSE_ANCHOR_COMBOS — the caller per-window-
  // enumerates only those anchors' rows (_anchor_window_fallback)
  std::vector<int32_t> dense_fallbacks;
};

void append_chunk(BucketBuf* b, int64_t k, const uint8_t* codes,
                  const uint8_t* valid, int64_t chunk_len, int64_t take_off,
                  int32_t region, int32_t cluster, int32_t combo,
                  int32_t chunk_off) {
  const int64_t w4 = b->R / 4;
  const int64_t w8 = (b->R + 7) / 8;
  const int64_t noff = b->R - k + 1;
  const int64_t vw = (noff + 7) / 8;
  size_t p0 = b->packed.size();
  b->packed.resize(p0 + w4, 0);
  size_t n0 = b->nbits.size();
  b->nbits.resize(n0 + w8, 0);
  size_t v0 = b->vbits.size();
  b->vbits.resize(v0 + vw, 0);
  for (int64_t j = 0; j < chunk_len; ++j) {
    uint8_t c = codes[j];
    if (c >= 4) {
      b->nbits[n0 + (j >> 3)] |= (uint8_t)(1u << (j & 7));
      c = 0;
    }
    b->packed[p0 + (j >> 2)] |= (uint8_t)(c << (2 * (j & 3)));
  }
  for (int64_t o = 0; o < take_off; ++o)
    if (valid[o])
      b->vbits[v0 + (o >> 3)] |= (uint8_t)(1u << (o & 7));
  b->meta.push_back(region);
  b->meta.push_back(cluster);
  b->meta.push_back(combo);
  b->meta.push_back(chunk_off);
  b->rows += 1;
}

void append_patched(BucketBuf* b, int64_t k, const RunOut& r, int64_t pos,
                    int64_t take_off, int64_t p_lo, int64_t p_hi,
                    int32_t region) {
  const int64_t noff = b->R - k + 1;
  const int64_t vw = (noff + 7) / 8;
  size_t v0 = b->vbits_p.size();
  b->vbits_p.resize(v0 + vw, 0);
  for (int64_t o = 0; o < take_off; ++o)
    if (r.valid[pos + o])
      b->vbits_p[v0 + (o >> 3)] |= (uint8_t)(1u << (o & 7));
  b->gstart_p.push_back(r.flank_l + pos);
  size_t s0 = b->pat_p.size();
  b->pat_p.resize(s0 + b->slots, (int16_t)-1);
  for (int64_t pi = p_lo; pi < p_hi; ++pi)  // patches are run offsets
    b->pat_p[s0 + (pi - p_lo)] =
        (int16_t)((r.patches[pi].first - pos) * 4 + r.patches[pi].second);
  b->meta_p.push_back(region);
  b->meta_p.push_back(r.cluster_idx);
  b->meta_p.push_back(r.combo_idx);
  b->meta_p.push_back((int32_t)pos);
  b->rows_p += 1;
}

void append_spliced(BucketBuf* b, int64_t k, const RunOut& r, int64_t pos,
                    int64_t take_off, int64_t p_lo, int64_t p_hi,
                    int64_t shift0, int64_t brk_lo, int64_t brk_hi,
                    int32_t region) {
  const int64_t noff = b->R - k + 1;
  const int64_t vw = (noff + 7) / 8;
  size_t v0 = b->vbits_s.size();
  b->vbits_s.resize(v0 + vw, 0);
  for (int64_t o = 0; o < take_off; ++o)
    if (r.valid[pos + o])
      b->vbits_s[v0 + (o >> 3)] |= (uint8_t)(1u << (o & 7));
  b->gstart_s.push_back(r.flank_l + pos + shift0);
  size_t e0 = b->splice_s.size();
  b->splice_s.resize(e0 + 2 * SPLICE_BREAKS, SPLICE_UNUSED);
  for (int64_t bi = brk_lo; bi < brk_hi; ++bi) {
    b->splice_s[e0 + 2 * (bi - brk_lo)] =
        (int16_t)(r.breaks[bi].first - pos);
    b->splice_s[e0 + 2 * (bi - brk_lo) + 1] =
        (int16_t)(r.breaks[bi].second - shift0);
  }
  size_t s0 = b->pat_s.size();
  b->pat_s.resize(s0 + b->slots, (int16_t)-1);
  for (int64_t pi = p_lo; pi < p_hi; ++pi)
    b->pat_s[s0 + (pi - p_lo)] =
        (int16_t)((r.patches[pi].first - pos) * 4 + r.patches[pi].second);
  b->meta_s.push_back(region);
  b->meta_s.push_back(r.cluster_idx);
  b->meta_s.push_back(r.combo_idx);
  b->meta_s.push_back((int32_t)pos);
  b->rows_s += 1;
}

void fill_batchset(BatchSet* bs, const GraphView& g,
                   const int64_t* region_starts, const int64_t* region_ends,
                   int64_t k, const int64_t* bucket_sizes, int64_t n_buckets,
                   int64_t max_combos, std::atomic<int64_t>* next_region,
                   int64_t n_regions, bool dense_native) {
  const int64_t stride_base = bucket_sizes[n_buckets - 1] - k + 1;
  auto place_run = [&](const RunOut& r, int32_t region) {
    int64_t L = (int64_t)r.codes.size();
    int64_t noff_total = L - k + 1;
    int64_t pos = 0;
    size_t p_cursor = 0;   // patches are emitted in ascending run order
    size_t brk_cursor = 0;  // ditto for alignment breaks
    while (pos < noff_total) {
      int64_t take_off = std::min(stride_base, noff_total - pos);
      int64_t chunk_len = take_off + k - 1;
      int64_t bi = 0;
      while (bucket_sizes[bi] < chunk_len) ++bi;
      BucketBuf* b = &bs->buckets[bi];
      // descriptor-eligible rows: cluster combinations (>= 0) AND dense
      // anchored rows (<= -3) — only the backbone (-1) expands via its
      // own strided path
      if (r.cluster_idx != -1 && b->slots > 0 &&
          (r.patchable || r.spliceable)) {
        // patches covered by this chunk: run offsets in [pos, pos + R)
        while (p_cursor < r.patches.size() &&
               r.patches[p_cursor].first < pos)
          ++p_cursor;
        size_t p_end = p_cursor;
        while (p_end < r.patches.size() &&
               r.patches[p_end].first < pos + b->R)
          ++p_end;
        if (r.patchable) {
          if ((int64_t)(p_end - p_cursor) <= b->slots) {
            append_patched(b, k, r, pos, take_off, (int64_t)p_cursor,
                           (int64_t)p_end, region);
            pos += take_off;
            continue;
          }
        } else {
          // span-spliced: breaks at run offsets <= pos fold into the
          // chunk's base shift; breaks inside (pos, pos + chunk_len)
          // become (bound, shift) entries
          while (brk_cursor < r.breaks.size() &&
                 r.breaks[brk_cursor].first <= pos)
            ++brk_cursor;
          int64_t shift0 =
              brk_cursor ? r.breaks[brk_cursor - 1].second : 0;
          size_t brk_end = brk_cursor;
          while (brk_end < r.breaks.size() &&
                 r.breaks[brk_end].first < pos + chunk_len)
            ++brk_end;
          bool ok = (int64_t)(p_end - p_cursor) <= b->slots &&
                    (int64_t)(brk_end - brk_cursor) <= SPLICE_BREAKS &&
                    r.flank_l + pos + shift0 >= 0;
          for (size_t x = brk_cursor; ok && x < brk_end; ++x) {
            int64_t rel = r.breaks[x].second - shift0;
            ok = r.flank_l + pos + r.breaks[x].second >= 0 &&
                 rel > -SPLICE_UNUSED && rel < SPLICE_UNUSED;
          }
          if (ok) {
            append_spliced(b, k, r, pos, take_off, (int64_t)p_cursor,
                           (int64_t)p_end, shift0, (int64_t)brk_cursor,
                           (int64_t)brk_end, region);
            pos += take_off;
            continue;
          }
        }
      }
      append_chunk(b, k, r.codes.data() + pos, r.valid.data() + pos,
                   chunk_len, take_off, region, r.cluster_idx, r.combo_idx,
                   (int32_t)pos);
      pos += take_off;
    }
  };
  while (true) {
    int64_t ri = next_region->fetch_add(1);
    if (ri >= n_regions) break;
    RunSet* rs = build_runs_impl(g, region_starts[ri], region_ends[ri], k,
                                 max_combos, dense_native);
    for (int32_t ci : rs->overflow_clusters) {
      bs->overflow_pairs.push_back((int32_t)ri);
      bs->overflow_pairs.push_back(ci);
    }
    for (size_t t = 0; t + 1 < rs->dense_anchor_fallbacks.size(); t += 2) {
      bs->dense_fallbacks.push_back((int32_t)ri);
      bs->dense_fallbacks.push_back(rs->dense_anchor_fallbacks[t]);
      bs->dense_fallbacks.push_back(rs->dense_anchor_fallbacks[t + 1]);
    }
    for (const RunOut& r : rs->runs) place_run(r, (int32_t)ri);
    delete rs;
  }
}

BatchSet* batch_regions_impl(const GraphView& g,
                             const int64_t* region_starts,
                             const int64_t* region_ends, int64_t n_regions,
                             int64_t k, const int64_t* bucket_sizes,
                             const int64_t* bucket_slots, int64_t n_buckets,
                             int64_t max_combos, int64_t n_threads,
                             bool dense_native) {
  n_threads = std::max<int64_t>(1, std::min(n_threads, n_regions));
  std::vector<BatchSet*> partials(n_threads);
  for (auto& p : partials) {
    p = new BatchSet();
    p->k = k;
    p->buckets.resize(n_buckets);
    for (int64_t i = 0; i < n_buckets; ++i) {
      p->buckets[i].R = bucket_sizes[i];
      p->buckets[i].slots = bucket_slots ? bucket_slots[i] : 0;
    }
  }
  // regions are claimed from a shared counter; each worker fills its own
  // BatchSet (share-nothing), merged below
  std::atomic<int64_t> next_region{0};
  if (n_threads == 1) {
    fill_batchset(partials[0], g, region_starts, region_ends, k,
                  bucket_sizes, n_buckets, max_combos, &next_region,
                  n_regions, dense_native);
  } else {
    std::vector<std::thread> workers;
    for (int64_t t = 0; t < n_threads; ++t)
      workers.emplace_back(fill_batchset, partials[t], std::cref(g),
                           region_starts, region_ends, k, bucket_sizes,
                           n_buckets, max_combos, &next_region, n_regions,
                           dense_native);
    for (auto& w : workers) w.join();
  }
  BatchSet* bs = partials[0];
  for (int64_t t = 1; t < n_threads; ++t) {
    BatchSet* p = partials[t];
    bs->overflow_pairs.insert(bs->overflow_pairs.end(),
                              p->overflow_pairs.begin(),
                              p->overflow_pairs.end());
    bs->dense_fallbacks.insert(bs->dense_fallbacks.end(),
                               p->dense_fallbacks.begin(),
                               p->dense_fallbacks.end());
    for (int64_t i = 0; i < n_buckets; ++i) {
      BucketBuf& dst = bs->buckets[i];
      BucketBuf& src = p->buckets[i];
      dst.packed.insert(dst.packed.end(), src.packed.begin(),
                        src.packed.end());
      dst.nbits.insert(dst.nbits.end(), src.nbits.begin(), src.nbits.end());
      dst.vbits.insert(dst.vbits.end(), src.vbits.begin(), src.vbits.end());
      dst.meta.insert(dst.meta.end(), src.meta.begin(), src.meta.end());
      dst.rows += src.rows;
      dst.gstart_p.insert(dst.gstart_p.end(), src.gstart_p.begin(),
                          src.gstart_p.end());
      dst.pat_p.insert(dst.pat_p.end(), src.pat_p.begin(), src.pat_p.end());
      dst.vbits_p.insert(dst.vbits_p.end(), src.vbits_p.begin(),
                         src.vbits_p.end());
      dst.meta_p.insert(dst.meta_p.end(), src.meta_p.begin(),
                        src.meta_p.end());
      dst.rows_p += src.rows_p;
      dst.gstart_s.insert(dst.gstart_s.end(), src.gstart_s.begin(),
                          src.gstart_s.end());
      dst.splice_s.insert(dst.splice_s.end(), src.splice_s.begin(),
                          src.splice_s.end());
      dst.pat_s.insert(dst.pat_s.end(), src.pat_s.begin(), src.pat_s.end());
      dst.vbits_s.insert(dst.vbits_s.end(), src.vbits_s.begin(),
                         src.vbits_s.end());
      dst.meta_s.insert(dst.meta_s.end(), src.meta_s.begin(),
                        src.meta_s.end());
      dst.rows_s += src.rows_s;
    }
    delete p;
  }
  return bs;
}

}  // namespace

extern "C" {

void* gt_batch_regions(const uint8_t* seq, int64_t L, int64_t n_sites,
                       const int64_t* site_start, const int64_t* site_end,
                       const int64_t* site_allele_off,
                       const int32_t* site_n_alleles,
                       const int64_t* allele_off, const int64_t* allele_len,
                       const uint8_t* allele_blob,
                       const int64_t* region_starts,
                       const int64_t* region_ends, int64_t n_regions,
                       int64_t k, const int64_t* bucket_sizes,
                       const int64_t* bucket_slots,
                       int64_t n_buckets, int64_t max_combos,
                       int64_t n_threads, int64_t dense_native) {
  GraphView g;
  g.seq = seq;
  g.L = L;
  g.allele_off = allele_off;
  g.allele_len = allele_len;
  g.allele_blob = allele_blob;
  g.sites.reserve(n_sites);
  for (int64_t i = 0; i < n_sites; ++i)
    g.sites.push_back(
        {site_start[i], site_end[i], site_allele_off[i], site_n_alleles[i]});
  BatchSet* bs =
      batch_regions_impl(g, region_starts, region_ends, n_regions, k,
                         bucket_sizes, bucket_slots, n_buckets, max_combos,
                         n_threads, dense_native != 0);
  return bs;
}

int64_t gt_batch_n_dense_fallbacks(void* h) {
  return (int64_t)(((BatchSet*)h)->dense_fallbacks.size() / 3);
}

// out: n x 3 int32 (region_idx, cluster_idx, anchor_idx), sorted for
// determinism (thread merge order is scheduling-dependent)
void gt_batch_dense_fallbacks(void* h, int32_t* out) {
  BatchSet* bs = (BatchSet*)h;
  std::vector<std::array<int32_t, 3>> triples;
  for (size_t i = 0; i + 2 < bs->dense_fallbacks.size(); i += 3)
    triples.push_back({bs->dense_fallbacks[i], bs->dense_fallbacks[i + 1],
                       bs->dense_fallbacks[i + 2]});
  std::sort(triples.begin(), triples.end());
  for (size_t i = 0; i < triples.size(); ++i) {
    out[3 * i] = triples[i][0];
    out[3 * i + 1] = triples[i][1];
    out[3 * i + 2] = triples[i][2];
  }
}

int64_t gt_batch_n_overflows(void* h) {
  return (int64_t)(((BatchSet*)h)->overflow_pairs.size() / 2);
}

// out: n x 2 int32 (region_idx, cluster_idx), sorted for determinism
void gt_batch_overflows(void* h, int32_t* out) {
  BatchSet* bs = (BatchSet*)h;
  std::vector<std::pair<int32_t, int32_t>> pairs;
  for (size_t i = 0; i + 1 < bs->overflow_pairs.size(); i += 2)
    pairs.emplace_back(bs->overflow_pairs[i], bs->overflow_pairs[i + 1]);
  std::sort(pairs.begin(), pairs.end());
  for (size_t i = 0; i < pairs.size(); ++i) {
    out[2 * i] = pairs[i].first;
    out[2 * i + 1] = pairs[i].second;
  }
}

void gt_batch_rows(void* h, int64_t* rows_out, int64_t* rows_p_out,
                   int64_t* rows_s_out) {
  BatchSet* bs = (BatchSet*)h;
  for (size_t i = 0; i < bs->buckets.size(); ++i) {
    rows_out[i] = bs->buckets[i].rows;
    rows_p_out[i] = bs->buckets[i].rows_p;
    rows_s_out[i] = bs->buckets[i].rows_s;
  }
}

// spliced rows: splice is rows_s x (2*SPLICE_BREAKS) int16
int64_t gt_splice_breaks() { return SPLICE_BREAKS; }

void gt_batch_export_spliced(void* h, int64_t bucket, int64_t* gstart,
                             int16_t* splice, int16_t* pat, uint8_t* vbits,
                             int32_t* meta) {
  BucketBuf& b = ((BatchSet*)h)->buckets[bucket];
  std::memcpy(gstart, b.gstart_s.data(),
              b.gstart_s.size() * sizeof(int64_t));
  std::memcpy(splice, b.splice_s.data(),
              b.splice_s.size() * sizeof(int16_t));
  std::memcpy(pat, b.pat_s.data(), b.pat_s.size() * sizeof(int16_t));
  std::memcpy(vbits, b.vbits_s.data(), b.vbits_s.size());
  std::memcpy(meta, b.meta_s.data(), b.meta_s.size() * sizeof(int32_t));
}

void gt_batch_export(void* h, int64_t bucket, uint8_t* packed, uint8_t* nbits,
                     uint8_t* vbits, int32_t* meta) {
  BucketBuf& b = ((BatchSet*)h)->buckets[bucket];
  std::memcpy(packed, b.packed.data(), b.packed.size());
  std::memcpy(nbits, b.nbits.data(), b.nbits.size());
  std::memcpy(vbits, b.vbits.data(), b.vbits.size());
  std::memcpy(meta, b.meta.data(), b.meta.size() * sizeof(int32_t));
}

void gt_batch_export_patched(void* h, int64_t bucket, int64_t* gstart,
                             int16_t* pat, uint8_t* vbits, int32_t* meta) {
  BucketBuf& b = ((BatchSet*)h)->buckets[bucket];
  std::memcpy(gstart, b.gstart_p.data(),
              b.gstart_p.size() * sizeof(int64_t));
  std::memcpy(pat, b.pat_p.data(), b.pat_p.size() * sizeof(int16_t));
  std::memcpy(vbits, b.vbits_p.data(), b.vbits_p.size());
  std::memcpy(meta, b.meta_p.data(), b.meta_p.size() * sizeof(int32_t));
}

void gt_batch_free(void* h) { delete (BatchSet*)h; }

void* gt_build_runs(const uint8_t* seq, int64_t L, int64_t n_sites,
                    const int64_t* site_start, const int64_t* site_end,
                    const int64_t* site_allele_off,
                    const int32_t* site_n_alleles, const int64_t* allele_off,
                    const int64_t* allele_len, const uint8_t* allele_blob,
                    int64_t region_start, int64_t region_end, int64_t k,
                    int64_t max_combos, int32_t* status) {
  GraphView g;
  g.seq = seq;
  g.L = L;
  g.allele_off = allele_off;
  g.allele_len = allele_len;
  g.allele_blob = allele_blob;
  g.sites.reserve(n_sites);
  for (int64_t i = 0; i < n_sites; ++i)
    g.sites.push_back(
        {site_start[i], site_end[i], site_allele_off[i], site_n_alleles[i]});
  RunSet* rs = build_runs_impl(g, region_start, region_end, k, max_combos);
  *status = rs->status;
  return rs;
}

int64_t gt_runs_count(void* h) {
  return (int64_t)((RunSet*)h)->runs.size();
}

int64_t gt_runs_codes_len(void* h) {
  int64_t n = 0;
  for (const auto& r : ((RunSet*)h)->runs) n += (int64_t)r.codes.size();
  return n;
}

int64_t gt_runs_valid_len(void* h) {
  int64_t n = 0;
  for (const auto& r : ((RunSet*)h)->runs) n += (int64_t)r.valid.size();
  return n;
}

void gt_runs_export(void* h, uint8_t* codes, uint8_t* valid,
                    int64_t* run_len, int32_t* cluster_idx,
                    int32_t* combo_idx) {
  RunSet* rs = (RunSet*)h;
  int64_t co = 0, vo = 0;
  for (size_t i = 0; i < rs->runs.size(); ++i) {
    const RunOut& r = rs->runs[i];
    std::memcpy(codes + co, r.codes.data(), r.codes.size());
    std::memcpy(valid + vo, r.valid.data(), r.valid.size());
    co += (int64_t)r.codes.size();
    vo += (int64_t)r.valid.size();
    run_len[i] = (int64_t)r.codes.size();
    cluster_idx[i] = r.cluster_idx;
    combo_idx[i] = r.combo_idx;
  }
}

void gt_runs_free(void* h) { delete (RunSet*)h; }

// ---------------------------------------------------------------------------
// Sequential tail sums
// ---------------------------------------------------------------------------

// out[i] = arr[starts[i]] + arr[starts[i]+1] + ... + arr[n-1], accumulated
// strictly left to right in double precision.
void seq_tail_sums(const double* arr, int64_t n, const int64_t* starts,
                   int64_t m, double* out) {
  for (int64_t i = 0; i < m; ++i) {
    double acc = 0.0;
    int64_t s = starts[i];
    if (s < 0) s = 0;
    for (int64_t j = s; j < n; ++j) acc += arr[j];
    out[i] = acc;
  }
}

// Parse one VCF sample block ("GT[:...]\tGT[:...]\t...") into allele
// indices per haplotype (2 per diploid sample; '.' -> 0, multi-digit
// alleles and extra FORMAT fields handled).  Returns the number of
// haplotype entries written, or -1 on malformed input.
int64_t vcf_parse_gt(const uint8_t* buf, int64_t len, int32_t* out,
                     int64_t out_cap) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len) {
    // one sample field: alleles separated by | or /, ended by ':' field
    // separator (rest of the field skipped) or '\t' / end
    while (true) {
      int32_t val = 0;
      bool any = false;
      if (i < len && buf[i] == '.') {
        val = 0;
        any = true;
        ++i;
      } else {
        while (i < len && buf[i] >= '0' && buf[i] <= '9') {
          val = val * 10 + (buf[i] - '0');
          ++i;
          any = true;
        }
      }
      if (!any) return -1;
      if (n >= out_cap) return -1;
      out[n++] = val;
      if (i >= len) return n;
      uint8_t c = buf[i];
      if (c == '|' || c == '/') {
        ++i;
        continue;
      }
      if (c == ':') {  // skip remaining FORMAT fields of this sample
        while (i < len && buf[i] != '\t') ++i;
      }
      if (i < len && buf[i] == '\t') ++i;
      break;
    }
  }
  return n;
}

}  // extern "C"
