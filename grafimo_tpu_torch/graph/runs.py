"""Run-compressed window extraction.

The per-window pipeline (``graph/enumerate.py``) materialises every k-window
on the host and ships ~5 bytes/window to the device.  At TPU speeds the
host->device link, not compute, is the scan's bottleneck — so this module
reorganises extraction around **runs**: contiguous path sequences in which
every stride-1 offset is (potentially) a window.  The device expands windows
from runs itself (conv-style scan, ``ops/score_runs.py``); the wire carries
~0.3 bytes *per window* and the host never materialises windows at all —
only reconstructs the few hits that survive thresholding.

Decomposition (per region, per width k):

* variant **clusters**: maximal groups of sites separated by less than
  ``k + D + 1`` reference bases (``D`` = the cluster's total deletable
  span); by construction no k-window can touch two clusters;
* one run per (cluster, allele combination): the substituted sequence over
  the cluster plus ``k-1``-base reference flanks, with a validity mask
  selecting offsets whose windows (a) determine at least one site of the
  cluster, (b) determine every non-reference choice of the combination
  (canonical-assignment dedup: a window that does not reach site ``s`` is
  only valid in combinations where ``s`` is reference), and (c) fit the
  region bounds;
* one **backbone** run per region: the reference sequence, valid at
  offsets whose windows determine no site at all.

Together these partition the exact window set of the per-window enumerator
(differentially tested).  Frequencies, coordinates, node paths and ref
flags are reconstructed per *hit* from run metadata.

The per-graph arrays behind the clusters and the runs (site deletable
spans, the reference node of every base, a dense cluster's deletable
prefix) are built here, from the graph's member tables where a ``.gvt``
loaded them, else from whole-graph passes, and memoised on the graph by
the function that reads them.
"""

from dataclasses import dataclass
from itertools import chain
from operator import attrgetter, itemgetter
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from grafimo_tpu_torch.graph.sitegraph import Site, SiteGraph

MAX_COMBOS_PER_CLUSTER = 1 << 14
# (cluster_idx, combo_idx) hit identities ride int32 metadata; clusters
# whose full combination count cannot index in int32 take the per-window
# fallback instead
COMBO_IDX_MAX = (1 << 31) - 1


@dataclass
class Run:
    """One scannable path sequence with per-offset window validity."""

    seq: str
    valid: np.ndarray  # bool (len(seq)-k+1,)
    pos_begin: np.ndarray  # int64 (len,) begin coord per offset
    pos_end: np.ndarray  # int64 (len+1,) end coord after j consumed bases
    node_of_base: np.ndarray  # int32 (len,) node id per base
    # (site_id, allele_idx, determined-interval lo, hi) per cluster site
    site_info: List[Tuple[int, int, int, int]]
    region_start: int
    region_end: int
    # identity within the region's run decomposition: (cluster index,
    # combination index); (-1, 0) = backbone run.  Lets hits reference a
    # run without the Run object being materialised (C++ fast path).
    ref: Tuple[int, int] = (-1, 0)

    def __len__(self) -> int:
        return len(self.seq)

    def n_windows(self) -> int:
        return int(self.valid.sum())


@dataclass
class RunHit:
    begin: int
    end: int
    seq: str
    path: List[int]
    is_ref: bool
    freq: int


def _site_deletable(site: Site) -> int:
    span = site.ref_end - site.ref_start
    min_len = min(len(a) for a in site.alleles)
    return max(0, span - min_len)


def site_deletables(graph: SiteGraph) -> np.ndarray:
    """:func:`_site_deletable` of every site, as an int64 array cached on
    the graph; the allele lengths come from the graph's allele table
    where it has one."""
    arr = getattr(graph, "_site_deletable_arr", None)
    if arr is None:
        starts, ends = graph.site_spans()
        table = graph.allele_table()
        if table is not None:
            n_alleles, bounds, _blob = table
            lengths = np.diff(bounds)
        else:
            alleles = list(map(attrgetter("alleles"), graph.sites))
            n_alleles = np.fromiter(map(len, alleles), dtype=np.int64,
                                    count=len(alleles))
            lengths = np.fromiter(
                map(len, chain.from_iterable(alleles)), dtype=np.int64,
                count=int(n_alleles.sum()),
            )
        first = np.cumsum(n_alleles) - n_alleles
        shortest = (np.minimum.reduceat(lengths, first) if len(n_alleles)
                    else np.zeros(0, dtype=np.int64))
        arr = np.maximum(ends - starts - shortest, 0)
        graph._site_deletable_arr = arr
    return arr


def cluster_breaks(
    starts: np.ndarray, ends: np.ndarray, deletable: np.ndarray, k: int
) -> List[int]:
    """First-site indices of the clusters that the sites ``(starts, ends,
    deletable)`` chain into.

    Site ``i`` joins the open cluster when its gap to site ``i - 1`` is
    below ``k + d + 1``, ``d`` the deletable sum of the cluster so far.
    Since ``d >= 0``, only a gap of ``k + 1`` or more can break.  Up to
    the first candidate that would not break if its predecessor did,
    every candidate breaks (all of them where nothing is deletable, as
    on a SNP-only graph); from there the candidates are walked in order
    with the open cluster's deletable sum, until that sum exceeds every
    later candidate's room."""
    n = len(starts)
    if n == 0:
        return []
    gap = starts[1:] - ends[:-1]
    cand = np.flatnonzero(gap >= k + 1)
    room = gap[cand] - (k + 1)
    prefix = np.cumsum(deletable)  # prefix[i - 1] = deletable sum of [0, i)
    at = prefix[cand]  # site cand + 1: sum over [0, cand + 1)
    fails = np.flatnonzero(room < np.diff(at, prepend=0))
    j = int(fails[0]) if len(fails) else len(cand)
    breaks = [0] + (cand[:j] + 1).tolist()
    opened = int(at[j - 1]) if j else 0  # deletable sum before the open cluster
    later = np.maximum.accumulate(room[j:][::-1])[::-1]
    for site, r, p, most in zip(
        (cand[j:] + 1).tolist(), room[j:].tolist(), at[j:].tolist(),
        later.tolist(),
    ):
        d = p - opened
        if d > most:
            break
        if r >= d:
            breaks.append(site)
            opened = p
    return breaks


def _region_clusters(
    graph: SiteGraph, region_start: int, region_end: int, k: int
) -> Tuple[List[List[Site]], np.ndarray]:
    """:func:`cluster_sites`' clusters and the graph's site index at which
    each starts, with one past the last (int64), memoised on the graph
    per (unclipped region, k)."""
    memo = getattr(graph, "_cluster_cache", None)
    if memo is None:
        memo = graph._cluster_cache = {}
    key = (region_start, region_end, k)
    cached = memo.get(key)
    if cached is None:
        starts, ends = graph.site_spans()
        i0 = int(np.searchsorted(ends, region_start, side="left"))
        i1 = int(np.searchsorted(starts, region_end, side="right"))
        sites = graph.sites[i0:i1]
        bounds = cluster_breaks(
            starts[i0:i1], ends[i0:i1], site_deletables(graph)[i0:i1], k
        ) + [len(sites)]
        clusters = [sites[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        cached = memo[key] = (clusters, i0 + np.array(bounds, np.int64))
    return cached


def cluster_sites(
    graph: SiteGraph, region_start: int, region_end: int, k: int
) -> List[List[Site]]:
    """Group region-relevant sites into window-disjoint clusters: maximal
    chains in which each site starts less than ``k + d + 1`` bases after
    the previous one ends, ``d`` the deletable sum of the chain so far
    (:func:`cluster_breaks`).

    Memoised per (region, k) on the graph: lazy hit reconstruction calls
    this once per hit-containing run and chromosome-scale regions hold
    hundreds of thousands of sites.
    """
    return _region_clusters(graph, region_start, region_end, k)[0]


def _cluster_del_prefix(
    graph: SiteGraph, region_start: int, region_end: int, k: int, ci: int
) -> List[int]:
    """:func:`_del_prefix` of the region's cluster ``ci``, from
    :func:`site_deletables`, memoised per cluster: the chaining rule
    merges whole 1KGP chromosomes into one mega-cluster (330k sites at
    10 Mbp), where an O(cluster) recompute per hit costs ~200 ms a
    hit."""
    memo = getattr(graph, "_dense_delpref_cache", None)
    if memo is None:
        memo = graph._dense_delpref_cache = {}
    key = (region_start, region_end, k, ci)
    del_pref = memo.get(key)
    if del_pref is None:
        bounds = _region_clusters(graph, region_start, region_end, k)[1]
        a, b = bounds[ci : ci + 2]
        del_pref = memo[key] = (
            [0] + np.cumsum(site_deletables(graph)[a:b]).tolist()
        )
    return del_pref


def _combinations(cluster: Sequence[Site]) -> Iterator[List[int]]:
    """FULL mixed-radix combination enumeration (last site fastest).

    Test oracle only: production enumeration is
    :func:`candidate_combos`, which skips combinations that provably
    yield no valid window.  Kept because the differential test asserts
    both produce the same run set."""
    combo = [0] * len(cluster)
    while True:
        yield list(combo)
        i = len(cluster) - 1
        while i >= 0:
            combo[i] += 1
            if combo[i] < len(cluster[i].alleles):
                break
            combo[i] = 0
            i -= 1
        if i < 0:
            return


def candidate_combos(
    cluster: Sequence[Site], k: int
) -> List[Tuple[int, List[int]]]:
    """Combinations that can yield >= 1 valid window, as ``(combo_idx,
    combo)`` sorted by mixed-radix index.

    A window is valid in a combination only when it overlaps the
    determined interval of EVERY non-reference choice
    (``_build_cluster_run``'s canonical-assignment rule) — so only
    combinations whose non-reference sites share a common window can
    contribute, and every other site must be reference.  Enumerating
    non-ref supports by DFS with interval-intersection pruning makes
    cluster cost proportional to the (tiny) number of contributing
    combinations instead of ``prod(n_alleles)`` — a 17-SNP chain at
    1KGP densities is 2^17 full combinations but only ~dozens of
    candidates.  The full-enumeration oracle is differentially tested
    (``test_runs_differential.py``).

    Raises OverflowError when the FULL combination count does not fit
    the int32 combo-idx identity or the candidate count exceeds
    ``MAX_COMBOS_PER_CLUSTER`` (window-dense clusters) — callers take
    the exact per-window fallback.
    """
    n = len(cluster)
    weights = [1] * n
    w = 1
    for i in range(n - 1, -1, -1):
        weights[i] = w
        w *= len(cluster[i].alleles)
        if w > COMBO_IDX_MAX:
            raise OverflowError(
                f"cluster of {n} sites has {w}+ allele combinations"
            )
    flank_l = max(0, cluster[0].ref_start - (k - 1))
    # all-reference path offset of each site's allele region; ref alleles
    # span the site exactly, so prefix deltas come only from chosen alts
    base = [0] * n
    rd = 0
    for i, s in enumerate(cluster):
        base[i] = s.ref_start - flank_l + rd
        rd += len(s.alleles[0]) - (s.ref_end - s.ref_start)
    out: List[Tuple[int, List[int]]] = [(0, [0] * n)]

    def extend(start_i, ilo, ihi, delta, idx, combo):
        for i in range(start_i, n):
            s = cluster[i]
            lo = base[i] + delta - k + 1
            if lo > ihi:
                break  # later sites start even further right
            span_d = base[i] + delta  # allele region start in run coords
            for a in range(1, len(s.alleles)):
                alen = len(s.alleles[a])
                hi = span_d - 1 if alen == 0 else span_d + alen - 1
                nlo = max(ilo, lo)
                nhi = min(ihi, hi)
                if nlo > nhi:
                    continue
                combo[i] = a
                nidx = idx + a * weights[i]
                out.append((nidx, list(combo)))
                if len(out) > MAX_COMBOS_PER_CLUSTER:
                    raise OverflowError(
                        f"cluster of {n} sites exceeds "
                        f"{MAX_COMBOS_PER_CLUSTER} contributing "
                        "combinations"
                    )
                extend(
                    i + 1, nlo, nhi,
                    delta + alen - len(s.alleles[0]), nidx, combo,
                )
                combo[i] = 0

    big = 1 << 62
    extend(0, -big, big, 0, 0, [0] * n)
    out.sort(key=lambda t: t[0])
    return out


def _build_cluster_run(
    graph: SiteGraph,
    cluster: Sequence[Site],
    combo: List[int],
    region_start: int,
    region_end: int,
    k: int,
) -> Optional[Run]:
    """Materialise one (cluster, combination) run with metadata."""
    chrom_len = graph.length
    flank_l = max(0, cluster[0].ref_start - (k - 1))
    flank_r = min(chrom_len, cluster[-1].ref_end + (k - 1))

    # piecewise assembly (ref spans as whole slices — dense clusters
    # build hundreds of thousands of short runs, so per-base python and
    # per-base ref_node_at lookups are the cost to avoid)
    ref_nodes = _ref_node_array(graph)
    seq_parts: List[str] = []
    begin_parts: List[np.ndarray] = []
    end_parts: List[np.ndarray] = []
    node_parts: List[np.ndarray] = []
    site_info: List[Tuple[int, int, int, int]] = []
    length = 0

    def emit_ref(lo: int, hi: int) -> None:
        nonlocal length
        if hi <= lo:
            return
        seq_parts.append(graph.seq[lo:hi])
        coords = np.arange(lo, hi, dtype=np.int64)
        begin_parts.append(coords)
        end_parts.append(coords + 1)
        node_parts.append(ref_nodes[lo:hi].astype(np.int32, copy=False))
        length += hi - lo

    # left flank (pure reference by cluster separation)
    emit_ref(flank_l, cluster[0].ref_start)
    cursor = cluster[0].ref_start
    for site, a_idx in zip(cluster, combo):
        # intra-cluster reference gap
        emit_ref(cursor, site.ref_start)
        allele = site.alleles[a_idx]
        a_start = length  # path offset of the allele region
        if allele == "":
            # zero-length region: determined by windows crossing the
            # junction at path offset a_start
            site_info.append(
                (site.site_id, a_idx, a_start - k + 1, a_start - 1)
            )
        else:
            nid = site.allele_nodes[a_idx]
            alen = len(allele)
            seq_parts.append(allele)
            ob = np.minimum(
                site.ref_start + np.arange(alen, dtype=np.int64),
                site.ref_end,
            )
            oe = np.minimum(
                site.ref_start + np.arange(1, alen + 1, dtype=np.int64),
                site.ref_end,
            )
            oe[-1] = site.ref_end
            begin_parts.append(ob)
            end_parts.append(oe)
            node_parts.append(np.full(alen, nid, dtype=np.int32))
            length += alen
            site_info.append(
                (site.site_id, a_idx, a_start - k + 1, a_start + alen - 1)
            )
        cursor = site.ref_end
    # right flank
    emit_ref(cursor, flank_r)

    L = length
    if L < k:
        return None
    n_off = L - k + 1
    pos_begin_a = np.concatenate(begin_parts)
    pos_end_a = np.concatenate(
        [np.array([flank_l], dtype=np.int64)] + end_parts
    )
    node_of_base = np.concatenate(node_parts)
    offs = np.arange(n_off)
    # (b) canonical-assignment dedup + (a) determines >= 1 site
    any_det = np.zeros(n_off, dtype=bool)
    valid = np.ones(n_off, dtype=bool)
    for (sid, a_idx, lo, hi) in site_info:
        in_interval = (offs >= max(lo, 0)) & (offs <= min(hi, n_off - 1))
        any_det |= in_interval
        if a_idx != 0:
            valid &= in_interval
    valid &= any_det
    # (c) region bounds
    valid &= pos_begin_a[:n_off] >= region_start
    valid &= pos_end_a[k:] <= region_end
    if not valid.any():
        return None
    return Run(
        seq="".join(seq_parts),
        valid=valid,
        pos_begin=pos_begin_a,
        pos_end=pos_end_a,
        node_of_base=node_of_base,
        site_info=site_info,
        region_start=region_start,
        region_end=region_end,
    )


def _ref_node_array(graph: SiteGraph) -> np.ndarray:
    """Whole-chromosome reference-path node id per base (cached on the
    graph): the segment/ref-allele sweep of the backbone builder, built
    once instead of a binary search per emitted flank base.

    The pieces (segments, then each site's ref-allele node over its
    span) are painted in one ``np.repeat`` when they are disjoint and
    inside the chromosome, as a graph's segments and sites are;
    otherwise the sweep writes them in that order, later writes winning.
    A site whose ref allele has no node writes nothing, or, where the
    pieces are disjoint, the zeros it would leave.  The segments and each
    site's first allele node come from the graph's reference-path tables
    where it has them."""
    arr = getattr(graph, "_ref_node_arr", None)
    if arr is not None:
        return arr
    s_start, s_end = graph.site_spans()
    tables = graph.ref_path_tables()
    if tables is not None:
        seg, allele_nodes = tables
        n_alleles = graph.allele_table()[0]
        s_node = allele_nodes[np.cumsum(n_alleles) - n_alleles]
    else:
        seg = np.fromiter(
            chain.from_iterable(graph.segments), dtype=np.int64,
            count=3 * len(graph.segments),
        ).reshape(-1, 3)
        s_node = np.fromiter(
            map(itemgetter(0), map(attrgetter("allele_nodes"), graph.sites)),
            dtype=np.int64, count=len(graph.sites),
        )
    keep = s_end > s_start
    lo = np.concatenate([seg[:, 0], s_start[keep]])
    hi = np.concatenate([seg[:, 1], s_end[keep]])
    node = np.concatenate([seg[:, 2], s_node[keep]])
    filled = hi > lo
    lo, hi, node = lo[filled], hi[filled], node[filled]
    order = np.argsort(lo, kind="stable")
    lo, hi, node = lo[order], hi[order], node[order]
    L = graph.length
    if len(lo) and (lo[0] < 0 or hi.max() > L or (lo[1:] < hi[:-1]).any()):
        arr = np.zeros(L, dtype=np.int32)
        for s, e, nid in seg.tolist():
            arr[s:e] = nid
        for s, e, nid in zip(s_start[keep].tolist(), s_end[keep].tolist(),
                             s_node[keep].tolist()):
            if nid:
                arr[s:e] = nid
    else:
        # pieces alternate with the (possibly empty) gaps around them
        edges = np.empty(2 * len(lo) + 2, dtype=np.int64)
        edges[0], edges[-1] = 0, L
        edges[1:-1:2], edges[2:-1:2] = lo, hi
        values = np.zeros(2 * len(lo) + 1, dtype=np.int32)
        values[1::2] = node
        arr = np.repeat(values, np.diff(edges))
    graph._ref_node_arr = arr
    return arr


def _build_backbone_run(
    graph: SiteGraph,
    clusters: List[List[Site]],
    region_start: int,
    region_end: int,
    k: int,
) -> Optional[Run]:
    """Pure-reference windows that determine no site."""
    lo = max(0, region_start)
    hi = min(graph.length, region_end)
    L = hi - lo
    if L < k:
        return None
    n_off = L - k + 1
    # difference-array sweep over determined intervals: O(sites + L)
    # (offsets are begin coordinates lo + o)
    mark = np.zeros(n_off + 1, dtype=np.int32)
    for cl in clusters:
        for site in cl:
            if site.ref_end > site.ref_start:
                # window overlaps the site's ref span -> determined
                d_lo = site.ref_start - k + 1 - lo
                d_hi = site.ref_end - 1 - lo
            else:
                # insertion: determined when crossing the junction
                d_lo = site.ref_start - k + 1 - lo
                d_hi = site.ref_start - 1 - lo
            d_lo = max(d_lo, 0)
            d_hi = min(d_hi, n_off - 1)
            if d_lo <= d_hi:
                mark[d_lo] += 1
                mark[d_hi + 1] -= 1
    valid = np.cumsum(mark[:-1]) == 0
    if not valid.any():
        return None
    node_of_base = np.zeros(L, dtype=np.int32)
    for s, e, nid in graph.segments:
        a, b = max(s, lo), min(e, hi)
        if a < b:
            node_of_base[a - lo : b - lo] = nid
    for site in graph.sites:
        a, b = max(site.ref_start, lo), min(site.ref_end, hi)
        if a < b and site.allele_nodes[0]:
            node_of_base[a - lo : b - lo] = site.allele_nodes[0]
    coords = np.arange(lo, hi + 1, dtype=np.int64)
    return Run(
        seq=graph.seq[lo:hi],
        valid=valid,
        pos_begin=coords[:-1],
        pos_end=coords,
        node_of_base=node_of_base,
        site_info=[],
        region_start=region_start,
        region_end=region_end,
    )


def window_as_run(window, k: int) -> Run:
    """Wrap one enumerated window as a single-offset Run (the fallback
    representation for clusters whose combination count exceeds
    ``MAX_COMBOS_PER_CLUSTER``; the scan machinery then treats it like any
    other run)."""
    # node_of_base only needs to reproduce the walk's consecutive-distinct
    # node order; every walked node consumed >= 1 base so len(path) <= k
    nodes = np.empty(k, dtype=np.int32)
    nodes[: len(window.path)] = window.path
    nodes[len(window.path):] = window.path[-1]
    pos_end = np.zeros(k + 1, dtype=np.int64)
    pos_end[k] = window.end
    return Run(
        seq=window.seq,
        valid=np.ones(1, dtype=bool),
        pos_begin=np.array([window.begin], dtype=np.int64),
        pos_end=pos_end,
        node_of_base=nodes,
        site_info=[(sid, a, 0, 0) for sid, a in window.choices],
        region_start=0,
        region_end=window.end,
    )


def _fallback_cluster_windows(
    graph: SiteGraph,
    cluster: Sequence[Site],
    region_start: int,
    region_end: int,
    k: int,
):
    """Exact per-window enumeration of one over-dense cluster (every
    window determining >= 1 of its sites), as single-window Runs.

    SPEC/reference path: production takes :func:`dense_cluster_runs`
    (anchored short combination runs, differentially pinned to this
    enumeration by ``tests/test_dense_cluster_fallback.py``); this stays
    as the oracle and as the per-anchor escape hatch for ultra-dense
    spots."""
    from grafimo_tpu_torch.graph.enumerate import enumerate_region_windows

    d = sum(_site_deletable(s) for s in cluster)
    lo = max(region_start, cluster[0].ref_start - (k - 1) - d)
    hi = min(region_end, cluster[-1].ref_end + k - 1 + d)
    ids = {s.site_id for s in cluster}
    for w in enumerate_region_windows(graph, lo, hi, k):
        if not any(sid in ids for sid, _ in w.choices):
            continue
        if w.begin < region_start or w.end > region_end:
            continue
        yield window_as_run(w, k)


# per-anchor candidate cap for dense_cluster_runs: an anchor whose
# window-sharing combinations exceed this takes the exact per-window
# fallback for its own rows only (ultra-dense spots degrade locally)
DENSE_ANCHOR_COMBOS = 1 << 12
# native dense-row ref encoding (graphite.cpp dense_cluster_runs_native;
# constants MUST stay equal).  The anchor index is spread over BOTH
# int32 fields — the chaining rule's accumulated-deletable slack merges
# a whole 1KGP chromosome into one multi-million-site cluster:
#   ref = (-3 - (cluster_idx * DENSE_CLUSTER_MULT + anchor_block),
#          (anchor % DENSE_ANCHOR_BLOCK) * DENSE_COMBO_STRIDE + ordinal)
# with ordinal 0 the anchor's ownership-filtered all-ref row and 1 + x
# the x-th _anchored_combos entry — build_single_run decodes it for
# lazy hit reconstruction
DENSE_COMBO_STRIDE = DENSE_ANCHOR_COMBOS + 2
DENSE_ANCHOR_BLOCK = 1 << 18
DENSE_CLUSTER_MULT = 128


def _anchor_bounds(
    cluster: Sequence[Site], del_pref: Sequence[int], i: int, k: int
) -> Tuple[int, int]:
    """Anchor geometry of :func:`dense_cluster_runs`: ``(l, j)`` = left-
    context start and rightward window-sharing reach of anchor ``i``
    (``del_pref``: prefix sums of :func:`_site_deletable`)."""
    n = len(cluster)
    j = i
    while j + 1 < n:
        nx = cluster[j + 1]
        slack = del_pref[j + 1] - del_pref[i]
        if nx.ref_start - cluster[i].ref_end < k + slack:
            j += 1
        else:
            break
    l = i
    while l > 0 and cluster[l - 1].ref_end > (
        cluster[i].ref_start - k + 1
    ):
        l -= 1
    return l, j


def _del_prefix(cluster: Sequence[Site]) -> List[int]:
    del_pref = [0]
    for s in cluster:
        del_pref.append(del_pref[-1] + _site_deletable(s))
    return del_pref


def _apply_anchor_ownership(r0: Run, ctx: int) -> bool:
    """Restrict an anchor's all-ref row to the windows it OWNS: windows
    determined by the anchor site (``site_info[ctx]``) and by no earlier
    cluster site.  Returns whether any window survives."""
    n_off = len(r0.valid)
    offs = np.arange(n_off)
    _sid, _a, lo_i, hi_i = r0.site_info[ctx]
    own = (offs >= max(lo_i, 0)) & (offs <= min(hi_i, n_off - 1))
    for (_s2, _a2, lo_e, hi_e) in r0.site_info[:ctx]:
        own &= ~(
            (offs >= max(lo_e, 0))
            & (offs <= min(hi_e, n_off - 1))
        )
    r0.valid = r0.valid & own
    return bool(r0.valid.any())


def _anchored_combos(sub: Sequence[Site], k: int) -> List[List[int]]:
    """All allele combinations over ``sub`` whose support (non-ref
    sites) shares one window AND includes site 0 — the interval-pruned
    DFS of :func:`candidate_combos` rooted at a forced non-ref anchor.
    Raises OverflowError past ``DENSE_ANCHOR_COMBOS``."""
    n = len(sub)
    flank_l = max(0, sub[0].ref_start - (k - 1))
    base = [0] * n
    rd = 0
    for i, s in enumerate(sub):
        base[i] = s.ref_start - flank_l + rd
        rd += len(s.alleles[0]) - (s.ref_end - s.ref_start)
    out: List[List[int]] = []

    def extend(start_i, ilo, ihi, delta, combo):
        for i in range(start_i, n):
            s = sub[i]
            lo = base[i] + delta - k + 1
            if lo > ihi:
                break  # later sites start even further right
            span_d = base[i] + delta
            for a in range(1, len(s.alleles)):
                alen = len(s.alleles[a])
                hi = span_d - 1 if alen == 0 else span_d + alen - 1
                nlo = max(ilo, lo)
                nhi = min(ihi, hi)
                if nlo > nhi:
                    continue
                combo[i] = a
                out.append(list(combo))
                if len(out) > DENSE_ANCHOR_COMBOS:
                    raise OverflowError(
                        f"anchor exceeds {DENSE_ANCHOR_COMBOS} "
                        "window-sharing combinations"
                    )
                extend(
                    i + 1, nlo, nhi,
                    delta + alen - len(s.alleles[0]), combo,
                )
                combo[i] = 0

    s0 = sub[0]
    for a in range(1, len(s0.alleles)):
        alen = len(s0.alleles[a])
        hi0 = base[0] - 1 if alen == 0 else base[0] + alen - 1
        lo0 = base[0] - k + 1
        combo = [0] * n
        combo[0] = a
        out.append(list(combo))
        extend(1, lo0, hi0, alen - len(s0.alleles[0]), combo)
    return out


def _anchor_window_fallback(
    graph: SiteGraph,
    cluster: Sequence[Site],
    i: int,
    j: int,
    region_start: int,
    region_end: int,
    k: int,
):
    """Exact per-window rows of ONE anchor of an over-dense cluster:
    windows whose leftmost non-ref determined site is ``cluster[i]``."""
    from grafimo_tpu_torch.graph.enumerate import enumerate_region_windows

    d = sum(_site_deletable(s) for s in cluster[i : j + 1])
    lo = max(region_start, cluster[i].ref_start - (k - 1) - d)
    hi = min(region_end, cluster[j].ref_end + k - 1 + d)
    order = {s.site_id: idx for idx, s in enumerate(cluster)}
    for w in enumerate_region_windows(graph, lo, hi, k):
        nonref = [
            order[sid]
            for sid, a in w.choices
            if a != 0 and sid in order
        ]
        if not nonref or min(nonref) != i:
            continue
        if w.begin < region_start or w.end > region_end:
            continue
        yield window_as_run(w, k)


def dense_cluster_runs(
    graph: SiteGraph,
    cluster: Sequence[Site],
    region_start: int,
    region_end: int,
    k: int,
):
    """Run-compressed handling of an over-dense cluster (the
    combination cap of :func:`candidate_combos` tripped — MHC-class
    variant density chains thousands of sites into one cluster, whose
    whole-cluster combination runs would each span the entire chain).

    Anchored decomposition: every window row whose support (the set of
    sites it determines non-ref) is non-empty belongs to the anchor
    ``i = min(support)``.  Per anchor, the window-sharing combination
    DFS runs over only the sites reachable from ``i`` within one
    window (``sub``), with site ``i`` forced non-ref — and each
    combination builds a SHORT run through the standard
    :func:`_build_cluster_run` machinery, whose exact-support validity
    intervals make row ownership unique (a row with support S is valid
    only in anchor ``min(S)``'s combo with exactly S non-ref).  Cost is
    proportional to the contributing rows instead of the per-window
    path enumeration of :func:`_fallback_cluster_windows` (the previous
    fallback, now the differential oracle): a 1/10 bp 100 kb MHC-like
    pocket builds in seconds instead of tens of minutes.  Anchors whose
    own combination count exceeds ``DENSE_ANCHOR_COMBOS`` take the
    exact per-window oracle for their rows only.
    """
    n = len(cluster)
    del_pref = _del_prefix(cluster)
    for i in range(n):
        # rightward reach + left CONTEXT: earlier sites a window
        # determining site i can still overlap (at ref) — included in
        # the sub-run so that site_info carries their (ref)
        # determinations (the haplotype-frequency contract counts every
        # determined site, ref or not)
        l, j = _anchor_bounds(cluster, del_pref, i, k)
        ctx = i - l
        sub_full = list(cluster[l : j + 1])

        # all-ref rows anchored here: windows determining site i (at
        # ref) and NO earlier site — combo 0's rows in the
        # whole-cluster scheme, partitioned by leftmost determined site
        r0 = _build_cluster_run(
            graph, sub_full, [0] * len(sub_full), region_start,
            region_end, k,
        )
        if r0 is not None and _apply_anchor_ownership(r0, ctx):
            yield r0

        try:
            combos = _anchored_combos(cluster[i : j + 1], k)
        except OverflowError:
            yield from _anchor_window_fallback(
                graph, cluster, i, j, region_start, region_end, k
            )
            continue
        for combo in combos:
            r = _build_cluster_run(
                graph, sub_full, [0] * ctx + combo, region_start,
                region_end, k,
            )
            if r is not None:
                yield r


def region_runs(
    graph: SiteGraph, region_start: int, region_end: int, k: int
) -> List[Run]:
    """All runs for one region (backbone + cluster combinations; clusters
    beyond the combination cap fall back to exact per-window Runs)."""
    clusters = cluster_sites(graph, region_start, region_end, k)
    runs: List[Run] = []
    bb = _build_backbone_run(graph, clusters, region_start, region_end, k)
    if bb is not None:
        runs.append(bb)
    n_fallback = 0
    for c_idx, cluster in enumerate(clusters):
        try:
            for x_idx, combo in candidate_combos(cluster, k):
                r = _build_cluster_run(
                    graph, cluster, combo, region_start, region_end, k
                )
                if r is not None:
                    r.ref = (c_idx, x_idx)
                    runs.append(r)
        except OverflowError:
            for r in dense_cluster_runs(
                graph, cluster, region_start, region_end, k
            ):
                r.ref = (-2, n_fallback)
                n_fallback += 1
                runs.append(r)
    return runs


def nth_combination(cluster: Sequence[Site], idx: int) -> List[int]:
    """The ``idx``-th combination in :func:`_combinations` order (last
    site varies fastest) — the shared contract with the native engine."""
    combo = []
    for s in reversed(cluster):
        n = len(s.alleles)
        combo.append(idx % n)
        idx //= n
    return list(reversed(combo))


def build_single_run(
    graph: SiteGraph,
    region_start: int,
    region_end: int,
    k: int,
    ref: Tuple[int, int],
) -> Optional[Run]:
    """Materialise one run identified by ``(cluster_idx, combo_idx)`` —
    used to reconstruct hit metadata lazily when the scan payload came
    from the native engine."""
    clusters = cluster_sites(graph, region_start, region_end, k)
    c_idx, x_idx = ref
    if c_idx == -2:
        raise KeyError(
            "fallback window runs are only materialised eagerly (python "
            "extraction path); cannot rebuild lazily"
        )
    if c_idx <= -3:
        # native anchored dense-cluster row (graphite.cpp
        # dense_cluster_runs_native): decode (cluster, anchor, ordinal)
        # and rebuild through the python spec machinery
        ci, blk = divmod(-3 - c_idx, DENSE_CLUSTER_MULT)
        cluster = clusters[ci]
        a_rem, ordinal = divmod(x_idx, DENSE_COMBO_STRIDE)
        anchor = blk * DENSE_ANCHOR_BLOCK + a_rem
        del_pref = _cluster_del_prefix(
            graph, region_start, region_end, k, ci
        )
        l, j = _anchor_bounds(cluster, del_pref, anchor, k)
        ctx = anchor - l
        sub_full = list(cluster[l : j + 1])
        if ordinal == 0:
            run = _build_cluster_run(
                graph, sub_full, [0] * len(sub_full), region_start,
                region_end, k,
            )
            if run is not None and not _apply_anchor_ownership(run, ctx):
                run = None
        else:
            # native rows exist only for non-overflowed anchors, so the
            # enumeration cannot raise here
            combo = _anchored_combos(cluster[anchor : j + 1], k)[
                ordinal - 1
            ]
            run = _build_cluster_run(
                graph, sub_full, [0] * ctx + combo, region_start,
                region_end, k,
            )
        if run is not None:
            run.ref = ref
        return run
    if c_idx < 0:
        return _build_backbone_run(
            graph, clusters, region_start, region_end, k
        )
    combo = nth_combination(clusters[c_idx], x_idx)
    run = _build_cluster_run(
        graph, clusters[c_idx], combo, region_start, region_end, k
    )
    if run is not None:
        run.ref = ref
    return run


def reconstruct_hit(graph: SiteGraph, run: Run, offset: int, k: int) -> RunHit:
    """Rebuild full window metadata for one (run, offset) hit."""
    assert run.valid[offset]
    seq = run.seq[offset : offset + k]
    begin = int(run.pos_begin[offset])
    end = int(run.pos_end[offset + k])
    nodes = run.node_of_base[offset : offset + k]
    path: List[int] = []
    for n in nodes.tolist():
        if not path or path[-1] != n:
            path.append(n)
    choices = [
        (sid, a_idx)
        for (sid, a_idx, lo, hi) in run.site_info
        if lo <= offset <= hi
    ]
    is_ref = all(graph.node_is_ref[n] for n in path)
    freq = graph.haplo.count(choices) if graph.haplo is not None else 0
    return RunHit(
        begin=begin, end=end, seq=seq, path=path, is_ref=is_ref, freq=freq
    )


def reconstruct_hits_batch(
    graph: SiteGraph, run: Run, offsets: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised :func:`reconstruct_hit` for report assembly: the fields
    the report needs (no node paths), for MANY offsets of one run at once.
    Dense-hit scans (threshold ~ 1 / testmode, reference
    ``score_sequences.py:100-107``) reconstruct millions of windows — the
    per-hit python path would dominate wall time.

    Returns ``(begins (H,), ends (H,), seq_bytes (H, k) uint8 ASCII,
    is_ref (H,) bool, freqs (H,) int64)``.
    """
    offs = np.asarray(offsets, dtype=np.int64)
    begins = run.pos_begin[offs]
    ends = run.pos_end[offs + k]
    seq_b = np.frombuffer(run.seq.encode("ascii"), np.uint8)
    seq_bytes = seq_b[offs[:, None] + np.arange(k, dtype=np.int64)[None, :]]
    # is_ref == "no non-reference NODE in the window" (matches the
    # path-based test in reconstruct_hit: deletions contribute no node and
    # stay "ref"; reclassified downstream like the reference,
    # score_sequences.py:305-307)
    nonref = (~graph.node_is_ref[run.node_of_base]).astype(np.int64)
    cum = np.concatenate([np.zeros(1, np.int64), np.cumsum(nonref)])
    is_ref = (cum[offs + k] - cum[offs]) == 0
    freqs = np.zeros(len(offs), dtype=np.int64)
    if graph.haplo is not None:
        if not run.site_info:
            freqs[:] = graph.haplo.count([])
        else:
            # choices vary only with the offset's determined-interval
            # membership — a handful of distinct sets per run
            memo: dict = {}
            info = run.site_info
            for i, o in enumerate(offs.tolist()):
                key = tuple(
                    (sid, a) for (sid, a, lo, hi) in info if lo <= o <= hi
                )
                f = memo.get(key)
                if f is None:
                    f = graph.haplo.count(list(key))
                    memo[key] = f
                freqs[i] = f
    return begins, ends, seq_bytes, is_ref, freqs


def expand_all_windows(
    graph: SiteGraph, runs: List[Run], k: int
) -> List[RunHit]:
    """Materialise every valid window of every run (testing / slow path)."""
    out: List[RunHit] = []
    for run in runs:
        for o in np.nonzero(run.valid)[0].tolist():
            out.append(reconstruct_hit(graph, run, o, k))
    return out
