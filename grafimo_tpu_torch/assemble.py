"""Hit assembly for the run engine's report, in time proportional to the
hits.

The pinned copy of the reference's run decomposition
(``graph/runs.py``) rebuilds a region's whole backbone ``Run`` to read
five fields at a hit's offsets, groups a region's sites into clusters
with one Python pass over ``Site`` objects for every motif width, and
``ops/qvalue.py`` merges and expands a motif's histogram bins in Python
loops.  This module gives the same values from arrays:

* :func:`backbone_hits` -- a pure-reference backbone run's hit fields
  (``reconstruct_hits_batch`` of ``_build_backbone_run``) straight from
  the graph, in O(hits x k);
* :func:`region_clusters` -- ``cluster_sites``'s grouping from the
  site spans and a per-graph deletable array, put into the pinned memo
  so that ``build_single_run`` reads it from there; with it, the
  dense-cluster deletable prefix that ``build_single_run`` memoises and
  the whole-chromosome reference node array (:func:`prepare_run`);
* :func:`qvalue_table` -- ``qvalues_from_histogram``'s float64 values
  from numpy, without its Python loops over bins.

Each is held to its pinned counterpart, array for array, by
``tests/test_torch_assemble.py``.
"""

from itertools import chain
from operator import attrgetter, itemgetter
from typing import List, Tuple

import numpy as np

from grafimo_tpu_torch.graph.runs import DENSE_CLUSTER_MULT, _ref_node_array
from grafimo_tpu_torch.graph.sitegraph import Site, SiteGraph


def ref_node_array(graph: SiteGraph) -> np.ndarray:
    """The pinned ``_ref_node_array`` (the reference-path node of every
    base: segments, then each site's ref-allele node over its span),
    built from arrays and stored in its cache, ``graph._ref_node_arr``.
    The pieces are painted in one ``np.repeat`` when they are disjoint
    and inside the chromosome, as a graph's segments and sites are;
    otherwise the pinned sweep builds it."""
    arr = getattr(graph, "_ref_node_arr", None)
    if arr is not None:
        return arr
    seg = np.fromiter(
        chain.from_iterable(graph.segments), dtype=np.int64,
        count=3 * len(graph.segments),
    ).reshape(-1, 3)
    s_start, s_end = graph.site_spans()
    s_node = np.fromiter(
        map(itemgetter(0), map(attrgetter("allele_nodes"), graph.sites)),
        dtype=np.int64, count=len(graph.sites),
    )
    # a site whose ref allele has no node writes nothing, or, where the
    # pieces are disjoint, the zeros it would leave
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
        return _ref_node_array(graph)
    # pieces alternate with the (possibly empty) gaps around them
    edges = np.empty(2 * len(lo) + 2, dtype=np.int64)
    edges[0], edges[-1] = 0, L
    edges[1:-1:2], edges[2:-1:2] = lo, hi
    values = np.zeros(2 * len(lo) + 1, dtype=np.int32)
    values[1::2] = node
    arr = np.repeat(values, np.diff(edges))
    graph._ref_node_arr = arr
    return arr


def backbone_hits(
    graph: SiteGraph, region_start: int, offsets: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``reconstruct_hits_batch(graph, backbone, offsets, k)`` without the
    backbone run: offsets count from ``max(0, region_start)``, a window
    is the reference ``graph.seq[b : b + k]``, its ref flag tests the
    reference-path nodes under it (``_ref_node_array``, the sweep that
    ``_build_backbone_run`` makes over its region) and its frequency is
    that of the empty choice set.  Returns ``(begins, ends, seq_bytes
    (H, k) uint8 ASCII, is_ref, freqs)``."""
    begins = max(0, region_start) + np.asarray(offsets, dtype=np.int64)
    seq = graph.seq
    seq_bytes = np.frombuffer(
        "".join([seq[b : b + k] for b in begins.tolist()]).encode("ascii"),
        np.uint8,
    ).reshape(len(begins), k)
    win = begins[:, None] + np.arange(k, dtype=np.int64)[None, :]
    is_ref = graph.node_is_ref[ref_node_array(graph)[win]].all(axis=1)
    freqs = np.full(
        len(begins),
        graph.haplo.count([]) if graph.haplo is not None else 0,
        dtype=np.int64,
    )
    return begins, begins + k, seq_bytes, is_ref, freqs


def site_deletables(graph: SiteGraph) -> np.ndarray:
    """Per-site deletable span, ``max(0, span - shortest allele)`` (the
    pinned ``_site_deletable``), as an int64 array cached on the graph."""
    arr = getattr(graph, "_site_deletable_arr", None)
    if arr is None:
        starts, ends = graph.site_spans()
        alleles = list(map(attrgetter("alleles"), graph.sites))
        n_alleles = np.fromiter(map(len, alleles), dtype=np.int64,
                                count=len(alleles))
        lengths = np.fromiter(
            map(len, chain.from_iterable(alleles)), dtype=np.int64,
            count=int(n_alleles.sum()),
        )
        first = np.concatenate([[0], np.cumsum(n_alleles)[:-1]])
        shortest = (np.minimum.reduceat(lengths, first) if len(alleles)
                    else np.zeros(0, dtype=np.int64))
        arr = np.maximum(ends - starts - shortest, 0)
        graph._site_deletable_arr = arr
    return arr


def cluster_breaks(
    starts: np.ndarray, ends: np.ndarray, deletable: np.ndarray, k: int
) -> List[int]:
    """First-site indices of the clusters that ``cluster_sites`` chains
    the sites ``(starts, ends, deletable)`` into.

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


def region_clusters(
    graph: SiteGraph, region_start: int, region_end: int, k: int
) -> List[List[Site]]:
    """``cluster_sites(graph, region_start, region_end, k)``: the same
    ``Site`` objects in the same groups, computed from arrays and stored
    in the pinned memo (``graph._cluster_cache``, keyed by the unclipped
    region and ``k``), which is read first."""
    memo = getattr(graph, "_cluster_cache", None)
    if memo is None:
        memo = graph._cluster_cache = {}
    key = (region_start, region_end, k)
    cached = memo.get(key)
    if cached is not None:
        return cached
    starts, ends = graph.site_spans()
    i0 = int(np.searchsorted(ends, region_start, side="left"))
    i1 = int(np.searchsorted(starts, region_end, side="right"))
    sites = graph.sites[i0:i1]
    bounds = cluster_breaks(
        starts[i0:i1], ends[i0:i1], site_deletables(graph)[i0:i1], k
    ) + [len(sites)]
    clusters = [sites[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    memo[key] = clusters
    spans = getattr(graph, "_cluster_spans", None)
    if spans is None:
        spans = graph._cluster_spans = {}
    spans[key] = i0 + np.array(bounds, dtype=np.int64)
    return clusters


def prepare_run(
    graph: SiteGraph, region_start: int, region_end: int, k: int,
    ref: Tuple[int, int],
) -> None:
    """Fill the pinned caches that ``build_single_run(graph,
    region_start, region_end, k, ref)`` reads, from arrays: the region's
    clusters, the reference node array and, for a dense-anchored row
    (``ref[0] <= -3``), its cluster's deletable prefix
    (``graph._dense_delpref_cache``, the pinned ``_del_prefix``)."""
    region_clusters(graph, region_start, region_end, k)
    ref_node_array(graph)
    if ref[0] > -3:
        return
    ci = (-3 - ref[0]) // DENSE_CLUSTER_MULT
    memo = getattr(graph, "_dense_delpref_cache", None)
    if memo is None:
        memo = graph._dense_delpref_cache = {}
    spans = getattr(graph, "_cluster_spans", {}).get(
        (region_start, region_end, k))
    key = (region_start, region_end, k, ci)
    if key not in memo and spans is not None:
        # spans is None where the pinned cluster_sites filled the memo
        # first (the batcher's over-dense clusters): the pinned prefix
        a, b = spans[ci : ci + 2]
        memo[key] = [0] + np.cumsum(site_deletables(graph)[a:b]).tolist()


def qvalue_table(hist: np.ndarray, pvalue_of_score) -> Tuple[np.ndarray, np.ndarray]:
    """``qvalues_from_histogram`` as arrays: the occupied scores
    (ascending) and their exact BH q-values.

    Bins are walked by descending score (ascending p).  The pinned
    function first merges adjacent bins of equal float p into one tie
    block (zero-mass gaps give distinct scores one p) and gives the block
    ``p / (rank_last / n)``; here every bin gets ``p / (rank / n)``, and
    the reversed running minimum gives each bin of a block its last
    bin's value, which is the block's, computed by the same float64
    operations in the same order (``rank / n``, ``p / ecdf``, the
    reversed ``minimum.accumulate``, the clip at 1): a smaller rank
    never divides to a smaller quotient."""
    hist = np.asarray(hist)
    occupied = np.nonzero(hist)[0]
    if occupied.size == 0:
        return occupied.astype(np.int64), np.zeros(0, dtype=np.float64)
    scores_desc = occupied[::-1].astype(np.int64)
    counts_desc = hist[scores_desc].astype(np.int64)
    p_asc = np.asarray(pvalue_of_score(scores_desc), dtype=np.float64)
    rank = np.cumsum(counts_desc)
    ecdf = rank / float(int(rank[-1]))
    raw = p_asc / ecdf
    q_desc = np.minimum.accumulate(raw[::-1])[::-1]
    q_desc[q_desc > 1] = 1
    return scores_desc[::-1], q_desc[::-1]
