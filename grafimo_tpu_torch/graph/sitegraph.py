"""Site-decomposed variation graph.

The framework's replacement for ``vg construct`` + ``vg index`` XG/GBWT
artifacts (reference ``constructVG.py:296-404``).  A VCF-derived variation
graph is a linear reference backbone with local *sites* (bubbles); this
structure stores exactly that:

* reference segments between variant sites — one node each;
* per site: the trimmed ref allele span and the alt allele sequences, with
  vg-compatible node numbering (alt allele nodes first, then the ref-allele
  node — observed from the reference's toy fixture node paths,
  ``tests/test_data/expected_results/expected_seqs.tsv``);
* deletions are edges that skip the ref-allele node (no alt node), pure
  insertions are alt nodes with an empty ref span — matching how ``vg
  construct`` models them (the chr22 fixture shows deletion walks labelled
  ``ref`` with span > k, reclassified downstream like the reference does at
  ``score_sequences.py:305-307``).

Node IDs are 1-based and assigned in genomic order.  The graph serialises to
a single ``.gvt`` npz file (arrays only, no pickle).

A format-2 file loads as its member arrays: ``sites``, ``segments``,
``elements`` and the haplotype index's per-site rows are sequences over
those arrays that build each item on first read and keep it, and the
whole-graph readers take the arrays themselves (:meth:`SiteGraph.site_spans`,
:meth:`SiteGraph.allele_table`, :meth:`SiteGraph.ref_path_tables`).  A
hit-bearing region reads a few percent of a chromosome's sites.  Every
other graph source (format-1 files, ``.xg``, ``.vg``, ``.gfa``, graphs
built in memory) holds plain lists.
"""

import json
import operator
from collections import abc
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from grafimo_tpu_torch.graph.haplo import HaploIndex
from grafimo_tpu_torch.io.vcf import VcfRecord
from grafimo_tpu_torch.spans import count, span


@dataclass
class Site:
    site_id: int
    ref_start: int  # 0-based, allele-trimmed
    ref_end: int  # 0-based exclusive; == ref_start for pure insertions
    alleles: List[str]  # index 0 = trimmed ref allele ("" for insertion)
    allele_nodes: List[int]  # node id per allele; 0 = no node (empty allele)


class _OnRead(abc.Sequence):
    """A list's reads over ``n`` items that are built by ``_make(i)`` on
    first read and kept, so an index always returns the same object:
    ``len``, indices (negative ones too), slices (as lists), iteration,
    and equality with a list or another such sequence.  Once every item
    is built, slices and iteration are the kept list's own."""

    def __init__(self, n: int):
        self._items = [None] * n
        self._missing = n

    def _make(self, i: int):
        raise NotImplementedError

    def _get(self, i: int):
        item = self._items[i]
        if item is None:
            item = self._items[i] = self._make(i)
            self._missing -= 1
        return item

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, idx):
        n = len(self._items)
        if isinstance(idx, slice):
            if self._missing:
                for i in range(*idx.indices(n)):
                    self._get(i)
            return self._items[idx]
        i = operator.index(idx)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("list index out of range")
        return self._get(i)

    def __iter__(self):
        if self._missing:
            return map(self._get, range(len(self._items)))
        return iter(self._items)

    def __eq__(self, other):
        if not isinstance(other, (list, _OnRead)):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other)
        )


class _MemberSites(_OnRead):
    """``Site(i, ...)`` from the members ``site_start``, ``site_end``,
    ``site_n_alleles``, ``allele_bounds``, ``allele_blob`` and
    ``allele_nodes``, as the eager load made it; each build counts as
    ``graph_objects.sites_built``."""

    def __init__(self, starts, ends, n_alleles, bounds, blob, nodes):
        super().__init__(len(n_alleles))
        self.starts, self.ends = starts, ends
        self.n_alleles, self.bounds, self.blob = n_alleles, bounds, blob
        self.nodes = nodes
        self._first = np.zeros(len(n_alleles) + 1, dtype=np.int64)
        np.cumsum(n_alleles, out=self._first[1:])
        self._text = bytes(blob).decode("ascii")

    def _make(self, i: int) -> Site:
        a, b = self._first[i : i + 2].tolist()
        cut = self.bounds[a : b + 1].tolist()
        text = self._text
        count("graph_objects.sites_built")
        return Site(
            i,
            int(self.starts[i]),
            int(self.ends[i]),
            [text[cut[j] : cut[j + 1]] for j in range(b - a)],
            self.nodes[a:b].tolist(),
        )


class _MemberSegments(_OnRead):
    """``(ref_start, ref_end, node_id)`` tuples from ``segments_tab``."""

    def __init__(self, tab):
        super().__init__(len(tab))
        self.tab = tab

    def _make(self, i: int) -> Tuple[int, int, int]:
        return tuple(self.tab[i].tolist())


class _MemberElements(_OnRead):
    """``("seg", node_id)`` / ``("site", site_id)`` from ``el_kind`` and
    ``el_id``."""

    def __init__(self, kinds, ids):
        super().__init__(len(kinds))
        self.kinds, self.ids = kinds, ids

    def _make(self, i: int) -> Tuple[str, int]:
        return ("seg" if self.kinds[i] == 0 else "site", int(self.ids[i]))


_HAPLO_MEMBERS = ("hap_n", "hap_nsites", "hap_map_site", "hap_map_allele",
                  "hap_map_row", "hap_alt_bits")


class _MemberRows(_OnRead):
    """``HaploIndex.site_allele_rows`` from ``hap_map_site`` (sorted,
    inside ``[0, n_sites)``), ``hap_map_allele`` and ``hap_map_row``: a
    site's ``{allele: row}`` in stored order, as ``from_arrays`` fills
    it."""

    def __init__(self, n_sites, sites, alleles, rows):
        super().__init__(n_sites)
        self.sites, self.alleles, self.rows = sites, alleles, rows

    @staticmethod
    def fits(n_sites, sites) -> bool:
        return len(sites) == 0 or bool(
            sites[0] >= 0 and sites[-1] < n_sites
            and (sites[1:] >= sites[:-1]).all()
        )

    def _make(self, i: int) -> dict:
        lo, hi = np.searchsorted(self.sites, [i, i + 1]).tolist()
        return dict(
            zip(self.alleles[lo:hi].tolist(), self.rows[lo:hi].tolist())
        )


@dataclass
class SiteGraph:
    chrom: str
    seq: str  # uppercase reference sequence
    sites: List[Site]
    # per-node arrays (1-based ids; index 0 unused)
    node_ref_start: np.ndarray  # int64: ref coord of node start / site start
    node_ref_end: np.ndarray  # int64: ref coord after node's ref span
    node_is_ref: np.ndarray  # bool: on the reference path
    node_seqs: List[str]  # node sequences (index 0 = "")
    # reference backbone segments: (ref_start, ref_end, node_id)
    segments: List[Tuple[int, int, int]]
    haplo: Optional[HaploIndex] = None
    # elements: genomic-order walk skeleton ("seg", node_id) | ("site", id)
    elements: List[Tuple[str, int]] = field(default_factory=list)

    @property
    def n_nodes(self) -> int:
        return len(self.node_seqs) - 1

    def ref_node_at(self, coord: int) -> int:
        """Reference-path node covering a ref coordinate (binary search
        over the segment/ref-allele partition of ``[0, len(seq))``)."""
        starts, nodes = self._ref_cover()
        i = int(np.searchsorted(starts, coord, side="right")) - 1
        return int(nodes[i]) if i >= 0 else 0

    def site_spans(self):
        """Cached ``(starts, ends)`` int64 arrays over the (sorted,
        non-overlapping) sites, for binary-search region queries: the
        stored ``site_start`` and ``site_end`` of a graph loaded from
        its members."""
        spans = getattr(self, "_site_spans_cache", None)
        if spans is None:
            if isinstance(self.sites, _MemberSites):
                spans = (
                    np.asarray(self.sites.starts, dtype=np.int64),
                    np.asarray(self.sites.ends, dtype=np.int64),
                )
            else:
                spans = (
                    np.array(
                        [s.ref_start for s in self.sites], dtype=np.int64
                    ),
                    np.array([s.ref_end for s in self.sites], dtype=np.int64),
                )
            self._site_spans_cache = spans
        return spans

    def allele_table(self):
        """``(site_n_alleles, allele_bounds, allele_blob)`` of a graph
        whose sites are its file's members: each site's allele count,
        the ``len + 1`` offsets of every allele in order into the ASCII
        bytes of all of them; None for any other graph."""
        sites = self.sites
        if isinstance(sites, _MemberSites):
            return sites.n_alleles, sites.bounds, sites.blob
        return None

    def ref_path_tables(self):
        """``(segments_tab, allele_nodes)`` of a graph whose segments and
        sites are its file's members: the ``(n, 3)`` int64 segment rows
        and every allele's node in order (a site's first allele is its
        reference allele); None for any other graph."""
        if isinstance(self.sites, _MemberSites) and isinstance(
            self.segments, _MemberSegments
        ):
            return self.segments.tab, self.sites.nodes
        return None

    def _ref_cover(self):
        cover = getattr(self, "_ref_cover_cache", None)
        if cover is None:
            spans = [(s, nid) for (s, _e, nid) in self.segments]
            spans += [
                (st.ref_start, st.allele_nodes[0])
                for st in self.sites
                if st.ref_end > st.ref_start
            ]
            spans.sort()
            cover = (
                np.array([s for s, _ in spans], dtype=np.int64),
                np.array([n for _, n in spans], dtype=np.int64),
            )
            self._ref_cover_cache = cover
        return cover

    @property
    def length(self) -> int:
        return len(self.seq)

    # -- serialisation -----------------------------------------------------
    def save(self, path: str) -> None:
        # v2 layout: site/element/segment tables as flat arrays — JSON
        # per-site dicts made chromosome-scale loads (1.7M sites) take
        # ~100 s of json + object churn; the array form loads in seconds
        meta = {"chrom": self.chrom, "format": 2}
        n_alleles = np.array(
            [len(s.alleles) for s in self.sites], dtype=np.int32
        )
        allele_strs: List[str] = []
        allele_nodes: List[int] = []
        for s in self.sites:
            allele_strs.extend(s.alleles)
            allele_nodes.extend(s.allele_nodes)
        bounds = np.zeros(len(allele_strs) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in allele_strs], out=bounds[1:])
        el_kind = np.array(
            [0 if kind == "seg" else 1 for kind, _ in self.elements],
            dtype=np.uint8,
        )
        el_id = np.array(
            [i for _, i in self.elements], dtype=np.int64
        )
        arrays = {
            "meta": np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8
            ),
            "seq": np.frombuffer(self.seq.encode("ascii"), dtype=np.uint8),
            "node_ref_start": self.node_ref_start,
            "node_ref_end": self.node_ref_end,
            "node_is_ref": self.node_is_ref,
            "node_seqs": np.frombuffer(
                "\n".join(self.node_seqs).encode("ascii"), dtype=np.uint8
            ),
            "site_start": np.array(
                [s.ref_start for s in self.sites], dtype=np.int64
            ),
            "site_end": np.array(
                [s.ref_end for s in self.sites], dtype=np.int64
            ),
            "site_n_alleles": n_alleles,
            "allele_blob": np.frombuffer(
                "".join(allele_strs).encode("ascii"), dtype=np.uint8
            ),
            "allele_bounds": bounds,
            "allele_nodes": np.array(allele_nodes, dtype=np.int64),
            "segments_tab": np.array(
                self.segments, dtype=np.int64
            ).reshape(len(self.segments), 3),
            "el_kind": el_kind,
            "el_id": el_id,
        }
        if self.haplo is not None:
            arrays.update(self.haplo.to_arrays())
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "SiteGraph":
        with np.load(path) as data:
            # numpy's NpzFile streams each member through zipfile in
            # 256KB chunks (~30 MB/s on the GB-scale haplotype bitsets
            # of a chromosome graph); reading the member wholesale and
            # parsing from memory is ~10x faster
            orig = data
            zf = getattr(data, "zip", None)

            class _Fast:
                def __getitem__(self, name):
                    with span("graph_inflate_s"):
                        if zf is not None:
                            import io as _io

                            raw = zf.read(name + ".npy")
                            return np.lib.format.read_array(
                                _io.BytesIO(raw), allow_pickle=False
                            )
                        return orig[name]

                def __contains__(self, name):
                    return name in orig

            data = _Fast()
            meta = json.loads(bytes(data["meta"]).decode("utf-8"))
            members = meta.get("format", 1) >= 2
            if members:
                # the member arrays, each item built where it is read
                sites = _MemberSites(
                    data["site_start"],
                    data["site_end"],
                    data["site_n_alleles"],
                    data["allele_bounds"],
                    data["allele_blob"],
                    data["allele_nodes"],
                )
                segments = _MemberSegments(data["segments_tab"])
                elements = _MemberElements(data["el_kind"], data["el_id"])
                count("graph_objects.member_graphs")
                count("graph_objects.sites_built", 0)
            else:  # v1: JSON meta (older .gvt files)
                sites = [
                    Site(i, d["s"], d["e"], d["a"], d["n"])
                    for i, d in enumerate(meta["sites"])
                ]
                segments = [tuple(s) for s in meta["segments"]]
                elements = [tuple(e) for e in meta["elements"]]
            haplo = None
            if "hap_n" in data:
                hap = {name: data[name] for name in _HAPLO_MEMBERS}
                n_sites = int(hap["hap_nsites"][0])
                site_of = hap["hap_map_site"]
                if members and _MemberRows.fits(n_sites, site_of):
                    rows = _MemberRows(n_sites, site_of,
                                       hap["hap_map_allele"],
                                       hap["hap_map_row"])
                    haplo = HaploIndex(int(hap["hap_n"][0]), rows,
                                       np.asarray(hap["hap_alt_bits"]))
                else:
                    haplo = HaploIndex.from_arrays(hap)
            return SiteGraph(
                chrom=meta["chrom"],
                seq=bytes(data["seq"]).decode("ascii"),
                sites=sites,
                node_ref_start=data["node_ref_start"],
                node_ref_end=data["node_ref_end"],
                node_is_ref=data["node_is_ref"],
                node_seqs=bytes(data["node_seqs"]).decode("ascii").split("\n"),
                segments=segments,
                haplo=haplo,
                elements=elements,
            )


# raw allele-combination cap for one overlap group; beyond it the group
# degrades to keep-first-record (warned)
MAX_OVERLAP_COMBOS = 4096


def _gt_to_bitsets(gt, n_hap: int) -> Optional[dict]:
    """Normalise one record's genotypes to ``{allele_idx: uint64 words}``
    over alt alleles (ref derivable as the complement); None = no data."""
    if gt is None or n_hap <= 0:
        return None
    words = (n_hap + 63) // 64
    if isinstance(gt, dict):
        out = {}
        for a, src in gt.items():
            row = np.zeros(words, dtype=np.uint64)
            src = np.asarray(src, dtype=np.uint64)
            n = min(words, src.size)
            row[:n] = src[:n]
            out[int(a)] = row
        return out
    arr = np.asarray(gt, dtype=np.int32)[:n_hap]
    out = {}
    for a in np.unique(arr[arr > 0]).tolist():
        by = np.packbits(arr == a, bitorder="little")
        row = np.zeros(words * 8, dtype=np.uint8)
        row[: len(by)] = by
        out[int(a)] = row.view(np.uint64)
    return out


def _full_words(n_hap: int) -> np.ndarray:
    words = (n_hap + 63) // 64
    full = np.full(words, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    rem = n_hap & 63
    if words and rem:
        full[-1] = (np.uint64(1) << np.uint64(rem)) - np.uint64(1)
    return full


def _splice(
    seq: str, S: int, E: int, chosen: List[Tuple[int, int, str]]
) -> str:
    """Substitute ``(start, end, alt)`` choices (disjoint, sorted) into
    ``seq[S:E]``."""
    parts = []
    cur = S
    for s, e, alt in chosen:
        parts.append(seq[cur:s])
        parts.append(alt)
        cur = e
    parts.append(seq[cur:E])
    return "".join(parts)


def _enumerate_combos(sizes: List[int]) -> List[Tuple[int, ...]]:
    """All index tuples with ``combo[i] < sizes[i]`` (last varies fastest,
    the shared contract with ``graph/runs._combinations``)."""
    combos: List[Tuple[int, ...]] = []
    cur = [0] * len(sizes)
    while True:
        combos.append(tuple(cur))
        i = len(sizes) - 1
        while i >= 0:
            cur[i] += 1
            if cur[i] < sizes[i]:
                break
            cur[i] = 0
            i -= 1
        if i < 0:
            break
    return combos


def _prune_composite_records(
    seq: str, recs: List[Tuple[int, str, List[str], object]]
) -> List[Tuple[int, str, List[str], object]]:
    """Drop records every alt of which is exactly a splice of a
    combination of the group's greedy-independent records.

    The GFA snarl flattener (graph/gfa.py) emits one record per
    anchor->reattachment path, so a CHAIN of adjacent bubbles (all-to-all
    linked allele nodes) yields composite path records spanning several
    bubbles on top of the per-bubble ones; merging those as if they were
    independent variants would double-count paths.  Genuinely nested
    variants (an alt not reproducible from the independent records) are
    kept for merging.
    """
    indep: List[Tuple[int, str, List[str], object]] = []
    rest: List[Tuple[int, str, List[str], object]] = []
    kept_end = -1
    for t in recs:
        if t[0] >= kept_end:
            indep.append(t)
            kept_end = max(kept_end, t[0] + len(t[1]))
        else:
            rest.append(t)
    out = list(indep)
    for t in rest:
        s, ref_t, alts_t, _gt = t
        e = s + len(ref_t)
        inner = [r for r in indep if r[0] >= s and r[0] + len(r[1]) <= e]
        n = 1
        for r in inner:
            n *= 1 + len(r[2])
        if n > MAX_OVERLAP_COMBOS:
            out.append(t)
            continue
        reachable = set()
        for combo in _enumerate_combos([1 + len(r[2]) for r in inner]):
            chosen = [
                (inner[i][0], inner[i][0] + len(inner[i][1]),
                 inner[i][2][a - 1])
                for i, a in enumerate(combo)
                if a != 0
            ]
            reachable.add(_splice(seq, s, e, chosen))
        if not all(a in reachable for a in alts_t):
            out.append(t)
    out.sort(key=lambda t: (t[0], t[0] + len(t[1])))
    return out


def _merge_overlap_group(
    seq: str,
    group: List[Tuple[int, str, List[str], object]],
    n_hap: int,
) -> Optional[Tuple[int, str, List[str], object]]:
    """Resolve a group of OVERLAPPING trimmed records into one merged site
    (the reference delegates this to ``vg construct -a``'s nested bubbles,
    ``constructVG.py:332``; here the nest is flattened into one site whose
    alleles enumerate the splicable allele combinations — the same
    path-enumeration approach as the GFA snarl flattener, graph/gfa.py).

    * a combination is *splicable* when its chosen non-ref records have
      pairwise-disjoint ref spans (same-point insertions concatenate in
      record order);
    * haplotypes carrying an unsplicable combination resolve greedily —
      records ordered by (start, longer span first), a non-ref choice is
      accepted only if disjoint from already-accepted ones (the outer
      bubble wins, matching a GBWT thread that walks the enclosing alt);
    * merged genotypes come out as ``{allele: uint64 bitset words}`` —
      the HaploIndex row layout.

    Returns ``(start0, merged_ref, merged_alts, merged_gt)`` or None when
    the group exceeds :data:`MAX_OVERLAP_COMBOS` (caller falls back to
    keep-first-record).
    """
    S = min(s for s, _r, _a, _g in group)
    E = max(s + len(r) for s, r, _a, _g in group)
    n_raw = 1
    for _s, _r, alts, _g in group:
        n_raw *= 1 + len(alts)
        if n_raw > MAX_OVERLAP_COMBOS:
            return None
    # greedy resolution order: by start, longer ref span first (outer
    # bubble wins), ties by input order
    res_order = sorted(
        range(len(group)),
        key=lambda i: (group[i][0], -len(group[i][1])),
    )

    def spans_conflict(si, sj):
        (s1, e1), (s2, e2) = si, sj
        if s1 > s2:
            (s1, e1), (s2, e2) = (s2, e2), (s1, e1)
        return s2 < e1

    def resolve(combo: Tuple[int, ...]) -> Tuple[int, ...]:
        accepted: List[Tuple[int, int]] = []
        out = [0] * len(combo)
        for i in res_order:
            if combo[i] == 0:
                continue
            s = group[i][0]
            e = s + len(group[i][1])
            if any(spans_conflict((s, e), sp) for sp in accepted):
                continue
            accepted.append((s, e))
            out[i] = combo[i]
        return tuple(out)

    def splice(combo: Tuple[int, ...]) -> str:
        chosen = [
            (group[i][0], group[i][0] + len(group[i][1]), group[i][2][a - 1])
            for i, a in enumerate(combo)
            if a != 0
        ]
        chosen.sort(key=lambda t: (t[0], t[1]))
        return _splice(seq, S, E, chosen)

    combos = _enumerate_combos([1 + len(alts) for _s, _r, alts, _g in group])
    # merged alt alleles: one per splicable non-ref combination
    allele_of: dict = {}
    merged_alts: List[str] = []
    for c in combos:
        if not any(c) or resolve(c) != c:
            continue
        allele_of[c] = 1 + len(merged_alts)
        merged_alts.append(splice(c))
    if not merged_alts:
        return None
    # merged genotypes: AND the per-record choice bitsets per raw combo,
    # routing unsplicable combos to their greedy resolution
    merged_gt: Optional[dict] = None
    if n_hap > 0:
        per_rec = [_gt_to_bitsets(g, n_hap) for _s, _r, _a, g in group]
        if any(b is not None for b in per_rec):
            full = _full_words(n_hap)
            zeros = np.zeros_like(full)
            refs = []
            for b in per_rec:
                anyalt = zeros.copy()
                if b:
                    for row in b.values():
                        anyalt |= row
                refs.append(full & ~anyalt)
            acc_gt: dict = {}
            for c in combos:
                if not any(c):
                    continue
                bits = full.copy()
                for i, a in enumerate(c):
                    if a == 0:
                        bits &= refs[i]
                    else:
                        row = (per_rec[i] or {}).get(a)
                        bits = bits & row if row is not None else zeros
                    if not bits.any():
                        break
                if not bits.any():
                    continue
                tgt = allele_of[resolve(c)]
                prev = acc_gt.get(tgt)
                acc_gt[tgt] = bits if prev is None else (prev | bits)
            merged_gt = acc_gt
    return S, seq[S:E], merged_alts, merged_gt


def _trim_record(rec: VcfRecord) -> Tuple[int, str, List[str]]:
    """Trim the common prefix shared by ref and ALL alts (the VCF anchor
    base); returns (0-based trimmed start, trimmed ref, trimmed alts)."""
    cp = 0
    seqs = [rec.ref] + rec.alts
    min_len = min(len(s) for s in seqs)
    while cp < min_len and len({s[cp] for s in seqs}) == 1:
        cp += 1
    # always keep at least one base of difference; for identical pairs the
    # record is degenerate and cp stops at min_len-?; clamp so ref'/alt'
    # are consistent
    start0 = rec.pos - 1 + cp
    return start0, rec.ref[cp:], [a[cp:] for a in rec.alts]


def build_graph(
    chrom: str,
    seq: str,
    records: List[VcfRecord],
    n_hap: Optional[int] = None,
    with_haplotypes: bool = True,
    prune_composite: bool = False,
) -> SiteGraph:
    """Build the site graph for one chromosome from its reference sequence
    and VCF records (replaces ``vg construct -R chrom -C -a`` + ``vg index
    -G .gbwt -v VCF``, reference ``constructVG.py:296-404``)."""
    seq = seq.upper()
    # normalise + sort; overlapping records merge into one flattened site
    # below (the reference delegates overlap resolution to vg construct
    # -a's nested bubbles, constructVG.py:332)
    trimmed = []
    for rec in records:
        if rec.chrom != chrom:
            continue
        start0, ref_t, alts_t = _trim_record(rec)
        if start0 + len(ref_t) > len(seq):
            continue
        if ref_t and seq[start0 : start0 + len(ref_t)] != ref_t:
            continue  # ref mismatch: skip record
        trimmed.append((start0, ref_t, alts_t, rec.gt))
    trimmed.sort(key=lambda t: (t[0], t[0] + len(t[1])))
    if n_hap is None:
        # bitset dicts carry no length — the native path supplies n_hap
        # explicitly (workflows.buildvg)
        n_hap = max(
            (
                len(g)
                for (_s, _r, _a, g) in trimmed
                if g is not None and not isinstance(g, dict)
            ),
            default=0,
        )

    # group records whose trimmed ref spans overlap (chained), merge each
    # group into one site enumerating the splicable allele combinations
    def regroup(ts):
        gs: List[List] = []
        for t in ts:
            if gs and t[0] < gs[-1][1]:
                gs[-1][0].append(t)
                gs[-1][1] = max(gs[-1][1], t[0] + len(t[1]))
            else:
                gs.append([[t], t[0] + len(t[1])])
        return gs

    groups = regroup(trimmed)
    if prune_composite and any(len(recs) > 1 for recs, _e in groups):
        # GFA-synthesised record streams carry composite path records
        # (one per snarl path) — drop the redundant ones before merging
        pruned: List = []
        for recs, _e in groups:
            pruned.extend(
                _prune_composite_records(seq, recs)
                if len(recs) > 1
                else recs
            )
        pruned.sort(key=lambda t: (t[0], t[0] + len(t[1])))
        groups = regroup(pruned)

    sites: List[Site] = []
    site_gts: List[Optional[np.ndarray]] = []

    def add_site(start0, ref_t, alts_t, gt):
        sites.append(
            Site(
                site_id=len(sites),
                ref_start=start0,
                ref_end=start0 + len(ref_t),
                alleles=[ref_t] + alts_t,
                allele_nodes=[0] * (1 + len(alts_t)),
            )
        )
        site_gts.append(
            gt
            if gt is None or isinstance(gt, dict)
            else np.asarray(gt, dtype=np.int32)
        )

    for recs, _group_end in groups:
        merged = (
            _merge_overlap_group(seq, recs, n_hap if with_haplotypes else 0)
            if len(recs) > 1
            else None
        )
        if len(recs) == 1:
            add_site(*recs[0])
        elif merged is not None:
            add_site(*merged)
        else:
            # combination cap exceeded: degrade to the old greedy
            # keep-non-overlapping behaviour, with a warning
            import sys

            sys.stderr.write(
                f"\033[33mWARNING: {len(recs)} overlapping VCF records "
                f"near {chrom}:{recs[0][0] + 1} exceed "
                f"{MAX_OVERLAP_COMBOS} combinations; keeping a "
                f"non-overlapping subset\033[0m\n"
            )
            kept_end = -1
            for start0, ref_t, alts_t, gt in recs:
                if start0 < kept_end:
                    continue
                add_site(start0, ref_t, alts_t, gt)
                kept_end = max(kept_end, start0 + len(ref_t))

    # assign nodes in genomic order: ref segment, then per site alt nodes
    # (VCF order) followed by the ref-allele node
    node_seqs: List[str] = [""]
    node_ref_start: List[int] = [0]
    node_ref_end: List[int] = [0]
    node_is_ref: List[bool] = [False]
    segments: List[Tuple[int, int, int]] = []
    elements: List[Tuple[str, int]] = []

    def add_node(s: str, rs: int, re_: int, is_ref: bool) -> int:
        node_seqs.append(s)
        node_ref_start.append(rs)
        node_ref_end.append(re_)
        node_is_ref.append(is_ref)
        return len(node_seqs) - 1

    pos = 0
    for site in sites:
        if site.ref_start > pos:
            nid = add_node(seq[pos : site.ref_start], pos, site.ref_start, True)
            segments.append((pos, site.ref_start, nid))
            elements.append(("seg", nid))
        # alt allele nodes first (vg numbering, toy fixture parity)
        for a_idx in range(1, len(site.alleles)):
            allele = site.alleles[a_idx]
            if allele:
                site.allele_nodes[a_idx] = add_node(
                    allele, site.ref_start, site.ref_end, False
                )
        if site.alleles[0]:
            site.allele_nodes[0] = add_node(
                site.alleles[0], site.ref_start, site.ref_end, True
            )
        elements.append(("site", site.site_id))
        pos = site.ref_end
    if pos < len(seq):
        nid = add_node(seq[pos:], pos, len(seq), True)
        segments.append((pos, len(seq), nid))
        elements.append(("seg", nid))

    haplo = None
    if with_haplotypes and n_hap:
        haplo = HaploIndex.from_genotypes(n_hap, site_gts)

    return SiteGraph(
        chrom=chrom,
        seq=seq,
        sites=sites,
        node_ref_start=np.array(node_ref_start, dtype=np.int64),
        node_ref_end=np.array(node_ref_end, dtype=np.int64),
        node_is_ref=np.array(node_is_ref, dtype=bool),
        node_seqs=node_seqs,
        segments=segments,
        haplo=haplo,
        elements=elements,
    )
