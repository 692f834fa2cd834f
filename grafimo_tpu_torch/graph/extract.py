"""Region extraction: graph -> WindowBatch tensors.

Copied from ``grafimo_tpu/graph/extract.py:24-132``: the original is
jax-free, but it imports ``grafimo_tpu.windows``, which imports jax
through ``grafimo_tpu/ops/__init__.py``.  The enumeration engine and the
graph are the port's copies (:mod:`grafimo_tpu_torch.graph.enumerate`,
:mod:`grafimo_tpu_torch.graph.sitegraph`).
``tests/test_torch_scan.py`` pins the copy to the original.

One change: :func:`extract_region` hands the enumerator a view of the
graph whose element list starts at the first element that can hold a
window start inside the region (:func:`_region_view`).  The enumerator
scans the elements from the chromosome's first for every region, about
1 us per element on a host core, so a peak set of 1,000 regions on a
10 Mbp chromosome spent minutes skipping elements.  The elements cut off
yield no window and are never reached by a walk (walks only go forward),
so the window stream is the original's, in its order.

Strand handling: the enumerator produces forward walks only.  Reverse rows
are derived (reverse-complement sequence, swapped coordinates, reversed
``-``-oriented node path), which matches the vg kmer-table convention.
"""

from typing import Iterable, List, Optional

import numpy as np

from grafimo_tpu_torch.graph.enumerate import Window, enumerate_region_windows
from grafimo_tpu_torch.graph.sitegraph import SiteGraph
from grafimo_tpu_torch.windows import WindowBatch

_RC_TABLE = str.maketrans("ACGTN", "TGCAN")


def revcomp(seq: str) -> str:
    return seq.translate(_RC_TABLE)[::-1]


def path_string(path: List[int], strand: str) -> str:
    """vg-style node path column: ``1+,3+,5+,`` (trailing comma); reverse
    rows list nodes in walk order of the reverse strand."""
    if strand == "+":
        return "".join(f"{n}+," for n in path)
    return "".join(f"{n}-," for n in reversed(path))


def windows_to_batch(
    windows: Iterable[Window],
    width: int,
    chrom_display: str,
    region_start: int,
    region_end: int,
    both_strands: bool = True,
) -> WindowBatch:
    """Materialise enumerator output as a WindowBatch with the reference's
    TSV row semantics (one forward and one reverse row per walk)."""
    region_name = f"{chrom_display}:{region_start}-{region_end}"
    seqnames: List[str] = []
    seqs: List[str] = []
    chroms: List[str] = []
    starts: List[int] = []
    stops: List[int] = []
    strands: List[str] = []
    freqs: List[int] = []
    refs: List[str] = []
    paths: List[str] = []
    for w in windows:
        ref_flag = "ref" if w.is_ref else "non.ref"
        seqnames.append(region_name)
        seqs.append(w.seq)
        chroms.append(chrom_display)
        starts.append(w.begin)
        stops.append(w.end)
        strands.append("+")
        freqs.append(w.freq)
        refs.append(ref_flag)
        paths.append(path_string(w.path, "+"))
        if both_strands:
            seqnames.append(region_name)
            seqs.append(revcomp(w.seq))
            chroms.append(chrom_display)
            starts.append(w.end)
            stops.append(w.begin)
            strands.append("-")
            freqs.append(w.freq)
            refs.append(ref_flag)
            paths.append(path_string(w.path, "-"))
    return WindowBatch(
        width=width,
        seqnames=seqnames,
        seqs=seqs,
        chroms=chroms,
        starts=np.array(starts, dtype=np.int64),
        stops=np.array(stops, dtype=np.int64),
        strands=strands,
        freqs=np.array(freqs, dtype=np.int64),
        refs=refs,
        paths=paths,
    )


class _GraphFrom:
    """``graph`` as :func:`enumerate_region_windows` reads it, with the
    elements before ``first`` cut off."""

    def __init__(self, graph: SiteGraph, first: int):
        self._graph = graph
        self.elements = graph.elements[first:]

    def __getattr__(self, name):
        return getattr(self._graph, name)


def _last_starts(graph: SiteGraph) -> np.ndarray:
    """Running maximum, over the elements in order, of the last reference
    coordinate at which the enumerator can start a window in an element
    (a segment node's last base; a site's ``ref_end``, which bounds its
    clamped allele coordinates).  Cached on the graph."""
    cached = getattr(graph, "_last_starts_cache", None)
    if cached is not None and len(cached) == len(graph.elements):
        return cached
    last = np.empty(len(graph.elements), dtype=np.int64)
    ref_end = graph.node_ref_end
    sites = graph.sites
    for ei, (kind, idx) in enumerate(graph.elements):
        last[ei] = ref_end[idx] - 1 if kind == "seg" else sites[idx].ref_end
    cached = np.maximum.accumulate(last) if len(last) else last
    graph._last_starts_cache = cached
    return cached


def _region_view(graph: SiteGraph, region_start: int):
    """The graph from the first element whose window starts can reach
    ``region_start``; every element before it starts windows only before
    the region, where the enumerator yields nothing."""
    first = int(np.searchsorted(_last_starts(graph), region_start,
                                side="left"))
    return _GraphFrom(graph, first) if first else graph


def extract_region(
    graph: SiteGraph,
    region_start: int,
    region_end: int,
    width: int,
    chrom_display: Optional[str] = None,
    both_strands: bool = True,
) -> WindowBatch:
    """Enumerate + batch one region (replaces one ``vg find`` call)."""
    windows = enumerate_region_windows(
        _region_view(graph, region_start), region_start, region_end, width
    )
    return windows_to_batch(
        windows,
        width,
        chrom_display if chrom_display is not None else graph.chrom,
        region_start,
        region_end,
        both_strands=both_strands,
    )


def write_windows_tsv(batch: WindowBatch, path: str) -> None:
    """Dump a batch in the reference's 7-column extraction TSV format (for
    interop/debugging; the pipeline itself stays in memory)."""
    with open(path, "w") as out:
        for i in range(len(batch)):
            out.write(
                "\t".join(
                    [
                        batch.seqnames[i],
                        batch.seqs[i],
                        f"{batch.chroms[i]}:{batch.starts[i]}{batch.strands[i]}",
                        f"{batch.chroms[i]}:{batch.stops[i]}{batch.strands[i]}",
                        str(int(batch.freqs[i])),
                        batch.refs[i],
                        batch.paths[i] if batch.paths else "",
                    ]
                )
                + "\n"
            )
