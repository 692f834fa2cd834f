"""The C++ batcher's flat view of a graph, built in whole-graph passes.

The pinned ``native._flatten_graph`` builds the eight arrays that
``gt_batch_regions`` and ``gt_build_runs`` read with a Python loop over
every ``Site`` and allele, a small numpy array per allele: most of the
host batching time of a peak-set scan.  :func:`flat_arrays` builds the
same arrays from the same ``Site`` objects with a handful of whole-graph
passes and puts them in the cache the pinned function reads first, so
that the batcher receives byte-identical inputs.  It serves every graph
source (``.gvt`` v1 and v2, ``.xg``, ``.vg``, ``.gfa``, graphs built in
memory) alike.  ``tests/test_torch_flatgraph.py`` holds it to the
pinned function, array for array.
"""

from itertools import chain
from operator import attrgetter

import numpy as np

from grafimo_tpu_torch import spans
from grafimo_tpu_torch.graph.sitegraph import SiteGraph
from grafimo_tpu_torch.native import _CODE_LUT


def _codes(text: str) -> np.ndarray:
    """``text``'s bases as 0-3 codes, anything else 4 (uint8)."""
    return _CODE_LUT[np.frombuffer(text.encode("ascii"), np.uint8)]


def _exclusive_cumsum(lengths: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], dtype=np.int64, out=out[1:])
    return out


def flat_arrays(graph: SiteGraph) -> dict:
    """``native._flatten_graph(graph)``'s dict (``seq``, ``site_start``,
    ``site_end``, ``site_aoff``, ``site_nall``, ``allele_off``,
    ``allele_len``, ``blob``), stored as ``graph._native_flat_cache``
    where the pinned function looks first; returned from there when it
    is already set.  Fills ``graph._site_spans_cache``
    (``SiteGraph.site_spans``) with the site spans too, where unset."""
    flat = getattr(graph, "_native_flat_cache", None)
    if flat is not None:
        return flat
    with spans.span("graph_flatten_s"):
        sites = graph.sites
        n = len(sites)
        site_start = np.fromiter(map(attrgetter("ref_start"), sites),
                                 dtype=np.int64, count=n)
        site_end = np.fromiter(map(attrgetter("ref_end"), sites),
                               dtype=np.int64, count=n)
        alleles = list(map(attrgetter("alleles"), sites))
        site_nall = np.fromiter(map(len, alleles), dtype=np.int32, count=n)
        every = list(chain.from_iterable(alleles))
        allele_len = np.fromiter(map(len, every), dtype=np.int64,
                                 count=len(every))
        flat = dict(
            seq=_codes(graph.seq),
            site_start=site_start,
            site_end=site_end,
            site_aoff=_exclusive_cumsum(site_nall),
            site_nall=site_nall,
            allele_off=_exclusive_cumsum(allele_len),
            allele_len=allele_len,
            blob=_codes("".join(every)),
        )
    spans.count("graph_flatten.graphs")
    graph._native_flat_cache = flat
    if getattr(graph, "_site_spans_cache", None) is None:
        graph._site_spans_cache = (site_start, site_end)
    return flat
