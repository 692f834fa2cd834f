"""Hit assembly for the run engine's report, in time proportional to the
hits.

The reference's run decomposition (``graph/runs.py``) rebuilds a
region's whole backbone ``Run`` to read five fields at a hit's offsets,
and ``ops/qvalue.py`` merges and expands a motif's histogram bins in
Python loops.  This module gives the same values from arrays:

* :func:`backbone_hits` -- a pure-reference backbone run's hit fields
  (``reconstruct_hits_batch`` of ``_build_backbone_run``) straight from
  the graph, in O(hits x k);
* :func:`qvalue_table` -- ``qvalues_from_histogram``'s float64 values
  from numpy, without its Python loops over bins.

Each is held to its counterpart, array for array, by
``tests/test_torch_assemble.py``.
"""

from typing import Tuple

import numpy as np

from grafimo_tpu_torch.graph.runs import _ref_node_array
from grafimo_tpu_torch.graph.sitegraph import SiteGraph


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
    is_ref = graph.node_is_ref[_ref_node_array(graph)[win]].all(axis=1)
    freqs = np.full(
        len(begins),
        graph.haplo.count([]) if graph.haplo is not None else 0,
        dtype=np.int64,
    )
    return begins, begins + k, seq_bytes, is_ref, freqs


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
