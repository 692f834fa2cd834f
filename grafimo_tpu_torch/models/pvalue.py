"""Staden (1994) score-distribution DP and exact p-value machinery.

The DP computes, for a motif of width ``k`` with integer scaled scores in
``[0, RANGE]``, the background-weighted distribution of window scores over
``[0, RANGE*k]``.  The p-value of an integer score ``s`` is the tail mass
``table[s:].sum() / table.sum()``.

Reference: ``motif_processing.pyx:552-632`` (DP) and
``score_sequences.py:390-391`` (tail-sum p-value).

Bit-parity notes
----------------
* The reference's scalar DP adds contributions nucleotide-by-nucleotide in
  A,C,G,T order; within one nucleotide each destination bin receives exactly
  one contribution, so a vectorised shifted-add per nucleotide (in the same
  A,C,G,T order) performs the *identical* sequence of float64 additions per
  bin.
* The reference evaluates tail sums inside a numba ``nopython`` kernel whose
  ``.sum()`` reduces strictly left-to-right — NOT numpy's pairwise
  summation.  ``sequential_sum`` replicates that order (native C++ fast path
  in :mod:`grafimo_tpu.native`, pure-python fallback).
"""

from typing import Dict, Iterable

import numpy as np

from grafimo_tpu_torch.utils.constants import RANGE


def staden_pval_table(
    score_matrix: np.ndarray, width: int, bg: np.ndarray
) -> np.ndarray:
    """DP over motif positions; returns the final row, float64
    ``(RANGE*width+1,)`` (reference ``pyx:552-632``)."""
    assert score_matrix.shape == (4, width)
    size = RANGE * width + 1
    row = np.zeros(size, dtype=np.float64)
    # position 0: scalar adds in A,C,G,T order (two nucleotides may share a
    # scaled score and must accumulate in this order)
    for nuc in range(4):
        row[score_matrix[nuc, 0]] += np.double(1 * bg[nuc])
    for pos in range(1, width):
        new = np.zeros(size, dtype=np.float64)
        for nuc in range(4):
            s = int(score_matrix[nuc, pos])
            # prev bins idx can only be populated up to RANGE*pos, so
            # s + idx < size always holds
            new[s:] += row[: size - s] * bg[nuc]
        row = new
    return row


def sequential_sum(arr: np.ndarray, start: int = 0) -> float:
    """Strict left-to-right float64 sum of ``arr[start:]`` (numba ``.sum()``
    order, reference ``score_sequences.py:390-391``)."""
    try:
        from grafimo_tpu_torch.native import seq_tail_sums

        return float(
            seq_tail_sums(
                np.ascontiguousarray(arr, dtype=np.float64),
                np.array([start], dtype=np.int64),
            )[0]
        )
    except Exception:
        s = 0.0
        for v in arr[start:].tolist():
            s = s + v
        return s


def tail_sums(arr: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Left-to-right tail sums ``sum(arr[s:])`` for many start offsets."""
    starts = np.asarray(starts, dtype=np.int64)
    try:
        from grafimo_tpu_torch.native import seq_tail_sums

        return seq_tail_sums(
            np.ascontiguousarray(arr, dtype=np.float64), starts
        )
    except Exception:
        out = np.empty(len(starts), dtype=np.float64)
        lst = arr.tolist()
        n = len(lst)
        for i, s in enumerate(starts.tolist()):
            acc = 0.0
            for j in range(s, n):
                acc = acc + lst[j]
            out[i] = acc
        return out


class PvalueLookup:
    """Lazy exact p-value lookup for integer scores of one motif.

    p(s) = tail(s) / tot with reference summation order; results are cached
    per distinct score so a full genome scan only ever computes one tail sum
    per observed score bin.
    """

    def __init__(self, pval_table: np.ndarray):
        self.table = np.ascontiguousarray(pval_table, dtype=np.float64)
        self.tot = sequential_sum(self.table, 0)
        self._cache: Dict[int, float] = {}
        self._cutoffs: Dict[float, int] = {}

    def pvalues(self, scores: Iterable[int]) -> np.ndarray:
        """Vectorised p-values for an int array of scores."""
        scores = np.asarray(scores, dtype=np.int64)
        uniq = np.unique(scores)
        missing = [int(s) for s in uniq if int(s) not in self._cache]
        if missing:
            tails = tail_sums(self.table, np.array(missing, dtype=np.int64))
            for s, t in zip(missing, tails):
                self._cache[s] = float(t) / self.tot
        lut = {s: self._cache[int(s)] for s in uniq.tolist()}
        return np.array([lut[int(s)] for s in scores.tolist()], dtype=np.float64)

    def pvalue(self, score: int) -> float:
        return float(self.pvalues(np.array([score]))[0])

    def score_cutoff(self, threshold: float) -> int:
        """Smallest integer score whose p-value is < ``threshold``.

        p(s) is non-increasing in s, so ``score >= cutoff`` is exactly the
        device-side predicate for ``pvalue < threshold`` — an integer
        comparison the TPU can fuse into the scoring kernel.  Returns
        ``len(table)`` when no score passes.
        """
        cached = self._cutoffs.get(threshold)
        if cached is not None:
            return cached
        if self.pvalue(0) < threshold:
            result = 0
        elif self.pvalue(len(self.table) - 1) >= threshold:
            result = len(self.table)
        else:
            # binary search for the first s with p(s) < threshold
            lo, hi = 0, len(self.table) - 1
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if self.pvalue(mid) < threshold:
                    hi = mid
                else:
                    lo = mid
            result = hi
        self._cutoffs[threshold] = result
        return result
