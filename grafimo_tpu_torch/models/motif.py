"""Motif model.

A :class:`Motif` carries a DNA PWM through its processing stages:
probability matrix (with pseudocounts) -> log-odds matrix -> integer-scaled
score matrix in ``[0, RANGE]`` -> Staden score-distribution table.

Reference equivalents: ``src/grafimo/motif.py:18-483`` (Motif object),
``src/grafimo/motif_set.py:15-113`` (MotifSet).  Unlike the reference the
matrices here are plain ``numpy`` arrays in a fixed A,C,G,T row order so they
can be shipped to the device verbatim, and ``MotifSet`` carries no class-level
mutable state (the reference's shared-state hazard, ``motif_set.py:52-54``).
"""

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set

import numpy as np


@dataclass
class Motif:
    """A DNA motif and its processed scoring tensors.

    Attributes
    ----------
    motif_id, motif_name:
        identifier / alternative name (e.g. ``MA0139.1`` / ``CTCF``).
    counts:
        raw count matrix ``(4, width)`` float64 in A,C,G,T row order (may be
        probabilities for MEME input).
    probs:
        probability matrix after normalisation + pseudocount ``(4, width)``.
    bg:
        background distribution over A,C,G,T (processed, pseudo-normalised).
    score_matrix:
        integer-scaled log-odds matrix ``(4, width)`` int64, values in
        ``[0, RANGE]`` (reference ``motif_ops.py:1027-1113``).
    pval_table:
        Staden DP final row, float64 ``(RANGE*width+1,)``; ``pval_table[s:]``
        tail-sum over total gives the p-value of integer score ``s``
        (reference ``motif_processing.pyx:552-632``).
    scale, offset, min_score, max_score:
        integer scaling parameters; ``logodds = score/scale + width*offset``
        (reference ``score_sequences.py:393``).
    """

    motif_id: str
    motif_name: str
    counts: np.ndarray
    width: int
    alphabet: List[str] = field(default_factory=lambda: ["A", "C", "G", "T"])
    bg: Optional[Dict[str, float]] = None
    nsites: Optional[int] = None  # MEME only
    probs: Optional[np.ndarray] = None
    log_odds: Optional[np.ndarray] = None
    score_matrix: Optional[np.ndarray] = None
    pval_table: Optional[np.ndarray] = None
    scale: Optional[int] = None
    offset: Optional[np.double] = None
    min_score: Optional[int] = None
    max_score: Optional[int] = None

    @property
    def is_scaled(self) -> bool:
        return self.score_matrix is not None

    @property
    def bg_vector(self) -> np.ndarray:
        """Background probabilities as a float64 vector in A,C,G,T order."""
        assert self.bg is not None
        return np.array([self.bg[n] for n in "ACGT"], dtype=np.float64)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Motif({self.motif_id}/{self.motif_name}, w={self.width})"


class MotifSet:
    """An iterable collection of motifs (reference ``motif_set.py:15-113``)."""

    def __init__(self, motifs: Optional[List[Motif]] = None):
        self._motifs: List[Motif] = list(motifs) if motifs else []

    def add(self, motifs) -> None:
        if isinstance(motifs, Motif):
            motifs = [motifs]
        self._motifs.extend(motifs)

    @property
    def motifs(self) -> List[Motif]:
        return self._motifs

    @property
    def widths(self) -> Set[int]:
        """Distinct motif widths; drives one extraction pass per width
        (reference ``motif_set.py:97-102``, ``grafimo.py:176``)."""
        return {m.width for m in self._motifs}

    def by_width(self, width: int) -> List[Motif]:
        return [m for m in self._motifs if m.width == width]

    def __iter__(self) -> Iterator[Motif]:
        return iter(self._motifs)

    def __len__(self) -> int:
        return len(self._motifs)

    @property
    def size(self) -> int:
        return len(self._motifs)
