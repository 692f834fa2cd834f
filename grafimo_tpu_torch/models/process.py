"""PWM processing pipeline: counts -> probabilities -> log-odds -> integer
scaled score matrix.

This replaces the reference's Cython module (``motif_processing.pyx``) and
``motif_ops.py`` scaling with vectorised numpy float64 whose operation order
is bit-identical to the reference's scalar loops (see per-function notes);
that is what makes the golden scaled-matrix fixtures match exactly.
"""

from typing import Dict

import numpy as np

from grafimo_tpu_torch.errors import MotifProcessingError
from grafimo_tpu_torch.models.motif import Motif
from grafimo_tpu_torch.models.pvalue import staden_pval_table
from grafimo_tpu_torch.utils.constants import DNA_ALPHABET, RANGE
from grafimo_tpu_torch.utils.misc import almost_equal, lg2


def _bg_vec(bgs: Dict[str, float]) -> np.ndarray:
    return np.array([bgs[n] for n in DNA_ALPHABET], dtype=np.float64)


def norm_motif(probs: np.ndarray, width: int) -> np.ndarray:
    """Re-normalise columns whose sum drifts more than 1e-5 from 1
    (reference ``motif_ops.py:1307-1362``).

    The per-column total is accumulated A->T left-to-right like the
    reference's loop (summation order affects the float64 total).
    """
    probs = probs.astype(np.float64, copy=True)
    tolerance = 0.00001
    for j in range(width):
        tot = np.double(0)
        for i in range(4):
            tot += probs[i, j]
        assert tot != 0
        if not almost_equal(1, tot, tolerance):
            for i in range(4):
                probs[i, j] = np.double(probs[i, j] / tot)
    return probs


def apply_pseudocount_counts(
    counts: np.ndarray, probs: np.ndarray, pseudocount: float,
    bgs: Dict[str, float], width: int,
) -> np.ndarray:
    """Pseudocount for count-based formats (JASPAR/TRANSFAC/PFM)
    (reference ``pyx:192-309``).

    ``site_counts`` per column is the left-to-right float sum of the raw
    counts truncated to int, exactly like the reference's
    ``cdef int site_counts = sum(counts_matrix[:, j])``.
    """
    if counts.size == 0 or counts.sum() == 0:
        raise MotifProcessingError("motif counts matrix is empty")
    if pseudocount <= 0:
        raise MotifProcessingError("pseudocount must be > 0")
    proc = np.zeros(counts.shape, dtype=np.double)
    for j in range(width):
        sc = 0.0
        for i in range(4):
            sc = sc + counts[i, j]
        site_counts = int(sc)
        total_counts = np.double(site_counts) + pseudocount
        for i in range(4):
            bg = bgs[DNA_ALPHABET[i]]
            assert bg > 0
            count = (probs[i, j] * np.double(site_counts)) + (pseudocount * bg)
            proc[i, j] = count / total_counts
    assert proc.sum() != 0
    return proc


def apply_pseudocount_meme(
    probs: np.ndarray, pseudocount: float, site_counts: int,
    width: int, bgs: Dict[str, float],
) -> np.ndarray:
    """Pseudocount for probability-based (MEME) motifs
    (reference ``pyx:313-440``)."""
    if probs.size == 0 or probs.sum() == 0:
        raise MotifProcessingError("probability matrix is empty")
    if pseudocount <= 0 or site_counts <= 0 or width <= 0:
        raise MotifProcessingError("invalid pseudocount/site counts/width")
    proc = np.zeros(probs.shape, dtype=np.double)
    total_counts = np.double(site_counts) + pseudocount
    for j in range(width):
        for i in range(4):
            bg = bgs[DNA_ALPHABET[i]]
            assert bg > 0
            count = (probs[i, j] * site_counts) + (pseudocount * bg)
            proc[i, j] = count / total_counts
    return proc


def compute_log_odds(
    probs: np.ndarray, width: int, bgs: Dict[str, float]
) -> np.ndarray:
    """Elementwise ``lg2(p / bg)`` (reference ``pyx:444-548``)."""
    if probs.size == 0 or probs.sum() == 0:
        raise MotifProcessingError("motif probability matrix is empty")
    motif_log_odds = np.zeros(probs.shape, dtype=np.double)
    epsilon = 0.001
    tot_bg = 0.0
    tot_fg = 0.0
    for i in range(4):
        bg = bgs[DNA_ALPHABET[i]]
        assert bg > 0
        tot_bg += bg
        for j in range(width):
            prob = probs[i, j]
            assert prob > 0
            tot_fg += prob
            motif_log_odds[i, j] = lg2(prob / bg)
    assert tot_bg - 1.0 < epsilon
    assert tot_fg - width < epsilon
    return motif_log_odds


def scale_pwm(motif_matrix: np.ndarray, width: int):
    """Scale log-odds scores to integers in ``[0, RANGE]``
    (reference ``motif_ops.py:1027-1113``).

    ``lower`` is floored before the scale factor is derived, and every scaled
    value is ``np.round`` (half-to-even) of ``(x - offset) * scale_factor``.

    Returns ``(scaled int64 matrix, min, max, scale, offset)``.
    """
    if motif_matrix.size == 0 or motif_matrix.sum() == 0:
        raise MotifProcessingError("motif log-odds matrix is empty")
    min_val = motif_matrix.min()
    max_val = motif_matrix.max()
    lower = min_val
    upper = max_val
    if lower == upper:
        lower = np.double(upper - 1)
    lower = np.floor(lower)
    offset = np.round(np.floor(lower))
    scale_factor = np.floor(RANGE / (upper - lower))
    scaled = np.round((motif_matrix - offset) * scale_factor).astype(int)
    return scaled, int(scaled.min()), int(scaled.max()), int(scale_factor), offset


def process_motif(motif: Motif) -> Motif:
    """Full pipeline: log-odds, scaling and the Staden p-value table
    (reference ``motif_ops.py:971-1024``)."""
    assert motif.probs is not None and motif.bg is not None
    motif.log_odds = compute_log_odds(motif.probs, motif.width, motif.bg)
    scaled, min_val, max_val, scale, offset = scale_pwm(
        motif.log_odds, motif.width
    )
    motif.score_matrix = scaled
    motif.min_score = min_val
    motif.max_score = max_val
    motif.scale = scale
    motif.offset = offset
    motif.pval_table = staden_pval_table(
        scaled, motif.width, _bg_vec(motif.bg)
    )
    return motif
