"""Shared results-table assembly (reference ``ResultTmp.to_df``,
``resultsTmp.py:241-314``)."""

from typing import Dict, Optional

import numpy as np
import pandas as pd

from grafimo_tpu_torch.models.motif import Motif


def build_results_df(
    motif: Motif,
    seqnames,
    starts,
    stops,
    strands,
    scores_int: np.ndarray,
    pvalues: np.ndarray,
    seqs,
    freqs,
    refs,
    qvalues: Optional[np.ndarray] = None,
) -> pd.DataFrame:
    """Assemble the report DataFrame with the reference's exact column set
    and value conventions (log-odds de-scaling ``score_sequences.py:393``,
    indel ref reclassification ``score_sequences.py:305-307``)."""
    scores_int = np.asarray(scores_int, dtype=np.int64)
    logodds = (scores_int / motif.scale) + (motif.width * motif.offset)
    starts = np.asarray(starts, dtype=np.int64)
    stops = np.asarray(stops, dtype=np.int64)
    distance = np.abs(stops - starts)
    refs_fixed = [
        "non.ref" if (r == "ref" and d != motif.width) else r
        for r, d in zip(refs, distance.tolist())
    ]
    columns: Dict[str, object] = {
        "motif_id": [motif.motif_id] * len(scores_int),
        "motif_alt_id": [motif.motif_name] * len(scores_int),
        "sequence_name": list(seqnames),
        "start": starts,
        "stop": stops,
        "strand": list(strands),
        "score": logodds,
        "p-value": np.asarray(pvalues, dtype=np.float64),
    }
    if qvalues is not None:
        columns["q-value"] = np.asarray(qvalues, dtype=np.float64)
    columns["matched_sequence"] = list(seqs)
    columns["haplotype_frequency"] = np.asarray(freqs, dtype=np.int64)
    columns["reference"] = refs_fixed
    return pd.DataFrame(columns)


def apply_report_filters(
    df: pd.DataFrame, threshold: float, qval_t: bool, recomb: bool
) -> pd.DataFrame:
    """Threshold + recombinant filter + p-value sort
    (reference ``resultsTmp.py:302-313``)."""
    if qval_t:
        out = df[df["q-value"] < threshold]
    else:
        out = df[df["p-value"] < threshold]
    if not recomb:
        out = out[out["haplotype_frequency"] > 0]
    out = out.sort_values(["p-value"], ascending=True)
    return out.reset_index(drop=True)
