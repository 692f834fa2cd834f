"""Scan orchestration of the per-window engine on one torch device: score
window batches, assign p/q-values, assemble the results table.

Counterpart of ``grafimo_tpu/scan.py:34-147``, with an explicit
``device``.  For each chunk of a batch: ``pack_codes`` on the host, one
host->device copy of the packed rows and flags, one launch of the fused
kernel that scores them and adds them to the motif's int64 histogram on
the device, the scores back to the host
(:func:`grafimo_tpu_torch.ops.score_windows.score_and_accumulate`).
Everything after that, from ``PvalueLookup`` to the p-value-sorted
DataFrame, is the reference's host code line for line, so rows reach the
non-stable sort in the reference's order.
"""

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import pandas as pd
import torch

from grafimo_tpu_torch import spans
from grafimo_tpu_torch.models.motif import Motif
from grafimo_tpu_torch.pvalues import PvalueLookup
from grafimo_tpu_torch.ops.qvalue import qvalues_from_histogram
from grafimo_tpu_torch.ops.score_windows import (
    hist_size_for_width,
    pwm_lut_from_flat,
    pwms_to_flat,
    score_and_accumulate,
)
from grafimo_tpu_torch.ops.score_runs import uploaded
from grafimo_tpu_torch.windows import WindowBatch

# device-batch granularity: windows are scored in chunks of this many rows
# (bounds device memory) -- the reference's CHUNK
CHUNK = 1 << 18


@dataclass
class ScanStats:
    seqs_scanned: int = 0
    nucs_scanned: int = 0
    scoring_time: float = 0.0


def compute_results(
    motif: Motif,
    batches: Iterable[WindowBatch],
    device: torch.device,
    threshold: float = 1e-4,
    no_qvalue: bool = False,
    qval_t: bool = False,
    no_reverse: bool = False,
    recomb: bool = False,
    stats: Optional[ScanStats] = None,
) -> pd.DataFrame:
    """Full scoring pass for one motif over a stream of window batches,
    scored on ``device``.

    Returns the thresholded, p-value-sorted results DataFrame with the
    reference's exact column set (``resultsTmp.py:241-314``).
    """
    if stats is None:
        stats = ScanStats()
    lut = pwm_lut_from_flat(pwms_to_flat([motif.score_matrix]), device)
    min_scores = uploaded(torch.tensor([motif.min_score], dtype=torch.int32,
                                       device=device))
    hist_size = hist_size_for_width(motif.width)
    # summed on the device by the scoring launches, read back once after
    # the last chunk
    hist_dev = torch.zeros((hist_size, 1), dtype=torch.int64, device=device)

    kept_batches = []
    kept_scores = []
    with spans.span("scan_s") as scoring:
        for batch in batches:
            if no_reverse:
                keep = np.array([s != "-" for s in batch.strands],
                                dtype=bool)
                if not keep.all():
                    batch = batch.select(keep)
            if len(batch) == 0:
                continue
            parts = []
            for lo in range(0, len(batch), CHUNK):
                hi = min(lo + CHUNK, len(batch))
                scores = score_and_accumulate(
                    batch.codes[lo:hi], lut, min_scores, hist_dev
                )
                parts.append(scores[:, 0].cpu().numpy().astype(np.int64))
            stats.seqs_scanned += len(batch)
            stats.nucs_scanned += len(batch) * motif.width
            kept_batches.append(batch)
            kept_scores.append(np.concatenate(parts))
    stats.scoring_time += scoring.seconds

    if not kept_batches:
        raise ValueError(
            "no result retrieved — are you using the correct variation "
            "graphs and searching on the right chromosomes?"
        )

    hist_total = hist_dev[:, 0].cpu().numpy()
    scores = np.concatenate(kept_scores)
    lookup = PvalueLookup(motif.pval_table)
    pvalues = lookup.pvalues(scores)
    # de-scale to log-odds (reference score_sequences.py:393)
    logodds = (scores / motif.scale) + (motif.width * motif.offset)

    columns = {
        "motif_id": [motif.motif_id] * len(scores),
        "motif_alt_id": [motif.motif_name] * len(scores),
        "sequence_name": [s for b in kept_batches for s in b.seqnames],
        "start": np.concatenate([b.starts for b in kept_batches]),
        "stop": np.concatenate([b.stops for b in kept_batches]),
        "strand": [s for b in kept_batches for s in b.strands],
        "score": logodds,
        "p-value": pvalues,
    }
    if not no_qvalue:
        qmap = qvalues_from_histogram(
            hist_total, lambda s: lookup.pvalues(s)
        )
        columns["q-value"] = np.array(
            [qmap[int(s)] for s in scores], dtype=np.float64
        )
    columns["matched_sequence"] = [s for b in kept_batches for s in b.seqs]
    freqs = np.concatenate([b.freqs for b in kept_batches])
    columns["haplotype_frequency"] = freqs
    # indel reference fix (reference score_sequences.py:305-307)
    starts = columns["start"]
    stops = columns["stop"]
    distance = np.abs(stops - starts)
    refs = [
        "non.ref" if (r == "ref" and d != motif.width) else r
        for r, d in zip(
            (s for b in kept_batches for s in b.refs), distance.tolist()
        )
    ]
    columns["reference"] = refs

    df = pd.DataFrame(columns)
    # threshold on p- or q-values (reference resultsTmp.py:302-307)
    if qval_t:
        df_thresh = df[df["q-value"] < threshold]
    else:
        df_thresh = df[df["p-value"] < threshold]
    # drop unobserved recombinants (reference resultsTmp.py:308-310)
    if not recomb:
        df_thresh = df_thresh[df_thresh["haplotype_frequency"] > 0]
    df_thresh = df_thresh.sort_values(["p-value"], ascending=True)
    df_thresh = df_thresh.reset_index(drop=True)
    return df_thresh
