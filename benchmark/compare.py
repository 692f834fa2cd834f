"""The comparison that decides ``correct``: the reports that the timed
calls wrote, held against the plain reference's rows.

Each distinct report (by its bytes) is judged in full.  The numbers,
each held to the configuration's limit:

* ``hits_differing``: report rows missing from the reference's plus
  reference rows missing from the report, a row being its motif, region,
  coordinates, strand and matched sequence;
* ``fields_differing``: matched rows whose motif name, score, haplotype
  frequency or reference flag differ;
* ``pvalue_rel_err`` and ``qvalue_rel_err``: the largest relative gap of
  a matched row's p-value and q-value;
* ``windows_differing``: the gap between the windows each call says it
  scanned (``Scanned sequences``, both strands, a line per width) and
  the reference's count;
* ``report_format_errors``: reports whose TSV header, row index or
  p-value order is not the writer's.
"""

import hashlib
import io
import os
import re
from collections import Counter

import numpy as np
import pandas as pd

COLUMNS = ["motif_id", "motif_alt_id", "sequence_name", "start", "stop",
           "strand", "score", "p-value", "q-value", "matched_sequence",
           "haplotype_frequency", "reference"]
KEY = ["motif_id", "sequence_name", "start", "stop", "strand",
       "matched_sequence"]
EXACT = ["motif_alt_id", "score", "haplotype_frequency", "reference"]
SCANNED = re.compile(r"^Scanned sequences:\t(\d+)$", re.M)


def report_files(outdir: str, motif_ids) -> dict:
    """``{motif_id: TSV path}`` as the report writer names them: one
    ``grafimo_out.tsv`` for one motif, ``grafimo_out_<id>.tsv`` each for
    more."""
    if len(motif_ids) == 1:
        return {motif_ids[0]: os.path.join(outdir, "grafimo_out.tsv")}
    return {m: os.path.join(outdir, f"grafimo_out_{m}.tsv")
            for m in motif_ids}


def _judge_one(blob: bytes, want: dict, numbers: dict) -> None:
    """Fold one report's gaps from the reference rows ``want`` (columns)
    into ``numbers``."""
    text = blob.decode()
    if not text.startswith("\t" + "\t".join(COLUMNS) + "\n"):
        numbers["report_format_errors"] += 1
        return
    got = pd.read_csv(io.StringIO(text), sep="\t", index_col=0,
                      float_precision="round_trip",
                      dtype={"sequence_name": str, "motif_id": str,
                             "motif_alt_id": str})
    if (list(got.index) != list(range(len(got)))
            or (np.diff(got["p-value"].to_numpy()) < 0).any()):
        numbers["report_format_errors"] += 1
    ref = pd.DataFrame(want, columns=COLUMNS)
    keys_got = Counter(map(tuple, got[KEY].astype(str).to_numpy()))
    keys_ref = Counter(map(tuple, ref[KEY].astype(str).to_numpy()))
    numbers["hits_differing"] += sum(((keys_got - keys_ref)
                                      + (keys_ref - keys_got)).values())
    both = got.merge(ref.astype({c: got[c].dtype for c in KEY}), on=KEY,
                     suffixes=("", "_ref"))
    if len(both) == 0:
        return
    diff = np.zeros(len(both), bool)
    for c in EXACT:
        diff |= both[c].to_numpy() != both[c + "_ref"].to_numpy()
    numbers["fields_differing"] += int(diff.sum())
    for c, name in (("p-value", "pvalue_rel_err"),
                    ("q-value", "qvalue_rel_err")):
        a = both[c].to_numpy(np.float64)
        b = both[c + "_ref"].to_numpy(np.float64)
        rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float64).tiny)
        numbers[name] = max(numbers[name], float(rel.max()))


def judge(calls, want_rows: dict, windows_per_strand: dict) -> dict:
    """The compared numbers over every call: ``calls`` is a list of
    ``(outdir, stdout)`` of calls that exited 0."""
    numbers = {"hits_differing": 0, "fields_differing": 0,
               "pvalue_rel_err": 0.0, "qvalue_rel_err": 0.0,
               "windows_differing": 0, "report_format_errors": 0}
    want_scanned = [2 * windows_per_strand[k]
                    for k in sorted(windows_per_strand)]
    seen = set()
    for outdir, stdout in calls:
        scanned = [int(x) for x in SCANNED.findall(stdout)]
        if len(scanned) != len(want_scanned):
            numbers["windows_differing"] += sum(want_scanned) + 1
        else:
            numbers["windows_differing"] += sum(
                abs(a - b) for a, b in zip(scanned, want_scanned))
        for mid, path in report_files(outdir, list(want_rows)).items():
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                numbers["hits_differing"] += len(want_rows[mid]["start"])
                numbers["report_format_errors"] += 1
                continue
            digest = (mid, hashlib.sha256(blob).hexdigest())
            if digest not in seen:
                seen.add(digest)
                _judge_one(blob, want_rows[mid], numbers)
    return numbers


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[name] <= limits[name] for name in numbers)
