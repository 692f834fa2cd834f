"""Seconds a ``findmotif`` call spends on its motifs' p-value lookups
and score cutoffs: the program's ``pvalue_cutoffs_s`` spans
(``runscan.compute_results_runs``, once a width pass: each motif's
``PvalueLookup`` and the integer cutoff of ``p < threshold`` for each of
its columns), read from a traced run's trace.  Nothing to read
untraced, or where the program opens no such span."""

WRAPS = None


def read(record):
    seconds = record.span_seconds("pvalue_cutoffs_s")
    return seconds / record.calls if seconds and record.calls else None
