"""Seconds a ``findmotif`` call spends writing the header-only report
triples of motifs with no row: the program's ``report_empty_s`` spans
(``workflows._find``, once for each such motif), read from a traced
run's trace.  Nothing to read untraced, or where the program opens no
such span (a program that stops at the first motif with no row)."""

WRAPS = None


def read(record):
    seconds = record.span_seconds("report_empty_s")
    return seconds / record.calls if seconds and record.calls else None
