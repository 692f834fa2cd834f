"""Seconds a ``findmotif`` call spends building its motifs' exact
q-value tables from the scan's histograms: the program's
``qvalue_tables_s`` spans (``assemble.qvalue_table`` in
``runscan._build_reports``, once for each motif with a report row),
read from a traced run's trace.  Nothing to read untraced, or where the
program opens no such span."""

WRAPS = None


def read(record):
    seconds = record.span_seconds("qvalue_tables_s")
    return seconds / record.calls if seconds and record.calls else None
