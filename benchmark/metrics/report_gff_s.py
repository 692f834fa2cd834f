"""Seconds a ``findmotif`` call spends writing its GFF3 reports: the
program's ``report_gff_s`` spans (``write_gff3`` in
``report/writer.write_results``), read from a traced run's trace.
Nothing to read untraced, or where the program opens no such span."""

WRAPS = None


def read(record):
    seconds = record.span_seconds("report_gff_s")
    return seconds / record.calls if seconds and record.calls else None
