"""Seconds a ``findmotif`` call spends rebuilding flat arrays from the
loaded graph's ``Site`` objects for the C++ batcher: the program's
``graph_flatten_s`` span (``native._flatten_graph``), read from a traced
run's trace.  Nothing to read untraced, or where the program opens no
such span."""

WRAPS = None


def read(record):
    seconds = record.span_seconds("graph_flatten_s")
    return seconds / record.calls if seconds and record.calls else None
