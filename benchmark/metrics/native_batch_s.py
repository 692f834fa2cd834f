"""Seconds a ``findmotif`` call spends in the C++ batch pipeline and the
reads of its buffers: the program's ``native_batch_s`` spans
(``native.batch_regions_native`` from ``gt_batch_regions`` on), read
from a traced run's trace.  Nothing to read untraced, or where the
program opens no such span."""

WRAPS = None


def read(record):
    seconds = record.span_seconds("native_batch_s")
    return seconds / record.calls if seconds and record.calls else None
