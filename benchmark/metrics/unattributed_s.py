"""Seconds of a ``findmotif`` call outside its seven layers: the
program's whole-call span ``findmotif_s`` (``workflows.findmotif``) less
the union of the layer spans inside it (``motif_processing_s``,
``graph_load_s``, ``batching_s``, ``scan_s``, ``hit_assembly_s``,
``statistics_s``, ``report_write_s``; the program's and the benchmark's
own, merged), read from a traced run's trace.  Nothing to read
untraced, or where the program opens no ``findmotif_s`` span."""

from benchmark.trace import overlap

WRAPS = None
LAYERS = ("motif_processing_s", "graph_load_s", "batching_s", "scan_s",
          "hit_assembly_s", "statistics_s", "report_write_s")


def read(record):
    calls = record.spans("findmotif_s")
    if not calls or not record.calls:
        return None
    layers = [iv for name in LAYERS for iv in record.spans(name)]
    outside = record.span_seconds("findmotif_s") - overlap(layers,
                                                           calls) / 1e6
    return outside / record.calls
