"""Seconds a ``findmotif`` call spends reading and parsing the graph
file's zip members: the program's ``graph_inflate_s`` spans
(``graph/sitegraph.SiteGraph.load``'s member reads, the haplotype
bitsets that ``graph/haplo.HaploIndex.from_arrays`` reads among them),
read from a traced run's trace.  Nothing to read untraced, or where the
program opens no such span."""

WRAPS = None


def read(record):
    seconds = record.span_seconds("graph_inflate_s")
    return seconds / record.calls if seconds and record.calls else None
