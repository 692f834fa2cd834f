"""Seconds a ``findmotif`` call spends in graph load outside the zip
member reads: the ``graph_load_s`` spans less the union of the
program's ``graph_inflate_s`` spans inside them, read from a traced
run's trace.  That is ``SiteGraph.load`` building Python objects from
the members' arrays (sites, segments, elements, sequence, nodes,
``HaploIndex.from_arrays``'s row map).  Nothing to read untraced, or
where the program opens no ``graph_inflate_s`` span."""

from benchmark.trace import overlap

WRAPS = None


def read(record):
    inflate = record.spans("graph_inflate_s")
    loads = record.spans("graph_load_s")
    if not inflate or not loads or not record.calls:
        return None
    inside = overlap(inflate, loads) / 1e6
    return (record.span_seconds("graph_load_s") - inside) / record.calls
