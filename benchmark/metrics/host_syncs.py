"""Reads from the card that a ``findmotif`` call waits for: the
program's ``runscan.READS`` counts of the call (flush blocks, hit
indices, hit bits, histograms), read from the record of the window's
last call (``grafimo_tpu_torch.spans.last_call``); every call of a cell
does the same work.  Nothing to read where the program keeps no such
record."""

WRAPS = None
READS = ("reads.flush", "reads.indices", "reads.bits", "reads.hist")


def read(record):
    try:
        from grafimo_tpu_torch.spans import last_call
    except ImportError:
        return None
    last = last_call()
    if last is None or not all(k in last["counts"] for k in READS):
        return None
    return sum(last["counts"][k] for k in READS)
