"""The scan's kernels against their bound, in percent: the least time
the card could take over a call's scan work, over the device time of
every kernel inside the ``scan_s`` spans (``runscan.scan_batches``).

The bound is the larger of the reference's count of a call's position
scores (each window-strand-motif scoring sums ``k``) at the card's rate
of adding them (``trace.SCORE_ADDS_PER_S``), and the scanned graph
bases, 2 bits each and each once, at its memory rate.  The work is
counted from the inputs, so the bound is the same whatever implements
the scan.  Nothing to read in an untraced run or one whose trace shows
no kernel."""

from benchmark.trace import HBM_BYTES_PER_S, SCORE_ADDS_PER_S

WRAPS = None


def read(record):
    kernel_s = record.device_seconds_in("scan_s", cats=("kernel",))
    if not kernel_s:
        return None
    ops_s = record.work["adds"] / SCORE_ADDS_PER_S
    bytes_s = record.work["bases"] / 4 / HBM_BYTES_PER_S
    record.notes["scan_kernel_bound"] = "adds" if ops_s >= bytes_s else "bytes"
    return 100.0 * max(ops_s, bytes_s) * record.calls / kernel_s
