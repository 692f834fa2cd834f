"""What a traced run read, and the arithmetic that turns it into numbers.

The device-interval arithmetic is copied from
``tools/bench_torch_scan_profile.analyse``: a Chrome trace written by
``torch.profiler``, its complete (``"ph": "X"``) events, the device's
busy time as the union of kernel, copy and fill intervals.  The memory
rate is ``chip_smoke.py``'s, one H100 SXM's.

``SCORE_ADDS_PER_S`` is the most position scores one H100 SXM can add
into window sums a second, counted per instruction with the packings the
port's fused scan already uses: 132 SMs at 1.98 GHz, each clock 64 lanes
of ``IADD3`` on the integer pipe (two adds each) and 64 lanes of
``IMAD`` on the FMA pipe (one add each), which is all the four
schedulers issue; each add of a 32-bit word that holds two positions
(a pair-table entry) of two columns (16-bit halves), four position
scores an add.  So no way of summing that the kernel uses can read above
its bound.  ``chip_smoke.py``'s 16.75 T/s (one add a lane of the integer
pipe) is twelve times lower.
"""

import json

HBM_BYTES_PER_S = 3.35e12
SCORE_ADDS_PER_S = 132 * 1.98e9 * (64 * 2 + 64 * 1) * 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPAN = "findmotif_call"


def load_events(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def merged(intervals) -> list:
    """Sorted, disjoint union of ``(lo, hi)`` intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def overlap(intervals, windows) -> float:
    """Length of the union of ``intervals`` inside the union of
    ``windows``."""
    total, wins = 0.0, merged(windows)
    for lo, hi in merged(intervals):
        for a, b in wins:
            if b > lo and a < hi:
                total += min(hi, b) - max(lo, a)
    return total


class Record:
    """One run's window: its calls, the host seconds of each span summed
    over them, the trace's events (``None`` untraced) and the work the
    reference counts for one call."""

    def __init__(self, calls: int, host: dict, events, work: dict):
        self.calls = calls
        self.host = host
        self.events = events
        self.work = work
        self.notes = {}

    def per_call(self, span: str):
        """Host seconds a call spends in ``span``."""
        return self.host[span] / self.calls if self.calls else None

    def spans(self, name: str) -> list:
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.events or ()
                if e.get("name") == name
                and e.get("cat") == "user_annotation"]

    def device(self, cats=DEVICE_CATS) -> list:
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.events or ()
                if e.get("cat") in cats]

    def device_seconds_in(self, span: str, cats=DEVICE_CATS) -> float:
        """Seconds the device was busy inside ``span``'s intervals."""
        return overlap(self.device(cats), self.spans(span)) / 1e6

    def span_seconds(self, span: str) -> float:
        return sum(hi - lo for lo, hi in merged(self.spans(span))) / 1e6


def device_summary(events, layer_spans) -> dict:
    """``busy_s`` and ``window_s`` of the traced window (from the first
    call's start to the last call's end) and the breakdown: the device
    operations that took most time, and the longest idle gaps, each
    named by the innermost layer span the host was in."""
    calls = merged((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == CALL_SPAN
                   and e.get("cat") == "user_annotation")
    if not calls:
        return {}
    lo, hi = calls[0][0], calls[-1][1]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                  for e in dev)
    by_op = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] / 1e6
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation"
            and e.get("name") in set(layer_spans) | {CALL_SPAN}]
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            mid = (a + prev) / 2
            inside = [(s1 - s0, name) for s0, s1, name in host
                      if s0 <= mid < s1]
            gaps.append([min(inside)[1] if inside else "between calls",
                         (a - prev) / 1e6])
        prev = max(prev, b)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "breakdown": {
            "device_ops": sorted(([n, s] for n, s in by_op.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda x: -x[1])[:10],
        },
    }
