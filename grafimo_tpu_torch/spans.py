"""Phase spans and counters of one workflow call.

A workflow (``findmotif``, ``buildvg``) runs inside :func:`call`, which
starts a fresh record and is itself the whole call's span.  Inside it,
:func:`span` adds the host seconds of a named phase to the record and
:func:`count` adds to a named counter.  While a ``torch.profiler`` is
recording (``--profile DIR``, the benchmark's traced runs), a span also
opens a ``record_function`` of its name, so the phase shows in the trace;
otherwise it costs two clock reads and a dict update.  Spans mark phases,
never regions, runs, rows or hits: a call opens a few dozen.

The launch and read counters kept as module dicts (``ops/*.COUNTS``,
``runscan.READS``) are registered with :func:`register`: a call's
increments of them appear in its record as ``<prefix>.<key>``.

Only the running call and the last finished one are kept, so nothing
grows with the number of calls.  :func:`last_call` returns the latter.
"""

import contextlib
import time
from typing import Dict, Optional

import torch

_registered: Dict[str, Dict[str, int]] = {}
_current: Optional["_Record"] = None
_last: Optional[dict] = None


class _Record:
    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.base = {p: dict(d) for p, d in _registered.items()}

    def finish(self) -> dict:
        counts = dict(self.counts)
        for prefix, live in _registered.items():
            base = self.base.get(prefix, {})
            for key, now in live.items():
                before = base.get(key, 0)
                # a reset inside the call leaves only what came after it
                counts[f"{prefix}.{key}"] = now - before if now >= before \
                    else now
        return {"spans": dict(self.spans), "counts": counts}


class span(contextlib.ContextDecorator):
    """One phase under ``name``: a ``with`` block or a function
    decorator.  After a ``with`` block, ``seconds`` holds its host
    seconds, for a log line that reports them."""

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._rf = None
        self._t0 = 0.0

    def _recreate_cm(self):
        return span(self.name)

    def __enter__(self):
        rec = _current
        if rec is not None:
            rec.spans.setdefault(self.name, 0.0)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        rec = _current
        if rec is not None and self.name in rec.spans:
            rec.spans[self.name] += dt
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (0 makes the counter show) to the running call's
    counter ``name``; nothing outside a call."""
    rec = _current
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def register(prefix: str, counters: Dict[str, int]) -> None:
    """Report each call's increments of the dict ``counters`` as
    ``<prefix>.<key>``."""
    _registered[prefix] = counters


@contextlib.contextmanager
def call(name: str):
    """One workflow call: a fresh record, the whole call as span
    ``name``; the record becomes :func:`last_call` when it ends, however
    it ends."""
    global _current, _last
    outer, rec = _current, _Record()
    _current = rec
    try:
        with span(name):
            yield
    finally:
        _current = outer
        _last = rec.finish()


def last_call() -> Optional[dict]:
    """``{"spans": {name: seconds}, "counts": {name: n}}`` of the last
    finished call (None before the first)."""
    if _last is None:
        return None
    return {"spans": dict(_last["spans"]), "counts": dict(_last["counts"])}


def table(record: dict) -> str:
    """``record`` (:func:`last_call`) as the ``--verbose`` table: the
    spans in the order they first opened, then the counters by name."""
    lines = [f"{'phase':<28}{'seconds':>14}"]
    lines += [f"{n:<28}{s:>14.4f}" for n, s in record["spans"].items()]
    lines.append(f"{'counter':<28}{'count':>14}")
    lines += [f"{n:<28}{c:>14}" for n, c in sorted(record["counts"].items())]
    return "\n".join(lines)
