"""Exact p-values of many scores at once: the statistics layer's tail
sums and p-value cache.

The pinned ``models/pvalue.py`` evaluates the p-value of an integer score
``s`` as ``sum(table[s:]) / sum(table)``, each tail summed strictly left to
right (the reference GRAFIMO's order) by the scalar loop of
``native/graphite.cpp:seq_tail_sums``, one start after another, and keeps
the results in a ``dict``.  A q-value table asks for every occupied score
bin of a motif's histogram at once: thousands of tails over a table of
6,001-28,001 bins.

:func:`tail_sums` gives the scalar loop's bits for many starts at once:
``csrc/tail_sums.cpp`` runs a group of starts in the lanes of the host's
vector registers, each lane making the scalar loop's adds in its order
(one start runs the scalar loop).  It is built with ``g++`` and the pinned
native engine's flags at first use into ``grafimo_tpu_torch/_build/``.
:class:`PvalueLookup` is the pinned lookup with its cache in a dense
float64 array.  ``GRAFIMO_TPU_NO_NATIVE=1``, or a failed build, leaves
the pinned ``tail_sums`` and its pure-Python fallback in charge.

``COUNTS``, registered as ``pvalue.*``: ``tail_starts`` (starts summed),
``lane_groups`` (groups summed in lanes), ``serial_starts`` (starts summed
one at a time) and ``cache_hits`` (distinct scores a lookup served from
its cache).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterable

import numpy as np

from grafimo_tpu_torch import spans
from grafimo_tpu_torch.models import pvalue as pinned

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "tail_sums.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
# the flags of the pinned native engine (native/__init__.py)
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

COUNTS = {"tail_starts": 0, "lane_groups": 0, "serial_starts": 0,
          "cache_hits": 0}
spans.register("pvalue", COUNTS)

_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


def _build() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    so_path = os.path.join(BUILD_DIR, f"tail_sums_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp.{os.getpid()}"
        proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"tail_sums.cpp build failed: {proc.stderr}")
        os.replace(tmp, so_path)
    return so_path


def _lib() -> ctypes.CDLL:
    """The lane library, built on first call; raises while the native
    engine is disabled or after a failed build."""
    global _LIB, _LIB_ERR
    if _LIB is not None:
        return _LIB
    if _LIB_ERR is not None:
        raise _LIB_ERR
    if os.environ.get("GRAFIMO_TPU_NO_NATIVE"):
        raise RuntimeError("native disabled via GRAFIMO_TPU_NO_NATIVE")
    with _LOCK:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(_build())
            except (OSError, RuntimeError) as e:
                _LIB_ERR = e
                raise
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.lane_tail_sums.argtypes = [ptr, i64, ptr, i64, ptr, ptr]
            lib.lane_tail_sums.restype = None
            lib.tail_sum_lanes.argtypes = []
            lib.tail_sum_lanes.restype = ctypes.c_int64
            _LIB = lib
    return _LIB


def lanes() -> int:
    """Starts a lane group sums at once (``csrc/tail_sums.cpp``)."""
    return int(_lib().tail_sum_lanes())


def tail_sums(arr: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """``out[i] = sum(arr[max(starts[i], 0):])``, strictly left to right
    from +0.0: the bits of the pinned ``tail_sums``, for any order of
    ``starts`` and any repeats; 0.0 for a start at ``len(arr)`` or
    beyond."""
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    m = len(starts)
    COUNTS["tail_starts"] += m
    try:
        lib = _lib()
    except (OSError, RuntimeError):
        COUNTS["serial_starts"] += m
        return pinned.tail_sums(arr, starts)
    out = np.empty(m, dtype=np.float64)
    counts = np.zeros(2, dtype=np.int64)  # lane groups, starts alone
    lib.lane_tail_sums(arr.ctypes.data, arr.size, starts.ctypes.data, m,
                       out.ctypes.data, counts.ctypes.data)
    COUNTS["lane_groups"] += int(counts[0])
    COUNTS["serial_starts"] += int(counts[1])
    return out


class PvalueLookup(pinned.PvalueLookup):
    """The pinned lookup, ``pvalue`` and ``score_cutoff`` as they are,
    with ``pvalues`` caching in a dense float64 array: one slot a score
    and one for every score at or past the table's end, NaN until
    computed, allocated on first use.  A negative score reads as 0, as
    the native tail sums clamp it."""

    def __init__(self, pval_table: np.ndarray):
        super().__init__(pval_table)
        self._dense = None

    def pvalues(self, scores: Iterable[int]) -> np.ndarray:
        """Vectorised p-values for an int array of scores."""
        n = len(self.table)
        if self._dense is None:
            self._dense = np.full(n + 1, np.nan)
        idx = np.clip(np.asarray(scores, dtype=np.int64), 0, n)
        uniq = np.unique(idx)
        missing = uniq[np.isnan(self._dense[uniq])]
        COUNTS["cache_hits"] += len(uniq) - len(missing)
        if len(missing):
            # float64 division by the same total: the bits of the pinned
            # ``float(t) / self.tot``
            self._dense[missing] = tail_sums(self.table, missing) / self.tot
        return self._dense[idx]
