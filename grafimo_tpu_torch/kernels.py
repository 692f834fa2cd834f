"""Build and bind the port's CUDA kernels.

The CUDA sources under ``csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc -c`` per source, all started together, and linked
into one shared library with a plain C interface, named by a hash of the
sources, the header they share and the flags (as
``grafimo_tpu/native/__init__.py:29-51`` names its C++ library) and
cached under ``grafimo_tpu_torch/_build/``.  The build
runs at first use, never at import, so the CPU tests import every module
on a host without ``nvcc``.  The library is bound with ``ctypes``:
pointers and the stream cross as ``c_void_p``.  ``csrc/tail_sums.cpp`` is
host C++, built with ``g++`` by ``pvalues.py``.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

from grafimo_tpu_torch import spans

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [
    os.path.join(_HERE, "csrc", name)
    for name in ("hist.cu", "scan_packed.cu", "compact.cu", "scan_runs.cu")
]
HEADERS = [os.path.join(_HERE, "csrc", "bins.cuh")]
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIB = None
# what the last build printed (ptxas register / shared-memory report)
# and how long it took; None when the library came from the cache
BUILD_LOG = None
BUILD_SECONDS = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = os.path.join(root, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
        "compiled at first use and need the CUDA toolkit"
    )


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"grafimo_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the hashed library exists; returns its
    path."""
    global BUILD_LOG, BUILD_SECONDS
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        for obj, src in zip(objs, SOURCES)
    ]
    # the target flags only keep nvcc from warning about its default arch
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
    with spans.span("kernel_build_s") as timed:
        try:
            procs = [
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for cmd in compiles
            ]
            logs = [p.communicate()[0] for p in procs]
            for cmd, proc, out in zip(compiles, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({' '.join(cmd)}):\n{out}"
                    )
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({' '.join(link)}):\n{proc.stdout}"
                )
            os.replace(tmp, so_path)
        finally:
            for path in (*objs, tmp):
                if os.path.exists(path):
                    os.remove(path)
    BUILD_SECONDS = timed.seconds
    BUILD_LOG = "".join(logs) + proc.stdout
    return so_path


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            c = ctypes
            lib.grafimo_exact_hist.argtypes = [
                c.c_void_p, c.c_longlong, c.c_int, c.c_int, c.c_void_p,
                c.c_void_p, c.c_int, c.c_void_p,
            ]
            lib.grafimo_exact_hist.restype = c.c_int
            lib.grafimo_max_hist_size.argtypes = [c.c_int]
            lib.grafimo_max_hist_size.restype = c.c_int
            lib.grafimo_scan_packed.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_longlong,
                c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_int, c.c_int,
                c.c_void_p,
            ]
            lib.grafimo_scan_packed.restype = c.c_int
            lib.grafimo_compact_hits.argtypes = [
                c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_void_p,
                c.c_void_p, c.c_void_p, c.c_int, c.c_void_p, c.c_int,
                c.c_void_p, c.c_int, c.c_void_p,
            ]
            lib.grafimo_compact_hits.restype = c.c_int
            lib.grafimo_scan_runs.argtypes = [
                c.c_int,  # source
                c.c_void_p, c.c_int, c.c_void_p, c.c_int,  # packed, nbits
                c.c_void_p, c.c_longlong, c.c_void_p, c.c_longlong,  # planes
                c.c_void_p, c.c_longlong, c.c_longlong,  # gstart, lo, stride
                c.c_void_p, c.c_int,  # patches, slots
                c.c_void_p, c.c_int, c.c_int,  # splice, pairs, clear_n
                c.c_void_p, c.c_int,  # vbits
                c.c_void_p, c.c_void_p,  # lut, min_scores
                c.c_longlong, c.c_int, c.c_int, c.c_int,  # b, r, k, m
                c.c_void_p, c.c_int, c.c_void_p,  # out, dev, stream
            ]
            lib.grafimo_scan_runs.restype = c.c_int
            lib.grafimo_scan_runs_fused.argtypes = [
                *lib.grafimo_scan_runs.argtypes[:-3],  # through b, r, k, m
                c.c_void_p, c.c_void_p, c.c_int,  # cutoffs, bases, comp_size
                c.c_void_p, c.c_void_p,  # hist, count
                c.c_void_p, c.c_int, c.c_void_p, c.c_int,  # idx_a, idx_b
                c.c_void_p, c.c_int, c.c_void_p,  # bits, dev, stream
            ]
            lib.grafimo_scan_runs_fused.restype = c.c_int
            lib.grafimo_smem_block.argtypes = [c.c_int]
            lib.grafimo_smem_block.restype = c.c_int
            lib.grafimo_cuda_error_string.argtypes = [c.c_int]
            lib.grafimo_cuda_error_string.restype = c.c_char_p
            _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def max_hist_size(dev: int) -> int:
    """The most bins a column of the counting kernels holds on device
    ``dev`` (one cluster of blocks' shared memory)."""
    with on_device(dev):
        return load().grafimo_max_hist_size(dev)


@functools.lru_cache(maxsize=None)
def smem_block(dev: int) -> int:
    """The dynamic shared memory a block may opt in to on device ``dev``,
    in bytes."""
    with on_device(dev):
        return load().grafimo_smem_block(dev)


def on_device(dev: int):
    """A context in which CUDA device ``dev`` is current: none when it
    already is, so a launch on the current device switches nothing."""
    import torch

    if torch.cuda.current_device() == dev:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a kernel entry returned a CUDA error."""
    if code:
        msg = lib.grafimo_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
