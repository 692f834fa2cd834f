"""Native (C++) engine loader.

The C++ sources in this directory are compiled on demand with ``g++ -O3``
into a shared library cached next to the sources, then bound with ``ctypes``
(pybind11 is unavailable in this environment; the ABI is a thin ``extern
"C"`` surface over numpy buffers).

Set ``GRAFIMO_TPU_NO_NATIVE=1`` to force the pure-python fallbacks.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from itertools import chain
from operator import attrgetter

import numpy as np

from grafimo_tpu_torch.spans import count, span

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_HERE, "graphite.cpp"),
    os.path.join(_HERE, "vcfio.cpp"),
]
_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


def _build_lib() -> ctypes.CDLL:
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    build_dir = os.path.join(_HERE, "_build")
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, f"graphite_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp.{os.getpid()}"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", *_SRCS, "-o", tmp, "-lz",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError as e:  # pragma: no cover
            raise RuntimeError(
                f"native build failed: {e.stderr.decode(errors='replace')}"
            ) from e
        os.replace(tmp, so_path)
    return ctypes.CDLL(so_path)


def _lib() -> ctypes.CDLL:
    global _LIB, _LIB_ERR
    if _LIB is not None:
        return _LIB
    if _LIB_ERR is not None:
        raise _LIB_ERR
    if os.environ.get("GRAFIMO_TPU_NO_NATIVE"):
        _LIB_ERR = RuntimeError("native disabled via GRAFIMO_TPU_NO_NATIVE")
        raise _LIB_ERR
    with _LOCK:
        if _LIB is None:
            try:
                lib = _build_lib()
            except Exception as e:  # pragma: no cover
                _LIB_ERR = e
                raise
            c = ctypes
            u8p, i64p, i32p, f64p = (
                c.POINTER(c.c_uint8), c.POINTER(c.c_int64),
                c.POINTER(c.c_int32), c.POINTER(c.c_double),
            )
            lib.seq_tail_sums.argtypes = [f64p, c.c_int64, i64p, c.c_int64, f64p]
            lib.seq_tail_sums.restype = None
            lib.vcf_parse_gt.argtypes = [
                u8p, c.c_int64, i32p, c.c_int64,
            ]
            lib.vcf_parse_gt.restype = c.c_int64
            lib.gt_build_runs.argtypes = [
                u8p, c.c_int64, c.c_int64, i64p, i64p, i64p, i32p,
                i64p, i64p, u8p, c.c_int64, c.c_int64, c.c_int64,
                c.c_int64, i32p,
            ]
            lib.gt_build_runs.restype = c.c_void_p
            lib.gt_runs_count.argtypes = [c.c_void_p]
            lib.gt_runs_count.restype = c.c_int64
            lib.gt_runs_codes_len.argtypes = [c.c_void_p]
            lib.gt_runs_codes_len.restype = c.c_int64
            lib.gt_runs_valid_len.argtypes = [c.c_void_p]
            lib.gt_runs_valid_len.restype = c.c_int64
            lib.gt_runs_export.argtypes = [
                c.c_void_p, u8p, u8p, i64p, i32p, i32p,
            ]
            lib.gt_runs_export.restype = None
            lib.gt_runs_free.argtypes = [c.c_void_p]
            lib.gt_runs_free.restype = None
            i16p = c.POINTER(c.c_int16)
            lib.gt_batch_regions.argtypes = [
                u8p, c.c_int64, c.c_int64, i64p, i64p, i64p, i32p,
                i64p, i64p, u8p, i64p, i64p, c.c_int64, c.c_int64,
                i64p, i64p, c.c_int64, c.c_int64, c.c_int64, c.c_int64,
            ]
            lib.gt_batch_regions.restype = c.c_void_p
            lib.gt_batch_n_overflows.argtypes = [c.c_void_p]
            lib.gt_batch_n_overflows.restype = c.c_int64
            lib.gt_batch_overflows.argtypes = [c.c_void_p, i32p]
            lib.gt_batch_overflows.restype = None
            lib.gt_batch_n_dense_fallbacks.argtypes = [c.c_void_p]
            lib.gt_batch_n_dense_fallbacks.restype = c.c_int64
            lib.gt_batch_dense_fallbacks.argtypes = [c.c_void_p, i32p]
            lib.gt_batch_dense_fallbacks.restype = None
            lib.gt_batch_rows.argtypes = [c.c_void_p, i64p, i64p, i64p]
            lib.gt_batch_rows.restype = None
            lib.gt_batch_export.argtypes = [
                c.c_void_p, c.c_int64, u8p, u8p, u8p, i32p,
            ]
            lib.gt_batch_export.restype = None
            lib.gt_batch_export_patched.argtypes = [
                c.c_void_p, c.c_int64, i64p, i16p, u8p, i32p,
            ]
            lib.gt_batch_export_patched.restype = None
            lib.gt_splice_breaks.argtypes = []
            lib.gt_splice_breaks.restype = c.c_int64
            lib.gt_batch_export_spliced.argtypes = [
                c.c_void_p, c.c_int64, i64p, i16p, i16p, u8p, i32p,
            ]
            lib.gt_batch_export_spliced.restype = None
            lib.gt_batch_free.argtypes = [c.c_void_p]
            lib.gt_batch_free.restype = None
            u64p = c.POINTER(c.c_uint64)
            lib.vcfio_scan.argtypes = [
                u8p, c.c_int64, u8p, c.c_int64, c.c_int64, i32p,
            ]
            lib.vcfio_scan.restype = c.c_void_p
            for name in (
                "vcfio_n_records", "vcfio_n_hap", "vcfio_words",
                "vcfio_n_alleles", "vcfio_blob_len", "vcfio_n_rows",
            ):
                fn = getattr(lib, name)
                fn.argtypes = [c.c_void_p]
                fn.restype = c.c_int64
            lib.vcfio_export.argtypes = [
                c.c_void_p, i64p, i32p, i64p, i64p, u8p, i64p, i32p, u64p,
            ]
            lib.vcfio_export.restype = None
            lib.vcfio_free.argtypes = [c.c_void_p]
            lib.vcfio_free.restype = None
            _LIB = lib
    return _LIB


_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    _CODE_LUT[ord(_ch)] = _i
    _CODE_LUT[ord(_ch.lower())] = _i


def _codes(text: str) -> np.ndarray:
    """``text``'s bases as 0-3 codes, anything else 4 (uint8)."""
    return _CODE_LUT[np.frombuffer(text.encode("ascii"), np.uint8)]


def _exclusive_cumsum(lengths: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], dtype=np.int64, out=out[1:])
    return out


def _flatten_graph(graph):
    """Flat array view of a SiteGraph for the C++ engine (cached on the
    graph object): the codes of ``seq``; ``site_start`` and ``site_end``
    (the graph's ``site_spans``); ``site_aoff`` and ``site_nall``, each
    site's first allele and allele count; ``allele_off`` and
    ``allele_len`` into ``blob``, the codes of every allele in order.
    Taken from the graph's allele table where it has one (a ``.gvt``
    loaded from its members), else built in whole-graph passes over the
    ``Site`` objects (``.xg``, ``.vg``, ``.gfa``, format-1 files, graphs
    built in memory); both give the same arrays."""
    flat = getattr(graph, "_native_flat_cache", None)
    if flat is not None:
        return flat
    with span("graph_flatten_s"):
        site_start, site_end = graph.site_spans()
        table = graph.allele_table()
        if table is not None:
            n_alleles, bounds, blob = table
            site_nall = np.asarray(n_alleles, dtype=np.int32)
            allele_len = np.diff(bounds)
            blob = _CODE_LUT[blob]
        else:
            alleles = list(map(attrgetter("alleles"), graph.sites))
            site_nall = np.fromiter(map(len, alleles), dtype=np.int32,
                                    count=len(alleles))
            every = list(chain.from_iterable(alleles))
            allele_len = np.fromiter(map(len, every), dtype=np.int64,
                                     count=len(every))
            blob = _codes("".join(every))
        flat = dict(
            seq=_codes(graph.seq),
            site_start=site_start,
            site_end=site_end,
            site_aoff=_exclusive_cumsum(site_nall),
            site_nall=site_nall,
            allele_off=_exclusive_cumsum(allele_len),
            allele_len=allele_len,
            blob=blob,
        )
    count("graph_flatten.graphs")
    graph._native_flat_cache = flat
    return flat


def build_region_runs_native(graph, region_start, region_end, k,
                             max_combos=1 << 14):
    # default == graph.runs.MAX_COMBOS_PER_CLUSTER so the native engine
    # falls back exactly when the python spec does (differential contract)
    """C++ run builder: returns the region's scan payloads (RunPayload
    list), mirroring ``graph/runs.region_runs`` output order."""
    import ctypes as c

    from grafimo_tpu_torch.runscan import RunPayload

    lib = _lib()
    flat = _flatten_graph(graph)
    u8p = c.POINTER(c.c_uint8)
    i64p = c.POINTER(c.c_int64)
    i32p = c.POINTER(c.c_int32)
    status = np.zeros(1, dtype=np.int32)
    handle = lib.gt_build_runs(
        flat["seq"].ctypes.data_as(u8p), c.c_int64(flat["seq"].size),
        c.c_int64(len(flat["site_start"])),
        flat["site_start"].ctypes.data_as(i64p),
        flat["site_end"].ctypes.data_as(i64p),
        flat["site_aoff"].ctypes.data_as(i64p),
        flat["site_nall"].ctypes.data_as(i32p),
        flat["allele_off"].ctypes.data_as(i64p),
        flat["allele_len"].ctypes.data_as(i64p),
        flat["blob"].ctypes.data_as(u8p),
        c.c_int64(region_start), c.c_int64(region_end), c.c_int64(k),
        c.c_int64(max_combos),
        status.ctypes.data_as(i32p),
    )
    if not handle:
        raise RuntimeError("gt_build_runs failed")
    try:
        if int(status[0]) != 0:
            raise OverflowError(
                "allele combination count exceeds the native cap"
            )
        n = lib.gt_runs_count(handle)
        codes = np.empty(lib.gt_runs_codes_len(handle), dtype=np.uint8)
        valid = np.empty(lib.gt_runs_valid_len(handle), dtype=np.uint8)
        run_len = np.empty(n, dtype=np.int64)
        cluster_idx = np.empty(n, dtype=np.int32)
        combo_idx = np.empty(n, dtype=np.int32)
        lib.gt_runs_export(
            handle,
            codes.ctypes.data_as(u8p), valid.ctypes.data_as(u8p),
            run_len.ctypes.data_as(i64p),
            cluster_idx.ctypes.data_as(i32p),
            combo_idx.ctypes.data_as(i32p),
        )
    finally:
        lib.gt_runs_free(handle)
    payloads = []
    co = vo = 0
    for i in range(int(n)):
        ln = int(run_len[i])
        noff = ln - k + 1
        payloads.append(
            RunPayload(
                codes=codes[co : co + ln],
                valid=valid[vo : vo + noff].astype(bool),
                ref=(int(cluster_idx[i]), int(combo_idx[i])),
            )
        )
        co += ln
        vo += noff
    return payloads


def batch_regions_native(graph, regions, k, buckets, max_combos=1 << 14,
                         n_threads=0, bucket_slots=None, dense=False):
    """C++ full batch pipeline: all regions of one graph -> device-ready
    bucketed, bit-packed batches.

    Returns ``(per_bucket, overflow_pairs, dense_fallbacks)`` where
    ``per_bucket`` maps bucket length R to ``dict(packed, nbits, vbits,
    meta)`` (meta int32 ``(rows, 4)``: region_idx, cluster_idx,
    combo_idx, chunk_off) and ``overflow_pairs`` lists ``(region_idx,
    cluster_idx)`` of over-dense clusters (candidate-combination cap)
    whose windows must come from the exact python fallback — every
    OTHER cluster's runs are already in the buckets (cluster-local
    degradation, never a whole region).

    ``dense=True`` handles over-dense clusters IN PROCESS via the
    anchored decomposition (graphite.cpp dense_cluster_runs_native —
    the python ``runs.dense_cluster_runs`` is the spec): their rows land
    in the buckets with lazily-resolvable refs (cluster ``-3 - ci``,
    combo ``anchor * DENSE_COMBO_STRIDE + ordinal``), ``overflow_pairs``
    stays empty for them, and ``dense_fallbacks`` lists ``(region_idx,
    cluster_idx, anchor_idx)`` triples of ultra-dense anchors whose rows
    still need the exact per-window python fallback
    (``runs._anchor_window_fallback``).

    ``bucket_slots`` (aligned with ``sorted(buckets)``) enables native
    patch-descriptor emission: substitution-only cluster chunks with at
    most that many substituted bases land in a ``patched`` sub-dict
    (``gstart int64 (rows,)``, ``patches int16 (rows, slots)``, vbits,
    meta) instead of the packed arrays — device-resident cluster rows
    with no per-chunk python work.
    """
    import ctypes as c

    lib = _lib()
    flat = _flatten_graph(graph)
    u8p = c.POINTER(c.c_uint8)
    i64p = c.POINTER(c.c_int64)
    i32p = c.POINTER(c.c_int32)
    i16p = c.POINTER(c.c_int16)
    starts = np.array([r[0] for r in regions], dtype=np.int64)
    ends = np.array([r[1] for r in regions], dtype=np.int64)
    bucket_arr = np.array(sorted(buckets), dtype=np.int64)
    slots_arr = np.array(
        bucket_slots if bucket_slots is not None
        else [0] * bucket_arr.size,
        dtype=np.int64,
    )
    assert slots_arr.size == bucket_arr.size
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    with span("native_batch_s"):
        handle = lib.gt_batch_regions(
            flat["seq"].ctypes.data_as(u8p), c.c_int64(flat["seq"].size),
            c.c_int64(len(flat["site_start"])),
            flat["site_start"].ctypes.data_as(i64p),
            flat["site_end"].ctypes.data_as(i64p),
            flat["site_aoff"].ctypes.data_as(i64p),
            flat["site_nall"].ctypes.data_as(i32p),
            flat["allele_off"].ctypes.data_as(i64p),
            flat["allele_len"].ctypes.data_as(i64p),
            flat["blob"].ctypes.data_as(u8p),
            starts.ctypes.data_as(i64p), ends.ctypes.data_as(i64p),
            c.c_int64(len(regions)), c.c_int64(k),
            bucket_arr.ctypes.data_as(i64p),
            slots_arr.ctypes.data_as(i64p), c.c_int64(bucket_arr.size),
            c.c_int64(max_combos), c.c_int64(n_threads),
            c.c_int64(1 if dense else 0),
        )
        if not handle:
            raise RuntimeError("gt_batch_regions failed")
        try:
            rows = np.zeros(bucket_arr.size, dtype=np.int64)
            rows_p = np.zeros(bucket_arr.size, dtype=np.int64)
            rows_s = np.zeros(bucket_arr.size, dtype=np.int64)
            lib.gt_batch_rows(
                handle, rows.ctypes.data_as(i64p),
                rows_p.ctypes.data_as(i64p), rows_s.ctypes.data_as(i64p),
            )
            n_brk = int(lib.gt_splice_breaks())
            per_bucket = {}
            for bi, r_len in enumerate(bucket_arr.tolist()):
                n = int(rows[bi])
                n_p = int(rows_p[bi])
                n_s = int(rows_s[bi])
                if n == 0 and n_p == 0 and n_s == 0:
                    continue
                noff = r_len - k + 1
                entry = {}
                if n:
                    packed = np.empty((n, r_len // 4), dtype=np.uint8)
                    nbits = np.empty((n, (r_len + 7) // 8), dtype=np.uint8)
                    vbits = np.empty((n, (noff + 7) // 8), dtype=np.uint8)
                    meta = np.empty((n, 4), dtype=np.int32)
                    lib.gt_batch_export(
                        handle, c.c_int64(bi),
                        packed.ctypes.data_as(u8p), nbits.ctypes.data_as(u8p),
                        vbits.ctypes.data_as(u8p), meta.ctypes.data_as(i32p),
                    )
                    entry.update(
                        packed=packed, nbits=nbits, vbits=vbits, meta=meta
                    )
                if n_p:
                    slots = int(slots_arr[bi])
                    gstart = np.empty(n_p, dtype=np.int64)
                    pat = np.empty((n_p, slots), dtype=np.int16)
                    vbits_p = np.empty((n_p, (noff + 7) // 8), dtype=np.uint8)
                    meta_p = np.empty((n_p, 4), dtype=np.int32)
                    lib.gt_batch_export_patched(
                        handle, c.c_int64(bi),
                        gstart.ctypes.data_as(i64p),
                        pat.ctypes.data_as(i16p),
                        vbits_p.ctypes.data_as(u8p),
                        meta_p.ctypes.data_as(i32p),
                    )
                    entry["patched"] = dict(
                        gstart=gstart, patches=pat, vbits=vbits_p, meta=meta_p
                    )
                if n_s:
                    slots = int(slots_arr[bi])
                    gstart_s = np.empty(n_s, dtype=np.int64)
                    splice = np.empty((n_s, 2 * n_brk), dtype=np.int16)
                    pat_s = np.empty((n_s, slots), dtype=np.int16)
                    vbits_s = np.empty((n_s, (noff + 7) // 8), dtype=np.uint8)
                    meta_s = np.empty((n_s, 4), dtype=np.int32)
                    lib.gt_batch_export_spliced(
                        handle, c.c_int64(bi),
                        gstart_s.ctypes.data_as(i64p),
                        splice.ctypes.data_as(i16p),
                        pat_s.ctypes.data_as(i16p),
                        vbits_s.ctypes.data_as(u8p),
                        meta_s.ctypes.data_as(i32p),
                    )
                    entry["spliced"] = dict(
                        gstart=gstart_s, splice=splice, patches=pat_s,
                        vbits=vbits_s, meta=meta_s,
                    )
                per_bucket[int(r_len)] = entry
            n_ovf = int(lib.gt_batch_n_overflows(handle))
            overflow = np.empty((n_ovf, 2), dtype=np.int32)
            if n_ovf:
                lib.gt_batch_overflows(handle, overflow.ctypes.data_as(i32p))
            n_dfb = int(lib.gt_batch_n_dense_fallbacks(handle))
            dense_fb = np.empty((n_dfb, 3), dtype=np.int32)
            if n_dfb:
                lib.gt_batch_dense_fallbacks(
                    handle, dense_fb.ctypes.data_as(i32p)
                )
        finally:
            lib.gt_batch_free(handle)
    return (
        per_bucket,
        [(int(r), int(ci)) for r, ci in overflow],
        [(int(r), int(ci), int(ai)) for r, ci, ai in dense_fb],
    )


def vcf_parse_gt(sample_block: bytes, n_expected: int):
    """Parse a VCF sample block into allele indices per haplotype (C++).

    Returns an int32 array or None when the block is malformed / yields a
    different haplotype count than expected."""
    import ctypes as c

    lib = _lib()
    out = np.empty(n_expected + 8, dtype=np.int32)
    n = lib.vcf_parse_gt(
        c.cast(c.c_char_p(sample_block), c.POINTER(c.c_uint8)),
        c.c_int64(len(sample_block)),
        out.ctypes.data_as(c.POINTER(c.c_int32)),
        c.c_int64(out.size),
    )
    if n != n_expected:
        return None
    return out[:n_expected]


def vcf_scan_native(fn: str, chrom: str, n_threads: int = 0):
    """Threaded C++ VCF body scan (``vcfio.cpp``): all records of one
    chromosome, genotypes already reduced to per-(record, alt-allele)
    haplotype bitsets (the HaploIndex row layout, ``graph/haplo.py``).

    BGZF inputs (bgzip/htslib — the 1KGP container) are decompressed in
    parallel; plain gzip and plain text are handled too.  Returns
    ``(records, n_hap)`` where each ``VcfRecord.gt`` is a dict
    ``{allele_idx: uint64 bitset words}`` (``None`` when the VCF carries
    no samples).  Raises on IO/format errors or irregular ploidy — the
    caller falls back to the python reader (``io/vcf.py``).
    """
    import ctypes as c

    from grafimo_tpu_torch.io.vcf import VcfRecord

    lib = _lib()
    u8p = c.POINTER(c.c_uint8)
    i64p = c.POINTER(c.c_int64)
    i32p = c.POINTER(c.c_int32)
    status = np.zeros(1, dtype=np.int32)
    path_b = os.fspath(fn).encode()
    chrom_b = chrom.encode()
    h = lib.vcfio_scan(
        c.cast(c.c_char_p(path_b), u8p), c.c_int64(len(path_b)),
        c.cast(c.c_char_p(chrom_b), u8p), c.c_int64(len(chrom_b)),
        c.c_int64(n_threads), status.ctypes.data_as(i32p),
    )
    if not h:
        raise RuntimeError("vcfio_scan failed")
    try:
        if int(status[0]) != 0:
            raise RuntimeError(f"vcfio_scan status {int(status[0])}")
        n = int(lib.vcfio_n_records(h))
        n_hap = int(lib.vcfio_n_hap(h))
        words = int(lib.vcfio_words(h))
        n_alleles = int(lib.vcfio_n_alleles(h))
        n_rows = int(lib.vcfio_n_rows(h))
        pos = np.empty(n, dtype=np.int64)
        n_alt = np.empty(n, dtype=np.int32)
        seq_off = np.empty(n_alleles, dtype=np.int64)
        seq_len = np.empty(n_alleles, dtype=np.int64)
        blob = np.empty(int(lib.vcfio_blob_len(h)), dtype=np.uint8)
        row_off = np.empty(n + 1, dtype=np.int64)
        row_allele = np.empty(n_rows, dtype=np.int32)
        bits = np.empty((n_rows, max(words, 1)), dtype=np.uint64)
        lib.vcfio_export(
            h, pos.ctypes.data_as(i64p), n_alt.ctypes.data_as(i32p),
            seq_off.ctypes.data_as(i64p), seq_len.ctypes.data_as(i64p),
            blob.ctypes.data_as(u8p), row_off.ctypes.data_as(i64p),
            row_allele.ctypes.data_as(i32p),
            bits.ctypes.data_as(c.POINTER(c.c_uint64)),
        )
    finally:
        lib.vcfio_free(h)
    blob_s = blob.tobytes().decode("ascii")
    records = []
    ai = 0
    for i in range(n):
        na = int(n_alt[i])
        seqs = [
            blob_s[int(seq_off[ai + j]) : int(seq_off[ai + j])
                   + int(seq_len[ai + j])]
            for j in range(1 + na)
        ]
        ai += 1 + na
        gt = None
        if n_hap > 0:
            gt = {
                int(row_allele[j]): bits[j]
                for j in range(int(row_off[i]), int(row_off[i + 1]))
            }
        records.append(
            VcfRecord(chrom=chrom, pos=int(pos[i]), ref=seqs[0],
                      alts=seqs[1:], gt=gt)
        )
    return records, (n_hap if n_hap > 0 else None)


def seq_tail_sums(arr: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Strict left-to-right tail sums ``out[i] = sum(arr[starts[i]:])``."""
    lib = _lib()
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.empty(len(starts), dtype=np.float64)
    lib.seq_tail_sums(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(arr.size),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(starts.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
