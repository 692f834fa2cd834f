#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``grafimo_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit,
   pandas, and the shared C++ engine (built with g++ on first use);
2. build: the CUDA kernels, compiled with nvcc for sm_90a;
3. the exact-histogram kernel against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes (and past the TPU
   kernel's 16-column cap, and on its global-memory path), with CUDA
   event timings;
4. ``scan_batches`` over a seeded mix of all five batch kinds on the card
   and on the CPU: identical histograms and hits;
5. the main path at chromosome scale: a synthetic chromosome at the
   1KGP profile (``tools/bench_chrom_scale.py``), ``buildvg``, then a
   whole-chromosome CTCF ``findmotif`` through the port's CLI on the
   card, which must launch the histogram kernel and never its plain
   version; then a 1 Mbp region around the first dense pocket on the
   card and on the CPU, whose reports must be byte-identical;
6. the packed-window scoring kernel against its plain version on the
   card, bit for bit, at the window engine's chunk shape and around it
   (fwd + RC columns, k = 8 and 30, M = 16, N and PAD rows, a ragged B,
   LUT entries at 1020), with CUDA event timings;
7. the exact-histogram kernel against its plain version over the range
   of the TPU's histogram variants (native ``(n, M)`` layout, n not a
   tile multiple, k in {8, 19, 32}, M in {1, 3, 16});
8. the per-window engine (``findmotif --engine windows``) on phase 5's
   graph over a seeded set of 1,000 peak-sized regions: on the card,
   where it must launch both kernels and neither plain version, then on
   the CPU, whose report must be byte-identical, then the run engine on
   the card, whose report must hold the same rows.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device the script exits 1 before any phase.  It imports
no JAX: ``jax`` is blocked from import in this process and in the ones
it starts.
"""

import contextlib
import io
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_MBP = 10  # the repo's 10 Mbp demo / round-5 profile size
SEED = 0
HAPLOTYPES = 5096  # 2548 diploid samples, the 1KGP panel
MOTIF = os.path.join(HERE, "tests", "data", "input", "MA0139.1.meme")
BLOCK_JAX = "import sys; sys.modules['jax'] = None\n"

# inputs at the 1KGP profile, written by the benchmark tool's own
# generators (1/30 bp variants, 12% indels, 3 dense pockets)
SYNTH_PROG = BLOCK_JAX + r"""
import importlib.util, json, os, numpy as np
root, wd, mbp, seed, hap = sys.argv[1:6]
spec = importlib.util.spec_from_file_location(
    "bench_chrom_scale", os.path.join(root, "tools", "bench_chrom_scale.py"))
bcs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bcs)
rng = np.random.default_rng(int(seed))
L, H = int(float(mbp) * 1e6), int(hap)
seq, pos, pockets = bcs.synth_chrom(rng, L, H)
variants, n_indel = bcs.make_variants(rng, seq, pos, H)
bcs.write_fasta(os.path.join(wd, "ref.fa"), "21", seq)
bcs.write_vcf(os.path.join(wd, "synth.vcf.gz"), "21", seq, variants, H)
print(json.dumps({"length": L, "variants": len(variants),
                  "indels": n_indel, "pockets": pockets}))
"""

RUN_MODULE_PROG = BLOCK_JAX + (
    "import runpy\n"
    "sys.argv = ['grafimo_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('grafimo_tpu_torch', run_name='__main__')\n"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def run_checked(cmd, timeout):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=timeout)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cmd[2:5]} failed rc={proc.returncode}:\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
        )
    return proc.stdout, dt


# --------------------------------------------------------------------------


def phase_environment(torch):
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    try:
        import pandas

        log(f"pandas {pandas.__version__}")
    except ImportError as e:
        raise RuntimeError(f"pandas is missing ({e}): reports need it")
    from grafimo_tpu_torch.device import check_native

    t0 = time.perf_counter()
    log(f"native engine: {check_native()} "
        f"(loaded in {time.perf_counter() - t0:.2f}s)")
    return card


def phase_build():
    from grafimo_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {kernels.BUILD_SECONDS}s)")
    if kernels.BUILD_LOG:
        log(kernels.BUILD_LOG.strip())


def _time_ms(torch, fn, reps=10):
    fn()  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _main_path_scores(torch, rows, r, k, m, gen):
    """Device bins as the main path hands them to the histogram: window
    scores of random codes under a random integer PWM, + 1 (the remap),
    about 5% invalid (-1)."""
    from grafimo_tpu_torch.ops.score_runs import _window_scores

    dev = torch.device("cuda")
    codes = torch.randint(0, 4, (rows, r), device=dev, generator=gen)
    lut = torch.randint(0, 1001, (k, 4, m), device=dev, generator=gen,
                        dtype=torch.int32)
    s = _window_scores(codes, lut, k) + 1
    invalid = torch.rand(s.shape, device=dev, generator=gen) < 0.05
    return s.masked_fill_(invalid, -1).contiguous()


def phase_kernel_vs_plain(torch):
    from grafimo_tpu_torch.ops.hist import exact_hist, exact_hist_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = r = 2048
    cases = [  # (label, k, M); hist_size = 1000*k + 2 (remapped bins)
        ("main path B=R=2048 k=19 M=2", 19, 2),
        ("M=16 (TPU kernel cap)", 19, 16),
        ("M=40 (past the TPU cap)", 19, 40),
        ("k=30", 30, 2),
        ("k=70 (global-memory path)", 70, 2),
    ]
    out = []
    for label, k, m in cases:
        hist_size = 1000 * k + 2
        s = _main_path_scores(torch, rows, r, k, m, gen)
        got = exact_hist(s, hist_size)
        want = exact_hist_reference(s, hist_size)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err or not torch.equal(got, want):
            raise RuntimeError(f"kernel != plain at {label}: max err {err}")
        ms = _time_ms(torch, lambda: exact_hist(s, hist_size))
        plain_ms = _time_ms(torch, lambda: exact_hist_reference(s, hist_size))
        log(f"kernel vs plain [{label}] shape {tuple(s.shape)} bins "
            f"{hist_size}: bit-identical, max_abs_err 0, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (median of 10, CUDA events)")
        out.append({"label": label, "ms": ms, "plain_ms": plain_ms,
                    "max_abs_err": err})
        del s, got, want
    torch.cuda.empty_cache()
    return out


def _mix(rb, graph, rng, k):
    """Seeded batches of all five kinds: N bases (in the genome), invalid
    offsets, empty and full patch slots, negative splice shifts."""
    import numpy as np

    key = "21:0-mix"

    def chunks(n, c_idx):
        return [rb.RunChunk((key, (c_idx, i)), 0) for i in range(n)]

    def vbits(b, r):
        v = rng.random((b, r - k + 1)) < 0.95
        v[0] = True
        return rb.pack_bits(v)

    length = len(graph.seq)
    out = []
    b, r = 512, 256
    out.append(rb.DeviceBatch(
        R=r, packed=rb.pack_run_seqs(rng.integers(0, 4, (b, r))),
        nbits=rb.pack_bits(rng.random((b, r)) < 0.001), vbits=vbits(b, r),
        chunks=chunks(b, 9),
    ))
    r = 2048
    stride = r - k + 1
    out.append(rb.DeviceBatch(
        R=r, packed=None, nbits=None, vbits=vbits(64, r),
        chunks=chunks(64, -1), graph=graph,
        gstart=(1000 + stride * np.arange(64)).astype(np.int32),
    ))
    b, r = 256, 1024
    gstart = rng.integers(64, length - r - 64, b).astype(np.int32)
    out.append(rb.DeviceBatch(
        R=r, packed=None, nbits=None, vbits=vbits(b, r), chunks=chunks(b, -1),
        gstart=gstart, graph=graph,
    ))
    patches = np.full((b, 16), -1, np.int16)
    for i in range(1, b):
        n = 16 if i == 1 else int(rng.integers(1, 16))
        patches[i, :n] = rng.choice(r, n, replace=False) * 4 + rng.integers(
            0, 4, n)
    out.append(rb.DeviceBatch(
        R=r, packed=None, nbits=None, vbits=vbits(b, r), chunks=chunks(b, 3),
        gstart=gstart, graph=graph, patches=patches,
    ))
    splice = np.full((b, 4), 0x7FFF, np.int16)
    splice[1:, 0] = rng.integers(16, r // 2, b - 1)
    splice[1:, 1] = rng.integers(-40, 41, b - 1)
    splice[1:, 2] = rng.integers(r // 2, r - 16, b - 1)
    splice[1:, 3] = rng.integers(-40, 41, b - 1)
    out.append(rb.DeviceBatch(
        R=r, packed=None, nbits=None, vbits=vbits(b, r), chunks=chunks(b, 4),
        gstart=gstart, graph=graph, patches=patches, splice=splice,
    ))
    return out


def phase_cuda_vs_cpu(torch):
    import types

    import numpy as np

    import grafimo_tpu_torch.runscan as rb

    rng = np.random.default_rng(SEED)
    length = 400_000
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), length)
    for start in rng.integers(0, length - 50, 40):
        seq[start : start + int(rng.integers(1, 30))] = ord("N")
    # _resident_genome reads only .seq (and caches on the object)
    graph = types.SimpleNamespace(seq=seq.tobytes().decode("ascii"))
    k, m = 19, 4
    pwm = rng.integers(0, 1001, (k, 4, m)).astype(np.float32)
    lo = pwm.min(axis=1).sum(axis=0)
    hi = pwm.max(axis=1).sum(axis=0)
    mins = lo.astype(np.int32)
    cuts = (lo + 0.8 * (hi - lo)).astype(np.int32)
    results = {}
    for dev in ("cuda", "cpu"):
        batches = _mix(rb, graph, np.random.default_rng(SEED + 1), k)
        t0 = time.perf_counter()
        res = rb.scan_batches(batches, pwm, mins, cuts, k, 1000 * k + 1,
                              torch.device(dev))
        results[dev] = (res, time.perf_counter() - t0)
    (gc, tc), (cc, tcpu) = results["cuda"], results["cpu"]
    if not np.array_equal(gc.hists, cc.hists):
        raise RuntimeError("port cuda != port cpu: histograms differ")
    if sorted(gc.hits) != sorted(cc.hits):
        raise RuntimeError("port cuda != port cpu: hits differ")
    if not len(gc.hits) or gc.hists.sum() == 0:
        raise RuntimeError("five-kind mix produced no windows or no hits")
    log(f"five-kind mix: port cuda == port cpu ({int(gc.hists.sum())} "
        f"window-strands, {len(gc.hits)} hits; cuda {tc:.2f}s, "
        f"cpu {tcpu:.2f}s host wall)")


def _findmotif(argv):
    """The port's CLI in this process, its stdout captured and echoed."""
    from grafimo_tpu_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(("Scanned", "run scan", "wire", "width",
                            "compute backend", "window scan")):
            log(f"    {line}")
    if rc != 0:
        raise RuntimeError(f"findmotif rc={rc}: {text[-2000:]}")
    return text, dt


def _report(outdir):
    with open(os.path.join(outdir, "grafimo_out.tsv"), "rb") as f:
        tsv = f.read()
    n_hits = len(tsv.splitlines()) - 1
    if n_hits <= 0:
        raise RuntimeError(f"empty report in {outdir}")
    return tsv, n_hits


def phase_main_path(torch, wd):
    from grafimo_tpu_torch.ops import hist

    out, dt = run_checked(
        [sys.executable, "-c", SYNTH_PROG, HERE, wd, str(SMOKE_MBP),
         str(SEED), str(HAPLOTYPES)], timeout=900,
    )
    synth = json.loads(out.strip().splitlines()[-1])
    log(f"synth {SMOKE_MBP} Mbp: {synth['variants']} variants "
        f"({synth['indels']} indels), {HAPLOTYPES} haplotypes, pockets "
        f"{synth['pockets']} in {dt:.1f}s")
    gdir = os.path.join(wd, "graphs")
    _, dt = run_checked(
        [sys.executable, "-c", RUN_MODULE_PROG, "buildvg",
         "-l", os.path.join(wd, "ref.fa"),
         "-v", os.path.join(wd, "synth.vcf.gz"), "-o", gdir], timeout=900,
    )
    log(f"buildvg (python -m grafimo_tpu_torch): {dt:.1f}s")

    whole = os.path.join(wd, "whole.bed")
    with open(whole, "w") as f:
        f.write(f"chr21\t0\t{synth['length']}\n")
    hist.reset_counts()
    text, wall = _findmotif([
        "findmotif", "-d", gdir, "-b", whole, "-m", MOTIF, "-t", "1e-4",
        "-o", os.path.join(wd, "out_whole"), "--verbose", "--device", "cuda",
    ])
    launches = dict(hist.COUNTS)
    if launches["kernel"] <= 0 or launches["plain"] != 0:
        raise RuntimeError(f"main path did not run on the kernel: {launches}")
    _, n_hits = _report(os.path.join(wd, "out_whole"))
    m = re.search(r"run scan: \d+ device batches, (\d+) windows/strand, "
                  r"(\d+) raw hits \(([\d.]+)s\)", text)
    if m is None:
        raise RuntimeError("findmotif printed no run-scan summary")
    windows, scan_s = int(m.group(1)), float(m.group(3))
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"whole-chromosome findmotif on cuda: {windows} windows/strand, "
        f"{n_hits} hits (p < 1e-4), scan {scan_s:.2f}s, wall {wall:.2f}s, "
        f"{windows / scan_s:.0f} windows/strand/s, peak RSS {rss_gb:.2f} GB "
        f"(whole smoke process), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"histogram kernel launches {launches['kernel']}, plain "
        f"{launches['plain']}; mismatch guard passed")

    pocket_lo, pocket_hi = synth["pockets"][0]
    mid = (pocket_lo + pocket_hi) // 2
    region = (max(0, mid - 500_000), min(synth["length"], mid + 500_000))
    bed = os.path.join(wd, "pocket.bed")
    with open(bed, "w") as f:
        f.write(f"chr21\t{region[0]}\t{region[1]}\n")
    reports = {}
    for dev in ("cuda", "cpu"):
        outdir = os.path.join(wd, f"out_pocket_{dev}")
        _, dt = _findmotif([
            "findmotif", "-d", gdir, "-b", bed, "-m", MOTIF, "-t", "1e-4",
            "-o", outdir, "--verbose", "--device", dev,
        ])
        reports[dev] = _report(outdir)
        log(f"1 Mbp pocket region {region} on {dev}: {reports[dev][1]} hits, "
            f"wall {dt:.2f}s")
    if reports["cuda"][0] != reports["cpu"][0]:
        raise RuntimeError("1 Mbp pocket region: cuda and cpu TSVs differ")
    log("1 Mbp pocket region: cuda TSV byte-identical to cpu TSV")
    return launches["kernel"], gdir, synth


def _random_packed(torch, b, k, m, gen, flag_frac=0.0, high=1001):
    """Device inputs of the packed-window scoring: random 2-bit rows,
    flags with ``flag_frac`` N rows and as many PAD rows, an integer LUT
    with entries below ``high`` and the per-column minimum scores."""
    from grafimo_tpu_torch.ops.pack import packed_width

    dev = torch.device("cuda")
    packed = torch.randint(0, 256, (b, packed_width(k)), device=dev,
                           generator=gen, dtype=torch.uint8)
    u = torch.rand(b, device=dev, generator=gen)
    flags = torch.zeros(b, dtype=torch.uint8, device=dev)
    flags[u < flag_frac] = 1
    flags[(u >= flag_frac) & (u < 2 * flag_frac)] = 2
    lut = torch.randint(0, high, (k, 4, m), device=dev, generator=gen,
                        dtype=torch.int32)
    mins = lut.min(dim=1).values.sum(dim=0).to(torch.int32)
    return packed, flags, lut, mins


def phase_scan_packed_vs_plain(torch):
    from grafimo_tpu_torch.ops.scan_packed import (
        score_packed,
        score_packed_reference,
    )
    from grafimo_tpu_torch.scan import CHUNK

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [  # (label, B, k, M, N/PAD row fraction each, LUT bound)
        ("window path B=2^18 k=19 M=1", CHUNK, 19, 1, 0.0, 1001),
        ("fwd + RC k=19 M=2", CHUNK, 19, 2, 0.0, 1001),
        ("k=30 M=16", CHUNK, 30, 16, 0.0, 1001),
        ("k=8 M=1", CHUNK, 8, 1, 0.0, 1001),
        ("B=2^18-7, 1% N + 1% PAD rows", CHUNK - 7, 19, 2, 0.01, 1001),
        ("LUT entries at 1020", CHUNK, 19, 2, 0.0, 1021),
    ]
    out = []
    for label, b, k, m, frac, high in cases:
        packed, flags, lut, mins = _random_packed(torch, b, k, m, gen, frac,
                                                  high)
        if high > 1001:
            lut[:, :, 0] = 1020  # column 0 scores 1020*k on every clean row
        got = score_packed(packed, flags, lut, mins)
        want = score_packed_reference(packed, flags, lut, mins)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err or not torch.equal(got, want):
            raise RuntimeError(f"score_packed != plain at {label}: "
                               f"max err {err}")
        if frac and not ((got == -1).any() and (flags == 1).any()):
            raise RuntimeError(f"{label}: no N or PAD rows drawn")
        ms = _time_ms(torch, lambda: score_packed(packed, flags, lut, mins))
        plain_ms = _time_ms(
            torch, lambda: score_packed_reference(packed, flags, lut, mins))
        log(f"score_packed vs plain [{label}] packed {tuple(packed.shape)} "
            f"M={m}: bit-identical, max_abs_err 0, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (median of 10, CUDA events)")
        out.append({"label": label, "ms": ms, "plain_ms": plain_ms,
                    "max_abs_err": err})
        del packed, flags, lut, mins, got, want
    torch.cuda.empty_cache()
    return out


def phase_hist_variants(torch):
    """Kernels 2-4 of the TPU's histogram share kernel 1's contract; the
    one CUDA kernel is held to it over their parameter range, on the
    window path's native (n, M) score layout."""
    from grafimo_tpu_torch.ops.hist import exact_hist, exact_hist_reference
    from grafimo_tpu_torch.ops.scan_packed import score_packed_reference
    from grafimo_tpu_torch.ops.score_windows import hist_size_for_width

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n = (1 << 18) + 123
    out = []
    for k in (8, 19, 32):
        for m in (1, 3, 16):
            hist_size = hist_size_for_width(k)
            packed, flags, lut, mins = _random_packed(torch, n, k, m, gen,
                                                      0.01)
            s = score_packed_reference(packed, flags, lut, mins)
            # a few scores past the last bin, which the contract drops
            over = torch.rand(s.shape, device=s.device, generator=gen) < 0.005
            s = s.masked_fill_(over, hist_size + 7).contiguous()
            got = exact_hist(s, hist_size)
            want = exact_hist_reference(s, hist_size)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if err or not torch.equal(got, want):
                raise RuntimeError(f"exact_hist != plain at n={n} k={k} "
                                   f"M={m}: max err {err}")
            ms = _time_ms(torch, lambda: exact_hist(s, hist_size))
            plain_ms = _time_ms(torch,
                                lambda: exact_hist_reference(s, hist_size))
            log(f"exact_hist vs plain [(n, M) = ({n}, {m}), k={k}, "
                f"{hist_size} bins]: bit-identical, kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms (median of 10, CUDA events)")
            out.append({"label": f"k={k} M={m}", "ms": ms,
                        "plain_ms": plain_ms, "max_abs_err": err})
            del packed, flags, lut, mins, s, over, got, want
    torch.cuda.empty_cache()
    return out


PEAKS = 1000  # a ChIP-seq peak set on one chromosome
PEAK_BP = 500


def _sorted_report(tsv: bytes):
    """A TSV report in the order ``tests/test_multi_motif.py:113-120``
    sorts both engines' reports before comparing them."""
    import pandas as pd

    return (
        pd.read_csv(io.BytesIO(tsv), sep="\t", index_col=0)
        .sort_values(["sequence_name", "p-value", "start", "stop", "strand",
                      "matched_sequence"])
        .reset_index(drop=True)
    )


def phase_window_engine(torch, wd, gdir, synth):
    import numpy as np
    import pandas as pd

    from grafimo_tpu_torch.ops import hist, scan_packed

    rng = np.random.default_rng(SEED + 4)
    span = synth["length"] // PEAKS
    starts = np.arange(PEAKS) * span + rng.integers(0, span - PEAK_BP, PEAKS)
    bed = os.path.join(wd, "peaks.bed")
    with open(bed, "w") as f:
        for s in starts.tolist():
            f.write(f"chr21\t{s}\t{s + PEAK_BP}\n")
    in_pockets = sum(
        any(lo <= s < hi for lo, hi in synth["pockets"]) for s in starts
    )
    log(f"peak set: {PEAKS} regions of {PEAK_BP} bp, {in_pockets} in dense "
        f"pockets")

    def run(engine, dev):
        outdir = os.path.join(wd, f"out_peaks_{engine}_{dev}")
        text, dt = _findmotif([
            "findmotif", "-d", gdir, "-b", bed, "-m", MOTIF, "-t", "1e-4",
            "-o", outdir, "--verbose", "--device", dev, "--engine", engine,
        ])
        return text, dt, _report(outdir)

    torch.cuda.reset_peak_memory_stats()
    hist.reset_counts()
    scan_packed.reset_counts()
    text, wall, (tsv_cuda, n_hits) = run("windows", "cuda")
    launches = {"scan_packed": dict(scan_packed.COUNTS),
                "exact_hist": dict(hist.COUNTS)}
    for name, c in launches.items():
        if c["kernel"] <= 0 or c["plain"] != 0:
            raise RuntimeError(f"window engine did not run on the {name} "
                               f"kernel: {c}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m_ext = re.search(r"extracted (\d+) candidate windows in ([\d.]+)s", text)
    m_scan = re.search(r"(\d+) window rows scored in ([\d.]+)s", text)
    if m_ext is None or m_scan is None:
        raise RuntimeError("findmotif --engine windows printed no "
                           "extraction or scan summary")
    rows, scan_s = int(m_scan.group(1)), float(m_scan.group(2))
    log(f"window engine on cuda: {rows} window rows ({rows // 2} "
        f"windows/strand), extraction {float(m_ext.group(2)):.2f}s, "
        f"scan {scan_s:.3f}s, wall {wall:.2f}s, {n_hits} hits (p < 1e-4), "
        f"{rows / 2 / scan_s:.0f} windows/strand/s over the scan, scan "
        f"share of wall {scan_s / wall:.4f}, peak device memory "
        f"{peak_gib:.3f} GiB; launches {launches}")

    _, wall_cpu, (tsv_cpu, _) = run("windows", "cpu")
    if tsv_cpu != tsv_cuda:
        raise RuntimeError("window engine: cuda and cpu TSVs differ")
    log(f"window engine on cpu: wall {wall_cpu:.2f}s; cuda TSV "
        f"byte-identical to cpu TSV")

    _, wall_runs, (tsv_runs, n_runs_hits) = run("runs", "cuda")
    pd.testing.assert_frame_equal(_sorted_report(tsv_runs),
                                  _sorted_report(tsv_cuda), check_exact=True)
    log(f"run engine on cuda: {n_runs_hits} hits, wall {wall_runs:.2f}s; "
        f"report equal to the window engine's when sorted")
    return launches["scan_packed"]["kernel"]


def main() -> int:
    sys.modules["jax"] = None  # the port must run without JAX
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device; nothing "
                         "to test\n")
        return 1
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    phase_environment(torch)
    phase_build()
    cases = phase_kernel_vs_plain(torch)
    phase_cuda_vs_cpu(torch)
    with tempfile.TemporaryDirectory(prefix="grafimo_smoke_") as wd:
        launches, gdir, synth = phase_main_path(torch, wd)
        scan_cases = phase_scan_packed_vs_plain(torch)
        cases += phase_hist_variants(torch)
        scan_launches = phase_window_engine(torch, wd, gdir, synth)
    main_case, scan_case = cases[0], scan_cases[0]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [{
        "name": "exact_hist",
        "route": "cuda",
        "source": "grafimo_tpu_torch/csrc/hist.cu",
        "replaces": "grafimo_tpu/ops/pallas_hist.py:90",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }, {
        "name": "scan_packed",
        "route": "cuda",
        "source": "grafimo_tpu_torch/csrc/scan_packed.cu",
        "replaces": "grafimo_tpu/ops/pallas_scan.py:74",
        "launches": scan_launches,
        "max_abs_err": max(c["max_abs_err"] for c in scan_cases),
        "ms": scan_case["ms"],
        "plain_ms": scan_case["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
