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
   card and on the CPU, whose reports must be byte-identical.

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
                            "compute backend")):
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
    return launches["kernel"]


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
        launches = phase_main_path(torch, wd)
    main_case = cases[0]
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
