#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``grafimo_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order (phases 14 and 15 run right after phase 5, whose
chromosome they need, before any phase that profiles); any failure
raises and the script exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit,
   pandas, and the port's C++ engine (built with g++ on first use);
2. build: the CUDA kernels, compiled with nvcc for sm_90a;
3. the exact-histogram kernel against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes (and past the TPU
   kernel's 16-column cap in column groups, and on its cluster path for
   bins past one block), and -- after phase
   5 -- on real CTCF scores of phase 5's chromosome (the peaked case);
4. ``scan_batches`` over a seeded mix of all five batch kinds on the card
   and on the CPU: identical histograms and hits, one fused launch a
   block on the card, the plain version on the CPU;
5. the main path at chromosome scale: a synthetic chromosome at the
   1KGP profile (``grafimo_tpu_torch/utils/synth.py``), ``buildvg``, then
   a whole-chromosome CTCF ``findmotif`` through the port's CLI on the
   card, which must make exactly one fused ``scan_runs.cu`` launch a
   slice block and no other scoring, counting or compaction launch and
   no plain version; then a 1 Mbp region around the first dense pocket on
   the card and on the CPU, whose reports must be byte-identical;
6. the packed-window kernel against its plain versions on the card, bit
   for bit: scores only, at the window engine's chunk shape and around it
   (fwd + RC columns, k = 8 and 30, M = 16, N and PAD rows, a ragged B,
   LUT entries at 1020); then fused with the histogram, scores and the
   int64 running histogram over two accumulating calls, at the window
   engine's region batch (B = 2,653, CTCF), at 2^18, at a ragged B, at
   M = 16 and at k = 70;
7. the exact-histogram kernel against its plain version over the range
   of the TPU's histogram variants (native ``(n, M)`` layout, n not a
   tile multiple, k in {8, 19, 32}, M in {1, 3, 16}), in column groups
   (M = 40) and on its cluster path (k = 70), and at the window engine's
   region batch;
8. the per-window engine (``findmotif --engine windows``) on phase 5's
   graph over a seeded set of 500 peak-sized regions: on the card,
   where it must launch the fused kernel once per region, and neither a
   plain version nor a separate histogram, then on the CPU, whose report
   must be byte-identical, then the run engine on the card (one fused
   launch a slice block), whose report must hold the same rows;
9. the run engine split over a device list at phase 5's size:
   ``scan_batches`` on one device and on two shards of cuda:0 (and on
   every card when there are several), identical histograms and hits,
   then ``findmotif`` on two shards, whose TSV and GFF3 must be phase 5's
   byte for byte;
10. ``parallel/pipeline.py``'s grid functions on a (4, 2) grid over
    cuda:0 at the run engine's shape (B = 2048 and 2045 rows, R = 2048,
    CTCF k = 19, M = 2), bit for bit against the single-device kinds and
    ``score_hist_core``;
11. two processes on cuda:0 (gloo over localhost, each a fresh
    interpreter with jax and ``grafimo_tpu`` blocked): the peak set and a
    one-region BED (rank 1 scans nothing); rank 0's reports must be the
    one-process ones byte for byte;
12. ``--profile``: the trace exists and names the fused scoring kernel
    and none of the three-launch route's kernels; the report is
    unchanged;
13. the run engine's device half: the hit-compaction kernel against its
    plain version at the run engine's slice shapes of real CTCF scores of
    phase 5's chromosome, with no hits, sparse hits (p < 1e-4, in the
    flush read's and in the block's own index tier), past the index
    capacity (p < 1e-3) and dense (``-t 1``): counts exact, indices equal
    once sorted, hit bits equal, and for the block's own index tier the
    host's read of those indices against a read of its packed bits; the
    histogram kernel against its plain
    version at compressed bin counts (each column's reachable scores) for
    k in {8, 19, 70} and M in {2, 16, 40}, and on phase 3's peaked plane;
    ``multi.meme`` (widths 19, 8, 12) on phase 5's pocket region, cuda
    reports byte-identical to cpu ones; the histogram kernel's remap on
    load (``bases``) at the same compressed bin counts;
14. the run engine's scoring core, ``csrc/scan_runs.cu``, against its
    plain version, bit for bit, for all five batch kinds: the main path's
    block (8192 rows of R = 2048 of phase 5's chromosome with seeded N
    runs, real CTCF forward and reverse complement), R = 64 and 256 with
    4-slot patches, k in {8, 30, 70}, M in {16, 40}, a clean block, LUT
    entries at 1020 and a LUT tiled over columns; empty, full and
    repeated patch slots, negative splice shifts, an unused pair before a
    used one, a patch over an N base, an all-invalid row.  The
    ``conv1d`` yardstick (TF32 off) equals each once masked;
15. the run engine's slice-block entry, ``scan_block`` (the fused
    ``scan_runs.cu`` launch that scores, counts and compacts), against
    its plain version, bit for bit (histogram, count and hit bits exact,
    indices equal once sorted): all five kinds at the main path's block,
    the hit tiers (flush read, the block's indices, past the index
    capacity at p < 1e-3, dense at ``-t 1``), M = 16 and 40 in column
    groups, both sides of the bin count at which a column stops fitting
    one block, k = 70 on the route the plan gives it, and the 800-PWM
    ladder's blocks (``synth_meme``, seed 0: every motif of the
    narrowest, the modal and the widest width, p < 1e-6, at the rows
    ``runscan.slice_rows`` gives them; the plain version in row ranges);
    beside each, the three launches it replaces, timed in the same call;
16. the three-launch route end to end: a 70-wide motif whose bins
    outgrow one block on 100 kbp of phase 5's chromosome, one unfused
    ``scan_runs.cu``, one ``hist.cu`` (on a cluster) and one
    ``compact.cu`` launch a slice block and no fused launch on the card,
    the cuda TSV and GFF3 byte-identical to the cpu ones;
17. many motifs: ``synth_meme``'s 800 PWMs (BASELINE config 5, seed 0)
    through ``findmotif --text-only`` over phase 5's pocket region on the
    card, 22 widths, one fused launch a slice block, the three launches
    only where the plan gives them; its narrowest, a modal-width and its
    widest motif, each alone in its width's pass, on the card and on the
    CPU, each report's rows byte-identical to the ladder's; then 24
    small per-chromosome graphs (BASELINE config 4) through ``findmotif
    -d`` with two widths, the cuda TSV and GFF3 byte-identical to the
    cpu ones;
18. the reference's headline workload shape (BASELINE config 1): CTCF
    over ``tools/bench_chrom_scale.py``'s ENCODE-shaped BED, 3,000
    peaks of 270 bp from seed 7, on phase 5's graph through
    ``findmotif``, on the card (one fused launch a slice block and
    nothing else) and on the CPU, TSV and GFF3 byte-identical; then the
    same regions scanned on the card in this process and their hits
    assembled twice, by ``runscan._assemble_columns`` and with every
    backbone hit read off its region's whole backbone run, the route
    ``assemble.backbone_hits`` replaced (``_route_columns``), the report
    columns equal and both times printed.

Phase 5's whole-chromosome run and phase 9's scans also check the
device->host reads (``runscan.READS``): one per device and flush block of
slices, one per block denser than the flush read's index tier, and one
histogram read per device, never one per slice.  Phases 4, 5, 8, 9, 10,
11, 12 and 18 check the launches: one fused ``scan_runs.cu`` launch a
slice block on the run engine's paths, no unfused scoring, no ``hist.cu`` or
``compact.cu`` launch and no plain version there (``hist.cu`` and
``compact.cu`` are held in phases 3, 7 and 13, and beside each case of
phase 15); phase 17 counts every route's launches and wants the fused
kernel, the three launches only where the plan gives them.

Each kernel case prints its time as the median of 10 single launches and
as the mean of 100 back-to-back launches (CUDA events), its device time
per launch (``torch.profiler``), the plain version's time, the time of
one PyTorch call computing the same function where there is one
(``torch.bincount`` for the histogram, ``torch.nonzero`` of the hit
predicate for the compaction, ``conv1d`` of the one-hot rows or
windows for the scoring cores; none scores, counts and compacts a slice
block in one call), and its bound: the bytes the function must move
over the card's 3.35 TB/s, or its int32 adds over 16.75 T/s (a quarter of the
67 TFLOP/s float32 rate: an SM issues 64 int32 adds a clock against 128
float32 FMAs) where those take longer.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device the script exits 1 before any phase.  It imports
nothing of JAX or the reference package ``grafimo_tpu``: both are
blocked from import in this process and in the ones it starts.
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
BLOCK_JAX = ("import sys; "
             "sys.modules['jax'] = sys.modules['grafimo_tpu'] = None\n")
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory rate
# the JASPAR-CORE-scale ladder (BASELINE config 5): synth_meme's PWMs,
# seed 0, and tools/bench_jaspar_ladder.py's threshold
LADDER_MOTIFS = 800
LADDER_T = 1e-6

# inputs at the 1KGP profile, written by the port's copy of the
# benchmark tool's generators (1/30 bp variants, 12% indels, 3 dense
# pockets)
SYNTH_PROG = BLOCK_JAX + r"""
import json, os, numpy as np
from grafimo_tpu_torch.utils import synth as bcs
wd, mbp, seed, hap = sys.argv[1:5]
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
    """Median of ``reps`` single calls, CUDA events around each."""
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


def _back_to_back_ms(torch, fn, reps=100):
    """Mean of ``reps`` calls issued back to back, CUDA events around the
    run."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(torch, fn, kernel, reps=20, per_call=False):
    """Device time of one launch of the CUDA kernel named ``kernel``, or,
    with ``per_call``, of all the launches of the kernels named in the
    tuple ``kernel`` that one call of ``fn`` makes, from ``torch.profiler``
    over ``reps`` calls; None when the profiler shows no device time for
    them."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 -- reported as not measured
        log(f"    profiler failed ({e}); device time not measured")
        return None
    total = count = 0
    for evt in prof.key_averages():
        if any(name in evt.key for name in names):
            total += getattr(evt, "device_time_total", None) or getattr(
                evt, "cuda_time_total", 0)
            count += evt.count
    if not (count and total):
        return None
    return total / (reps if per_call else count) / 1e3


def _timings(torch, fn, kernel, plain=None, library=None,
             reps=(10, 100, 20)):
    """A kernel case's times in ms: ``ms`` (median of 10 single launches),
    ``ms_back_to_back`` (mean of 100), ``device_ms`` (profiler, 20),
    ``plain_ms`` and ``library_ms`` (median of 10 single calls); a large
    case passes fewer ``reps`` (single calls, back to back, profiled)."""
    return {
        "ms": _time_ms(torch, fn, reps[0]),
        "ms_back_to_back": _back_to_back_ms(torch, fn, reps[1]),
        "device_ms": _device_ms(torch, fn, kernel, reps[2]),
        "plain_ms": _time_ms(torch, plain, reps[0]) if plain else None,
        "library_ms": _time_ms(torch, library, reps[0]) if library else None,
    }


def _fmt(t, bound_ms, library="torch.bincount"):
    def f(x):
        return "n/a" if x is None else f"{x:.4f}"

    return (f"kernel {f(t['ms'])} ms single, {f(t['ms_back_to_back'])} ms "
            f"back to back, device {f(t['device_ms'])} ms; plain "
            f"{f(t['plain_ms'])} ms; {library} {f(t['library_ms'])} ms; "
            f"bound {bound_ms:.5f} ms")


def _bincount_call(torch, s, hist_size):
    """One ``torch.bincount`` over the precomputed ``value * M + column``
    of the in-range scores: the PyTorch call that counts what exact_hist
    counts, timed alone."""
    m = s.shape[-1]
    flat = s.reshape(-1, m)
    keep = (flat >= 0) & (flat < hist_size)
    cols = torch.arange(m, device=s.device).expand_as(flat)
    idx = (flat.to(torch.int64) * m + cols)[keep]
    return lambda: torch.bincount(idx, minlength=hist_size * m)


def _hist_bound_ms(s, hist_size):
    """The histogram must read the score plane once and write its bins
    once."""
    m = s.shape[-1]
    return (s.numel() * 4 + hist_size * m * 4) / HBM_BYTES_PER_S * 1e3


def _check_hist_case(torch, label, s, hist_size, bases=None):
    """Kernel vs plain, bit for bit, then the case's timings; ``bases``:
    the kernel's remap on load (``torch.bincount`` then counts the
    remapped plane)."""
    from grafimo_tpu_torch.ops import hist

    got = hist.exact_hist(s, hist_size, bases)
    want = hist.exact_hist_reference(s, hist_size, bases)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err or not torch.equal(got, want):
        raise RuntimeError(f"kernel != plain at {label}: max err {err}")
    del got, want
    t = _timings(torch, lambda: hist.exact_hist(s, hist_size, bases),
                 "exact_hist_kernel",
                 plain=lambda: hist.exact_hist_reference(s, hist_size, bases),
                 library=_bincount_call(
                     torch, s if bases is None else hist.remap(s, bases),
                     hist_size))
    bound = _hist_bound_ms(s, hist_size)
    log(f"exact_hist vs plain [{label}] shape {tuple(s.shape)} bins "
        f"{hist_size}: bit-identical, max_abs_err 0; {_fmt(t, bound)}")
    return dict(t, label=label, max_abs_err=err, bound_ms=bound)


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
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = r = 2048
    cases = [  # (label, k, M); hist_size = 1000*k + 2 (remapped bins)
        ("main path B=R=2048 k=19 M=2", 19, 2),
        ("M=16 (TPU kernel cap; column groups)", 19, 16),
        ("M=40 (past the TPU cap; column groups)", 19, 40),
        ("k=30", 30, 2),
        ("k=70 (cluster path)", 70, 2),
    ]
    out = []
    for label, k, m in cases:
        hist_size = 1000 * k + 2
        s = _main_path_scores(torch, rows, r, k, m, gen)
        out.append(_check_hist_case(torch, label, s, hist_size))
        del s
    torch.cuda.empty_cache()
    return out


def _ctcf_lut(torch, fwd_rc=True):
    """CTCF (MA0139.1, the smoke's motif) as the port's LUT on the card:
    forward and reverse-complement columns, or forward only."""
    import numpy as np

    from grafimo_tpu_torch.models.parse import load_motifs
    from grafimo_tpu_torch.ops.score_runs import (
        pwm_lut_from_kernel,
        pwms_to_conv_kernel,
        reverse_complement_pwm,
    )
    from grafimo_tpu_torch.utils.constants import UNIF

    ctcf = load_motifs(MOTIF, UNIF, 0.1, False)[0]
    mats = [ctcf.score_matrix]
    if fwd_rc:
        mats.append(reverse_complement_pwm(ctcf.score_matrix))
    lut = pwm_lut_from_kernel(pwms_to_conv_kernel(mats), torch.device("cuda"))
    mins = np.array([ctcf.min_score] * len(mats), np.int32)
    return ctcf, lut, torch.from_numpy(mins).cuda()


def _chrom_codes(wd, n):
    """``n`` base codes (A=0..T=3) from the middle of phase 5's synthetic
    chromosome."""
    import numpy as np

    with open(os.path.join(wd, "ref.fa"), "rb") as f:
        f.readline()
        text = f.read().replace(b"\n", b"")
    lo = (len(text) - n) // 2
    table = np.zeros(256, np.uint8)
    table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return table[np.frombuffer(text[lo : lo + n], np.uint8)]


def phase_peaked_hist(torch, wd):
    """Phase 3's peaked case: the main path's (2048, 2030, 2) plane of
    real CTCF scores (forward and reverse complement) over 2048 rows of
    2048 bases of phase 5's chromosome, + 1 (the remap).  Real scores
    pile up on a few hundred bins, which is where atomics collide."""
    from grafimo_tpu_torch.ops.score_runs import _window_scores

    rows = r = 2048
    ctcf, lut, _ = _ctcf_lut(torch)
    codes = torch.from_numpy(_chrom_codes(wd, rows * r).reshape(rows, r))
    s = (_window_scores(codes.cuda().long(), lut, ctcf.width) + 1).contiguous()
    hist_size = 1000 * ctcf.width + 2
    busy = int((torch.bincount(s.flatten()) > 0).sum())
    log(f"peaked case: {s.numel()} CTCF scores over {busy} distinct bins")
    case = _check_hist_case(torch, "peaked: real CTCF scores, main path "
                            "B=R=2048 k=19 M=2", s, hist_size)
    del s
    torch.cuda.empty_cache()
    return case


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
    from grafimo_tpu_torch.ops import score_runs as sr

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
    scans = {}
    for dev in ("cuda", "cpu"):
        batches = _mix(rb, graph, np.random.default_rng(SEED + 1), k)
        sr.reset_counts()
        t0 = time.perf_counter()
        res = rb.scan_batches(batches, pwm, mins, cuts, k, 1000 * k + 1,
                              torch.device(dev))
        results[dev] = (res, time.perf_counter() - t0)
        scans[dev] = dict(sr.COUNTS)
    if (scans["cuda"] != {"kernel": 0, "fused": len(batches), "plain": 0}
            or scans["cpu"] != {"kernel": 0, "fused": 0,
                                "plain": len(batches)}):
        raise RuntimeError(f"five-kind mix: scan_runs counts {scans}, want "
                           f"one fused launch a block on cuda and the plain "
                           f"version on cpu")
    (gc, tc), (cc, tcpu) = results["cuda"], results["cpu"]
    if not np.array_equal(gc.hists, cc.hists):
        raise RuntimeError("port cuda != port cpu: histograms differ")
    if sorted(gc.hits) != sorted(cc.hits):
        raise RuntimeError("port cuda != port cpu: hits differ")
    if not len(gc.hits) or gc.hists.sum() == 0:
        raise RuntimeError("five-kind mix produced no windows or no hits")
    log(f"five-kind mix: port cuda == port cpu ({int(gc.hists.sum())} "
        f"window-strands, {len(gc.hits)} hits; cuda {tc:.2f}s, "
        f"cpu {tcpu:.2f}s host wall; {scans['cuda']['fused']} fused "
        f"scan_runs.cu launches on cuda, the plain version on cpu)")


def _findmotif(argv, echo=True):
    """The port's CLI in this process, its stdout captured and (its
    summary lines) echoed."""
    from grafimo_tpu_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines() if echo else ():
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


def _check_reads(label, reads, flush_blocks, n_devices):
    """The scan's device->host reads: one per device and flush block, one
    per block denser than the flush read's index tier, one histogram read
    per device."""
    want = flush_blocks * n_devices
    if reads["flush"] != want or reads["hist"] != n_devices:
        raise RuntimeError(f"{label}: reads {reads}, want {want} flush reads "
                           f"and {n_devices} histogram reads")
    return (f"device->host reads {sum(reads.values())} ({reads['flush']} "
            f"flush for {flush_blocks} flush block(s) x {n_devices} "
            f"device(s), {reads['indices']} index, {reads['bits']} hit-bit "
            f"and {reads['hist']} histogram reads)")


def _slicing(batches, devices):
    """``(slices, flush reads a device, non-empty blocks)`` of CTCF's scan
    of ``batches`` on ``devices``, by ``runscan.plan_slices``: each
    slice's rows split into one contiguous block a device."""
    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch.device import split_rows

    kernel, _, _, k, _ = _ctcf_scan_inputs()
    plan = rb.plan_slices(batches, k, kernel.shape[-1],
                          rb.hist_layout(kernel)[2], devices)
    blocks = sum(b0 != b1 for _, lo, hi, _ in plan
                 for b0, b1 in split_rows(hi - lo, len(devices)))
    return len(plan), sum(flush for *_, flush in plan), blocks


def _one_fused_launch_a_block(what, blocks=None):
    """The run engine's launches since the counts were last reset: one
    fused scan_runs.cu launch a slice block (``blocks`` of them when
    given), and no unfused scoring, ``hist.cu``, ``compact.cu`` or plain
    version."""
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr

    fused = sr.COUNTS["fused"]
    if (fused <= 0 or (blocks is not None and fused != blocks)
            or sr.COUNTS["kernel"] or sr.COUNTS["plain"]
            or hist.COUNTS != {"kernel": 0, "plain": 0}
            or compact.COUNTS != {"kernel": 0, "plain": 0}):
        raise RuntimeError(
            f"{what}: scan_runs {dict(sr.COUNTS)}, hist {dict(hist.COUNTS)}, "
            f"compact {dict(compact.COUNTS)}; want one fused launch a slice "
            f"block" + (f" ({blocks})" if blocks is not None else "")
            + " and nothing else")
    return fused


def phase_main_path(torch, wd):
    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr
    from grafimo_tpu_torch.workflows import load_graph_file

    out, dt = run_checked(
        [sys.executable, "-c", SYNTH_PROG, wd, str(SMOKE_MBP),
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
    sr.reset_counts()
    hist.reset_counts()
    compact.reset_counts()
    rb.reset_reads()
    torch.cuda.reset_peak_memory_stats()
    text, wall = _findmotif([
        "findmotif", "-d", gdir, "-b", whole, "-m", MOTIF, "-t", "1e-4",
        "-o", os.path.join(wd, "out_whole"), "--verbose", "--device", "cuda",
    ])
    scans = dict(sr.COUNTS)
    launches = dict(hist.COUNTS)
    compactions = dict(compact.COUNTS)
    reads = dict(rb.READS)
    graph = load_graph_file(os.path.join(gdir, "21.gvt.npz"))
    batches = rb.batch_runs(rb.build_region_runs(
        graph, "21", [(0, synth["length"])], 19), 19)
    slices, flushes, _ = _slicing(batches, [torch.device("cuda", 0)])
    _one_fused_launch_a_block("whole-chromosome findmotif", slices)
    read_line = _check_reads("whole-chromosome findmotif", reads, flushes, 1)
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
        f"(whole smoke process), peak device memory of the run "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"fused scan_runs.cu launches {scans['fused']} (unfused "
        f"{scans['kernel']}, plain {scans['plain']}); hist.cu launches "
        f"{launches['kernel']}, compact.cu {compactions['kernel']}; {slices} "
        f"slices, {read_line}; mismatch guard passed")

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
    return scans["fused"], gdir, synth, batches


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


def _scan_bound_ms(b, k, m, out_bytes=None):
    """Scoring must read each row's ceil(k/4) bytes and flag, the LUT and
    minima once, and write the (B, M) int32 scores once."""
    from grafimo_tpu_torch.ops.pack import packed_width

    nbytes = b * (packed_width(k) + 1) + k * 4 * m * 4 + m * 4 + b * m * 4
    return (nbytes + (out_bytes or 0)) / HBM_BYTES_PER_S * 1e3


def _window_conv1d(torch, packed, flags, lut, mins, scores):
    """The ``conv1d`` yardstick of the packed-window scoring: the one-hot
    windows ``(B, 4, k)`` (built outside the timed call) against the LUT
    as ``(M, 4, k)`` weights, TF32 off; checked equal to ``scores`` once
    the N and PAD rows are masked.  Returns the call to time."""
    import torch.nn.functional as F

    from grafimo_tpu_torch.ops.pack import FLAG_N, FLAG_PAD

    b, k = packed.shape[0], lut.shape[0]
    shifts = torch.arange(4, device=packed.device) * 2
    codes = ((packed.to(torch.int64)[:, :, None] >> shifts) & 3).reshape(
        b, -1)[:, :k]
    onehot = F.one_hot(codes, 4).permute(0, 2, 1).float().contiguous()
    weight = lut.permute(2, 1, 0).float().contiguous()

    def conv():
        return F.conv1d(onehot, weight)

    raw = conv()[:, :, 0].round().to(torch.int32)
    f = flags.to(torch.int64)[:, None]
    raw = torch.where(f == FLAG_N, mins[None, :], raw)
    raw = torch.where(f == FLAG_PAD, torch.full_like(raw, -1), raw)
    if not torch.equal(raw, scores):
        raise RuntimeError("conv1d yardstick != scan_packed scores")
    return conv


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
        ("k=60 M=300 (LUT in column groups)", 5000, 60, 300, 0.01, 1001),
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
        torch.backends.cudnn.allow_tf32 = False
        try:
            t = _timings(
                torch, lambda: score_packed(packed, flags, lut, mins),
                "scan_packed_kernel",
                plain=lambda: score_packed_reference(packed, flags, lut,
                                                     mins),
                library=_window_conv1d(torch, packed, flags, lut, mins, got))
        finally:
            torch.backends.cudnn.allow_tf32 = True
        bound = _scan_bound_ms(b, k, m)
        log(f"score_packed vs plain [{label}] packed {tuple(packed.shape)} "
            f"M={m}: bit-identical, max_abs_err 0, conv1d equal; "
            f"{_fmt(t, bound, 'conv1d')}")
        out.append(dict(t, label=label, max_abs_err=err, bound_ms=bound))
        del packed, flags, lut, mins, got, want
    torch.cuda.empty_cache()
    return out


def _fused_case(torch, label, calls, lut, mins, hist_size):
    """The fused kernel against its plain composition on each of ``calls``
    (``(packed, flags)`` pairs) in turn, accumulating into one int64
    histogram each: scores and the running histogram bit for bit after
    every call; then the timings of the first call's shape."""
    from grafimo_tpu_torch.ops import scan_packed as sp

    m = lut.shape[2]
    hist = torch.zeros((hist_size, m), dtype=torch.int64, device="cuda")
    want_hist = torch.zeros_like(hist)
    touched = None
    for packed, flags in calls:
        got = sp.score_packed_hist(packed, flags, lut, mins, hist)
        want = sp.score_packed_hist_reference(packed, flags, lut, mins,
                                              want_hist)
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max()),
                  int((hist - want_hist).abs().max()))
        if err or not (torch.equal(got, want)
                       and torch.equal(hist, want_hist)):
            raise RuntimeError(f"fused score+count != plain at {label}: max "
                               f"err {err}")
        if touched is None:
            # the bins the first call's counts touch, each read and
            # written once (int64)
            touched = int((want_hist > 0).sum())
    if int(hist.sum()) <= 0:
        raise RuntimeError(f"{label}: nothing counted")
    packed, flags = calls[0]
    bound = _scan_bound_ms(packed.shape[0], lut.shape[0], m,
                           out_bytes=touched * 16)
    torch.backends.cudnn.allow_tf32 = False
    try:
        t = _timings(
            torch,
            lambda: sp.score_packed_hist(packed, flags, lut, mins, hist),
            "scan_packed_kernel",
            plain=lambda: sp.score_packed_hist_reference(packed, flags, lut,
                                                         mins, want_hist),
            library=_window_conv1d(torch, packed, flags, lut, mins,
                                   sp.score_packed(packed, flags, lut, mins)))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    log(f"fused score+count vs plain [{label}] {len(calls)} calls, first "
        f"packed {tuple(packed.shape)}, M={m}, {hist_size} bins: scores and "
        f"int64 histogram bit-identical; {_fmt(t, bound, 'conv1d (scores)')}")
    return dict(t, label=label, max_abs_err=err, bound_ms=bound)


def phase_fused_vs_plain(torch):
    """Phase 6's fused cases: score and count into an int64 running
    histogram, against the plain composition (scores, clamp, bincount,
    add), over two accumulating calls each."""
    import numpy as np

    from grafimo_tpu_torch.ops.pack import pack_codes
    from grafimo_tpu_torch.ops.score_runs import hist_size_for_width
    from grafimo_tpu_torch.scan import CHUNK

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    out = []
    # the window engine's region batch: 2,653 rows (1,326,515 windows per
    # strand over 1,000 peaks), CTCF forward column, N and PAD rows
    ctcf, lut, mins = _ctcf_lut(torch, fwd_rc=False)
    calls = []
    for b in (WINDOW_BATCH, WINDOW_BATCH - 101):
        codes = rng.integers(0, 4, (b, ctcf.width)).astype(np.uint8)
        codes[rng.random(b) < 0.01, 3] = 4  # N windows
        codes[-3:] = 5  # padding rows
        packed, flags = pack_codes(codes)
        calls.append((torch.from_numpy(packed).cuda(),
                      torch.from_numpy(flags).cuda()))
    out.append(_fused_case(torch, f"window path B={WINDOW_BATCH} CTCF k=19 "
                           f"M=1", calls, lut, mins,
                           hist_size_for_width(ctcf.width)))
    cases = [  # (label, B of the two calls, k, M, LUT bound)
        ("B=2^18 k=19 M=1", (CHUNK, CHUNK), 19, 1, 1001),
        ("ragged B, k=19 M=2, LUT at 1020", (CHUNK - 7, 1001), 19, 2, 1021),
        ("M=16 (column groups)", (20000, 333), 19, 16, 1001),
        ("k=70 (cluster)", (20000, 333), 70, 1, 1001),
    ]
    for label, sizes, k, m, high in cases:
        lut = mins = None
        calls = []
        for b in sizes:
            packed, flags, lut_b, mins_b = _random_packed(
                torch, b, k, m, gen, 0.01, high)
            if lut is None:
                lut, mins = lut_b, mins_b
                if high > 1001:
                    lut[:, :, 0] = 1020
            calls.append((packed, flags))
        out.append(_fused_case(torch, label, calls, lut, mins,
                               hist_size_for_width(k)))
        del calls, lut, mins
    torch.cuda.empty_cache()
    return out


def phase_hist_variants(torch):
    """Kernels 2-4 of the TPU's histogram share kernel 1's contract; the
    one CUDA kernel is held to it over their parameter range, on the
    window path's native (n, M) score layout, and on its cluster path."""
    from grafimo_tpu_torch.ops.scan_packed import score_packed_reference
    from grafimo_tpu_torch.ops.score_windows import hist_size_for_width

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    out = []
    # the window engine's region batch, as it was counted before the fused
    # kernel took the count in
    _, lut, mins = _ctcf_lut(torch, fwd_rc=False)
    packed, flags, _, _ = _random_packed(torch, WINDOW_BATCH, 19, 1, gen, 0.01)
    s = score_packed_reference(packed, flags, lut, mins).clamp(
        max=hist_size_for_width(19) - 1)
    out.append(_check_hist_case(torch, f"window shape ({WINDOW_BATCH}, 1), "
                                f"CTCF k=19", s, hist_size_for_width(19)))
    n = (1 << 18) + 123
    for k, m in [(k, m) for k in (8, 19, 32) for m in (1, 3, 16)] + [
            (70, 1), (70, 3), (19, 40)]:
        hist_size = hist_size_for_width(k)
        packed, flags, lut, mins = _random_packed(torch, n, k, m, gen, 0.01)
        s = score_packed_reference(packed, flags, lut, mins)
        # a few scores past the last bin, which the contract drops
        over = torch.rand(s.shape, device=s.device, generator=gen) < 0.005
        s = s.masked_fill_(over, hist_size + 7).contiguous()
        block = 58112  # bins one block holds on an H100
        path = (" (cluster)" if hist_size > block
                else " (column groups)" if m * hist_size > block else "")
        out.append(_check_hist_case(torch, f"(n, M) = ({n}, {m}), k={k}"
                                    f"{path}", s, hist_size))
        del packed, flags, lut, mins, s, over
    torch.cuda.empty_cache()
    return out


# a ChIP-seq peak set on one chromosome (1,000 until phase 17 came: the
# smoke's depth is cut here to keep it near half its time limit)
PEAKS = 500
PEAK_BP = 500
WINDOW_BATCH = 2653  # window rows of one peak (both strands), on average


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

    from grafimo_tpu_torch.ops import compact, hist, scan_packed
    from grafimo_tpu_torch.ops import score_runs as sr

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
    fused = launches["scan_packed"]
    if (fused["fused"] <= 0 or fused["kernel"] != fused["fused"]
            or fused["plain"] != 0):
        raise RuntimeError(f"window engine did not run on the fused "
                           f"kernel alone: {fused}")
    if launches["exact_hist"] != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"window engine ran a separate histogram: "
                           f"{launches['exact_hist']}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m_ext = re.search(r"extracted (\d+) candidate windows in ([\d.]+)s", text)
    m_scan = re.search(r"(\d+) window rows scored in ([\d.]+)s", text)
    if m_ext is None or m_scan is None:
        raise RuntimeError("findmotif --engine windows printed no "
                           "extraction or scan summary")
    rows, scan_s = int(m_scan.group(1)), float(m_scan.group(2))
    if fused["fused"] != PEAKS:
        raise RuntimeError(f"{fused['fused']} fused launches for {PEAKS} "
                           f"regions: want one per region")
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

    for counts in (sr, hist, compact):
        counts.reset_counts()
    _, wall_runs, (tsv_runs, n_runs_hits) = run("runs", "cuda")
    fused_runs = _one_fused_launch_a_block("run engine on the peak set")
    pd.testing.assert_frame_equal(_sorted_report(tsv_runs),
                                  _sorted_report(tsv_cuda), check_exact=True)
    log(f"run engine on cuda: {n_runs_hits} hits, wall {wall_runs:.2f}s, "
        f"fused scan_runs.cu launches {fused_runs}; report equal to the "
        f"window engine's when sorted")
    return launches["scan_packed"]["kernel"], fused_runs


def _ctcf_scan_inputs(threshold=1e-4):
    """The run engine's scan inputs for CTCF, as ``compute_results_runs``
    builds them: forward and reverse-complement columns, minimum scores,
    the p < ``threshold`` score cutoffs and the histogram size."""
    import numpy as np

    from grafimo_tpu_torch.models.parse import load_motifs
    from grafimo_tpu_torch.models.pvalue import PvalueLookup
    from grafimo_tpu_torch.ops.score_runs import (
        hist_size_for_width,
        pwms_to_conv_kernel,
        reverse_complement_pwm,
    )
    from grafimo_tpu_torch.utils.constants import UNIF

    ctcf = load_motifs(MOTIF, UNIF, 0.1, False)[0]
    kernel = pwms_to_conv_kernel(
        [ctcf.score_matrix, reverse_complement_pwm(ctcf.score_matrix)])
    mins = np.array([ctcf.min_score] * 2, np.int32)
    cut = PvalueLookup(ctcf.pval_table).score_cutoff(threshold)
    return (kernel, mins, np.array([cut] * 2, np.int32), ctcf.width,
            hist_size_for_width(ctcf.width))


def _entry_findmotif(argv, devices):
    """``workflows.findmotif`` on an explicit device list -- the library
    entry the CLI calls -- with the CLI's parsing, stdout captured."""
    from grafimo_tpu_torch.cli import args_to_workflow, get_parser
    from grafimo_tpu_torch.workflows import findmotif

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        findmotif(args_to_workflow(get_parser().parse_args(argv)), devices)
    return buf.getvalue(), time.perf_counter() - t0


def _same_report(a, b, what):
    for name in ("grafimo_out.tsv", "grafimo_out.gff"):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            if fa.read() != fb.read():
                raise RuntimeError(f"{what}: {name} differs")


def phase_multi_device(torch, wd, gdir, batches):
    """Phase 9: the run engine's scan split over a device list at phase
    5's size -- the chromosome's own batches through ``scan_batches`` on
    one device and on two shards of the same card (and on every card when
    there are more), then the whole ``findmotif`` on two shards, whose
    report must be phase 5's byte for byte."""
    import numpy as np

    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr

    params = _ctcf_scan_inputs()
    one = [torch.device("cuda", 0)]
    configs = {"1 shard": one, "2 shards on cuda:0": one * 2}
    if torch.cuda.device_count() > 1:
        configs[f"{torch.cuda.device_count()} cards"] = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    order = ["1 shard", "2 shards on cuda:0", "2 shards on cuda:0",
             "1 shard"] + list(configs)[2:]
    seconds = {name: [] for name in configs}
    results = {}
    launches = {}
    reads = {}
    for name in order:
        sr.reset_counts()
        hist.reset_counts()
        compact.reset_counts()
        rb.reset_reads()
        res = rb.scan_batches(batches, *params, configs[name])
        seconds[name].append(res.scoring_time)
        devs = configs[name]
        _, flushes, blocks = _slicing(batches, devs)
        launches[name] = _one_fused_launch_a_block(
            f"10 Mbp scan on {name}", blocks)
        reads[name] = _check_reads(
            f"10 Mbp scan on {name}", dict(rb.READS), flushes,
            len({str(d) for d in devs}))
        results.setdefault(name, res)
    want = results["1 shard"]
    for name, res in results.items():
        if not np.array_equal(res.hists, want.hists):
            raise RuntimeError(f"10 Mbp scan on {name}: histograms differ")
        if sorted(res.hits) != sorted(want.hits):
            raise RuntimeError(f"10 Mbp scan on {name}: hits differ")
    log(f"{SMOKE_MBP} Mbp scan_batches, {len(batches)} batches, "
        f"{int(want.hists.sum())} window-strands, {len(want.hits)} hits: "
        + "; ".join(f"{name}: scan {', '.join(f'{t:.3f}' for t in ts)} s, "
                    f"{launches[name]} fused scan_runs.cu launches, "
                    f"{reads[name]}"
                    for name, ts in seconds.items())
        + "; histograms and hits identical")
    out = os.path.join(wd, "out_whole_2shards")
    sr.reset_counts()
    hist.reset_counts()
    compact.reset_counts()
    text, wall = _entry_findmotif([
        "findmotif", "-d", gdir, "-b", os.path.join(wd, "whole.bed"),
        "-m", MOTIF, "-t", "1e-4", "-o", out, "--verbose"], one * 2)
    entry_launches = _one_fused_launch_a_block("2-shard findmotif")
    _same_report(out, os.path.join(wd, "out_whole"), "2-shard findmotif")
    m = re.search(r"run scan: .*\(([\d.]+)s\)", text)
    log(f"whole-chromosome findmotif on 2 shards of cuda:0: scan "
        f"{m.group(1) if m else 'n/a'} s, wall {wall:.2f}s, fused "
        f"scan_runs.cu launches {entry_launches}; TSV and GFF3 "
        f"byte-identical to the 1-device run")
    return entry_launches


def phase_grid(torch):
    """Phase 10: ``parallel/pipeline.py``'s grid functions on a (4, 2)
    grid over cuda:0 at the run engine's shape, bit for bit against the
    single-device kinds and ``score_hist_core``."""
    import numpy as np

    from grafimo_tpu_torch.ops import compact, hist, scan_packed
    from grafimo_tpu_torch.ops import score_runs as sr
    from grafimo_tpu_torch.ops import score_windows as sw
    from grafimo_tpu_torch.parallel import pipeline as pp

    dev = torch.device("cuda", 0)
    grid = pp.make_mesh(4, 2, devices=[dev] * 8)
    kernel, mins, cuts, k, hs = _ctcf_scan_inputs()
    r = 2048
    noff = r - k + 1
    rng = np.random.default_rng(SEED + 6)
    genome = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    g4 = sr.bytes_to_words(np.concatenate(
        [sr.pack_run_seqs(genome[None, :])[0], np.zeros(r, np.uint8)]))
    gn = sr.bytes_to_words(np.concatenate(
        [sr.pack_bits((rng.random(len(genome)) < 0.001)[None, :])[0],
         np.zeros(r, np.uint8)]))
    lut = sr.pwm_lut_from_kernel(kernel, dev)
    t_mins, t_cuts = (torch.as_tensor(x, device=dev) for x in (mins, cuts))
    launches = {"exact_hist": 0, "scan_packed": 0, "compact_hits": 0,
                "scan_runs": 0, "scan_runs_fused": 0}

    def counted(fn, *args):
        hist.reset_counts()
        scan_packed.reset_counts()
        compact.reset_counts()
        sr.reset_counts()
        out = fn(*args)
        launches["exact_hist"] += hist.COUNTS["kernel"]
        launches["scan_packed"] += scan_packed.COUNTS["kernel"]
        launches["compact_hits"] += compact.COUNTS["kernel"]
        launches["scan_runs"] += sr.COUNTS["kernel"]
        launches["scan_runs_fused"] += sr.COUNTS["fused"]
        if (hist.COUNTS["plain"] or scan_packed.COUNTS["plain"]
                or compact.COUNTS["plain"] or sr.COUNTS["plain"]):
            raise RuntimeError("a grid function ran a plain version on the "
                               "card")
        return out

    def same(label, got, one_hist, one_scores):
        hist_g, hits_g, counts_g = got
        want_hits = torch.nonzero(compact.hit_mask(one_scores, t_cuts)).cpu()
        if not (torch.equal(hist_g, one_hist.cpu().long())
                and torch.equal(hits_g, want_hits)
                and torch.equal(counts_g, torch.bincount(want_hits[:, 2],
                                                         minlength=2))):
            raise RuntimeError(f"grid {label} != single device")
        return len(hits_g)

    for b in (2048, 2045):  # 2045: no multiple of the 4 data shards
        packed = sr.pack_run_seqs(rng.integers(0, 4, (b, r)))
        nbits = sr.pack_bits(rng.random((b, r)) < 0.001)
        vbits = sr.pack_bits(rng.random((b, noff)) < 0.95)
        got = counted(pp.sharded_run_scan(grid, k, hs), packed, nbits, vbits,
                      kernel, mins, cuts)
        t = [torch.from_numpy(x).to(dev) for x in (packed, nbits, vbits)]
        n_run = same(f"run scan B={b}", got,
                     *sr.scan_runs_device(*t, lut, t_mins, k, hs))
        gstart = rng.integers(0, len(genome) - r, b).astype(np.int32)
        got = counted(pp.sharded_resident_scan(grid, r, k, hs, with_n=True),
                      g4, gn, gstart, vbits, kernel, mins, cuts)
        g4d, gnd = sr.genome_planes_to_device(g4, gn, dev)
        n_res = same(f"resident scan B={b}", got, *sr.scan_runs_resident(
            g4d, gnd, torch.from_numpy(gstart).to(dev), t[2], lut, t_mins,
            r, k, hs))
        codes = rng.integers(0, 4, (b * 128, k)).astype(np.uint8)
        codes[rng.random(len(codes)) < 0.01, 3] = 4  # N windows
        codes[-3:] = 5  # padding rows
        pwm_flat = sw.pwms_to_flat([kernel[:, :, c].T for c in range(2)])
        scores, hist_w, counts_w = counted(
            pp.sharded_scan_step(grid, hs), codes, pwm_flat, mins, cuts)
        one_s, one_h = sw.score_hist_core(
            codes, sw.pwm_lut_from_flat(pwm_flat, dev), mins, hs)
        one_s = one_s.cpu()
        want_counts = ((one_s >= torch.from_numpy(cuts)) & (one_s >= 0)).sum(0)
        if not (torch.equal(scores, one_s)
                and torch.equal(hist_w, one_h.cpu().long())
                and torch.equal(counts_w, want_counts)):
            raise RuntimeError(f"grid scan step B={len(codes)} != "
                               "score_hist_core")
        log(f"(4, 2) grid on cuda:0, B={b}: sharded_run_scan ({n_run} hits), "
            f"sharded_resident_scan ({n_res} hits), sharded_scan_step "
            f"({len(codes)} windows) bit-identical to one device")
    log(f"grid launches: {launches}")
    return launches


RANK_PROG = BLOCK_JAX + (
    "import json\n"
    "from grafimo_tpu_torch.cli import main\n"
    "from grafimo_tpu_torch.ops import compact, hist, score_runs\n"
    "rc = main(sys.argv[1:])\n"
    "print(json.dumps({'hist_launches': hist.COUNTS['kernel'], "
    "'hist_plain': hist.COUNTS['plain'], "
    "'scan_launches': score_runs.COUNTS['kernel'], "
    "'fused_launches': score_runs.COUNTS['fused'], "
    "'scan_plain': score_runs.COUNTS['plain'], "
    "'compact_launches': compact.COUNTS['kernel'], "
    "'compact_plain': compact.COUNTS['plain']}))\n"
    "sys.exit(rc)\n"
)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(argv_of, timeout=600):
    """The port's CLI as ranks 0 and 1 of a gloo group on localhost, both
    on cuda:0, each a fresh interpreter with jax and grafimo_tpu
    blocked; fails unless both exit 0 in time.  Returns each rank's
    stdout."""
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_PROG, *argv_of(rank),
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(rank)],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n"
                               f"{out[-3000:]}")
    return outs


def phase_two_processes(torch, wd, gdir):
    """Phase 11: the run engine as two processes on cuda:0 -- the peak set
    (its report must be phase 8's one-process run-engine report byte for
    byte) and phase 5's one-region pocket BED, which leaves rank 1 with
    nothing to scan (its report must be phase 5's)."""
    cases = [
        ("peak set", os.path.join(wd, "peaks.bed"),
         os.path.join(wd, "out_peaks_runs_cuda")),
        ("one region", os.path.join(wd, "pocket.bed"),
         os.path.join(wd, "out_pocket_cuda")),
    ]
    launches = 0
    for label, bed, want in cases:
        tag = label.replace(" ", "_")
        t0 = time.perf_counter()
        outs = _two_ranks(lambda rank: [
            "findmotif", "-d", gdir, "-b", bed, "-m", MOTIF, "-t", "1e-4",
            "-o", os.path.join(wd, f"out_2proc_{tag}_{rank}"), "--verbose",
            "--device", "cuda"])
        wall = time.perf_counter() - t0
        _same_report(os.path.join(wd, f"out_2proc_{tag}_0"), want,
                     f"2 processes, {label}")
        if os.path.exists(os.path.join(wd, f"out_2proc_{tag}_1")):
            raise RuntimeError(f"2 processes, {label}: rank 1 wrote a report")
        parts = []
        for rank, out in enumerate(outs):
            counts = json.loads(out.strip().splitlines()[-1])
            if (counts["hist_plain"] or counts["compact_plain"]
                    or counts["scan_plain"]):
                raise RuntimeError(f"rank {rank} ran a plain version")
            if (counts["compact_launches"] or counts["scan_launches"]
                    or counts["hist_launches"]):
                raise RuntimeError(f"rank {rank}: {counts}, want one fused "
                                   f"launch a slice block and no other")
            launches += counts["fused_launches"]
            scan = re.search(r"run scan: .*\(([\d.]+)s\)", out)
            coll = re.search(r"cluster: rank \d/2, histogram all-reduce "
                             r"([\d.]+)s, report-row gather ([\d.]+)s", out)
            share = re.search(r"scanning (\d+/\d+) regions", out)
            if not (scan and coll and share):
                raise RuntimeError(f"rank {rank} printed no scan, cluster "
                                   f"or shard line:\n{out[-2000:]}")
            parts.append(
                f"rank {rank}: {share.group(1)} regions, scan "
                f"{scan.group(1)} s, all-reduce {coll.group(1)} s, gather "
                f"{coll.group(2)} s, {counts['fused_launches']} fused "
                f"scan_runs.cu launches")
        log(f"2 processes on cuda:0, {label}: " + "; ".join(parts)
            + f"; wall {wall:.2f}s (both ranks); rank 0's TSV and GFF3 "
            f"byte-identical to the 1-process run")
    return launches


def phase_profile(torch, wd, gdir):
    """Phase 12: ``--profile DIR`` on the peak set's run engine: the
    trace exists and names the fused scoring kernel, one launch a slice
    block, and the report is phase 8's."""
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr

    pdir = os.path.join(wd, "profile")
    out = os.path.join(wd, "out_profiled")
    for counts in (sr, hist, compact):
        counts.reset_counts()
    _, wall = _findmotif([
        "findmotif", "-d", gdir, "-b", os.path.join(wd, "peaks.bed"),
        "-m", MOTIF, "-t", "1e-4", "-o", out, "--device", "cuda",
        "--profile", pdir])
    launches = _one_fused_launch_a_block("--profile run")
    trace = os.path.join(pdir, "grafimo_rank0.pt.trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events
               if "scan_runs_fused_kernel" in str(e.get("name", ""))]
    if not kernels:
        raise RuntimeError(f"{trace} names no scan_runs_fused_kernel")
    # the three-launch route's kernels ran nowhere in this run
    for name in THREE_KERNELS:
        if any(name in str(e.get("name", "")) for e in events):
            raise RuntimeError(f"{trace} names {name}, which this run did "
                               f"not launch")
    _same_report(out, os.path.join(wd, "out_peaks_runs_cuda"),
                 "--profile run")
    log(f"--profile: {trace} ({os.path.getsize(trace)} bytes, "
        f"{len(events)} events, {len(kernels)} of scan_runs_fused_kernel, "
        f"{launches} launches counted), wall {wall:.2f}s; report "
        f"byte-identical to the run without it")
    return launches


def _chrom_rows(torch, wd, rows, r, stride):
    """``rows`` rows of ``r`` base codes of phase 5's chromosome on the
    card, row i at ``i * stride`` (the run engine's strided backbone rows
    when ``stride = r - k + 1``)."""
    codes = _chrom_codes(wd, (rows - 1) * stride + r)
    return torch.from_numpy(codes).cuda().long().unfold(0, r, stride)


def _compact_case(torch, label, s, cuts):
    """The compaction kernel against its plain version on ``s``, with the
    run engine's index capacity (``SCAN_SMALLK`` in the flush row, up to
    ``SCAN_TOPK`` with the block's own buffer): counts, bits, and the
    indices once sorted; past the capacity, the kernel's indices are
    distinct hits.  Then the case's timings."""
    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch.ops import compact

    smallk, topk = rb.SCAN_SMALLK, rb.SCAN_TOPK

    def buffers():
        return (torch.zeros(1, dtype=torch.int32, device="cuda"),
                torch.full((smallk,), -1, dtype=torch.int32, device="cuda"),
                torch.full((topk - smallk,), -1, dtype=torch.int32,
                           device="cuda"))

    got, want = buffers(), buffers()
    bits = compact.compact_hits(s, cuts, *got)
    want_bits = compact.compact_hits_reference(s, cuts, *want)
    torch.cuda.synchronize()
    n, n_want = int(got[0]), int(want[0])
    err = max(abs(n - n_want),
              int((bits.int() - want_bits.int()).abs().max()))
    if err or not torch.equal(bits, want_bits):
        raise RuntimeError(f"compact_hits != plain at {label}: counts {n} / "
                           f"{n_want}, max err {err}")
    kept = min(n, topk)
    idx = torch.cat(got[1:])[:kept]
    if n <= topk:
        if not torch.equal(torch.sort(idx).values, torch.cat(want[1:])[:kept]):
            raise RuntimeError(f"compact_hits != plain at {label}: indices")
    else:
        flat = torch.nonzero(compact.hit_mask(s, cuts).reshape(-1)).reshape(-1)
        if not (torch.isin(idx, flat.to(torch.int32)).all()
                and len(torch.unique(idx)) == kept):
            raise RuntimeError(f"compact_hits at {label}: kept indices are "
                               f"not distinct hits")
    tier = ("flush read" if n <= smallk else "block's indices" if n <= topk
            else "hit bits")
    reads = {}
    if tier == "block's indices":
        # what the host pays for such a block after the flush read: its own
        # indices past SCAN_SMALLK (the middle tier), or, without that tier,
        # its packed bits, unpacked as scan_batches unpacks them
        import numpy as np

        from grafimo_tpu_torch.ops.score_runs import unpack_hitbits

        noff = s.shape[1]
        for name, fn in (
            ("indices_read_ms",
             lambda: np.sort(got[2][: n - smallk].cpu().numpy())),
            ("bits_read_ms",
             lambda: np.flatnonzero(unpack_hitbits(bits.cpu().numpy(),
                                                   noff))),
        ):
            times = []
            for _ in range(11):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            reads[name] = sorted(times)[len(times) // 2]
        log(f"    {tier} tier read on the host (median of 11): own indices "
            f"{reads['indices_read_ms']:.4f} ms, packed bits "
            f"{reads['bits_read_ms']:.4f} ms")
    # the plane and cutoffs read once; bits, count and kept indices written
    bound = ((s.numel() + cuts.numel() + 1 + kept) * 4 + bits.numel()) \
        / HBM_BYTES_PER_S * 1e3
    t = _timings(
        torch, lambda: compact.compact_hits(s, cuts, *got),
        "compact_hits_kernel",
        plain=lambda: compact.compact_hits_reference(s, cuts, *want),
        library=lambda: torch.nonzero(compact.hit_mask(s, cuts)))
    log(f"compact_hits vs plain [{label}] scores {tuple(s.shape)}: {n} hits "
        f"({tier} tier), counts, indices and bits identical, max_abs_err 0; "
        f"{_fmt(t, bound, 'torch.nonzero(predicate)')}")
    return dict(t, label=label, max_abs_err=err, bound_ms=bound, hits=n,
                tier=tier, **reads)


def _random_motif_lut(torch, k, m, seed):
    """``m`` columns (forward and reverse complement of ``m // 2`` motifs
    from seeded random counts, as the port's loaders scale them) as a LUT
    on the card, and each column's reachable score range."""
    import numpy as np

    from grafimo_tpu_torch.models.background import load_bg
    from grafimo_tpu_torch.models.motif import Motif
    from grafimo_tpu_torch.models.parse import _prepare_counts_motif
    from grafimo_tpu_torch.models.process import process_motif
    from grafimo_tpu_torch.ops.score_runs import (
        pwm_lut_from_kernel,
        pwms_to_conv_kernel,
        reverse_complement_pwm,
    )
    from grafimo_tpu_torch.utils.constants import UNIF

    rng = np.random.default_rng(seed)
    mats = []
    for i in range(m // 2):
        counts = rng.integers(1, 50, (4, k)).astype(np.float64)
        motif = process_motif(_prepare_counts_motif(
            Motif(motif_id=f"R{i}", motif_name=f"R{i}", counts=counts,
                  width=k), load_bg(UNIF, False), 0.1))
        mats += [motif.score_matrix, reverse_complement_pwm(motif.score_matrix)]
    kernel = pwms_to_conv_kernel(mats)
    lut = pwm_lut_from_kernel(kernel, torch.device("cuda"))
    return lut, lut.min(dim=1).values.sum(dim=0), lut.max(dim=1).values.sum(
        dim=0)


def _compressed(s, bases, tops):
    """Scores as the main path hands them to the histogram: bin 0 below
    the base, 1 + i the score ``base + i``, -1 invalid; and the bin
    count."""
    import torch

    from grafimo_tpu_torch.ops.hist import remap

    comp_size = int((tops - bases).max()) + 2
    return remap(s, bases).to(torch.int32).contiguous(), comp_size


def phase_device_half(torch, wd, gdir):
    """Phase 13: the compaction kernel on real CTCF scores at the run
    engine's slice shapes, the histogram kernel at compressed bin counts,
    and ``multi.meme`` on the pocket region, cuda against cpu."""
    from grafimo_tpu_torch.models.pvalue import PvalueLookup
    from grafimo_tpu_torch.ops.score_runs import _window_scores

    ctcf, lut, _ = _ctcf_lut(torch)
    lookup = PvalueLookup(ctcf.pval_table)
    k = ctcf.width
    r = 2048
    stride = r - k + 1
    compact_cases = []
    for rows in (2048, 4096):
        s = _window_scores(_chrom_rows(torch, wd, rows, r, stride), lut,
                           k).contiguous()
        levels = [("no hits", None), ("sparse, p < 1e-4", 1e-4)]
        if rows == 4096:
            levels += [("past the index capacity, p < 1e-3", 1e-3),
                       ("dense, -t 1", 1.0)]
        for label, p in levels:
            cut = 1000 * k + 1 if p is None else lookup.score_cutoff(p)
            cuts = torch.full((2,), cut, dtype=torch.int32, device="cuda")
            compact_cases.append(_compact_case(
                torch, f"{rows} strided backbone rows, real CTCF scores, "
                f"{label}", s, cuts))
        del s
    torch.cuda.empty_cache()

    hist_cases = []
    bases = lut.min(dim=1).values.sum(dim=0)
    tops = lut.max(dim=1).values.sum(dim=0)
    s = _window_scores(_chrom_rows(torch, wd, 2048, r, r), lut, k)
    h, comp_size = _compressed(s, bases, tops)
    hist_cases.append(_check_hist_case(
        torch, "peaked: real CTCF scores, main path B=R=2048 k=19 M=2, "
        "compressed", h, comp_size))
    hist_cases.append(_check_hist_case(
        torch, "peaked: real CTCF scores, main path B=R=2048 k=19 M=2, "
        "remapped on load", s.contiguous(), comp_size,
        bases.to(torch.int32)))
    del s, h
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for k_, m in [(k_, m) for k_ in (8, 19, 70) for m in (2, 16, 40)]:
        lut_r, b_r, t_r = _random_motif_lut(torch, k_, m, SEED + k_ + m)
        codes = torch.randint(0, 4, (2048, r), device="cuda", generator=gen)
        s = _window_scores(codes, lut_r, k_)
        invalid = torch.rand(s.shape, device="cuda", generator=gen) < 0.05
        h, comp_size = _compressed(s.masked_fill_(invalid, -1), b_r, t_r)
        block = 58112  # bins one block holds on an H100
        path = (" (cluster)" if comp_size > block
                else " (column groups)" if m * comp_size > block else "")
        hist_cases.append(_check_hist_case(
            torch, f"compressed, k={k_} M={m}{path}", h, comp_size))
        hist_cases.append(_check_hist_case(
            torch, f"remapped on load, k={k_} M={m}{path}", s.contiguous(),
            comp_size, b_r.to(torch.int32)))
        del lut_r, codes, s, invalid, h
    torch.cuda.empty_cache()

    multi = os.path.join(HERE, "tests", "data", "input", "multi.meme")
    reports = {}
    for dev in ("cuda", "cpu"):
        outdir = os.path.join(wd, f"out_multi_{dev}")
        _, dt = _findmotif([
            "findmotif", "-d", gdir, "-b", os.path.join(wd, "pocket.bed"),
            "-m", multi, "-t", "1e-4", "-o", outdir, "--verbose", "--device",
            dev,
        ])
        reports[dev] = {name: open(os.path.join(outdir, name), "rb").read()
                        for name in sorted(os.listdir(outdir))
                        if name.endswith((".tsv", ".gff"))}
        log(f"multi.meme (widths 19, 8, 12) on the 1 Mbp pocket region on "
            f"{dev}: wall {dt:.2f}s")
    n_rows = sum(len(v.splitlines()) - 1 for name, v in reports["cuda"].items()
                 if name.endswith(".tsv"))
    if len(reports["cuda"]) != 6 or n_rows <= 0:
        raise RuntimeError(f"multi.meme: reports {sorted(reports['cuda'])}, "
                           f"{n_rows} rows")
    if reports["cuda"] != reports["cpu"]:
        raise RuntimeError("multi.meme: cuda and cpu reports differ")
    log(f"multi.meme: {n_rows} report rows over 3 motifs; every cuda TSV "
        f"and GFF3 byte-identical to cpu's")
    return compact_cases, hist_cases


WIDE_K = 70  # a motif wide enough that one column's bins outgrow a block


def _wide_motif(path):
    """A MEME file of one 70-wide motif, each position 0.97 on one base:
    its scores span ~65,700 compressed bins, more than one block's shared
    memory holds beside the fused kernel's tables."""
    rows = []
    for j in range(WIDE_K):
        probs = [0.01] * 4
        probs[j % 4] = 0.97
        rows.append(" ".join(f"{x:.6f}" for x in probs))
    with open(path, "w") as f:
        f.write("MEME version 4\n\nALPHABET= ACGT\n\nstrands: + -\n\n"
                "Background letter frequencies\nA 0.25 C 0.25 G 0.25 "
                "T 0.25\n\nMOTIF WIDE70 wide\nletter-probability matrix: "
                f"alength= 4 w= {WIDE_K} nsites= 100 E= 0\n"
                + "\n".join(rows) + "\n")


def phase_three_launch_route(torch, wd, gdir, synth):
    """Phase 16: the run engine's three-launch route end to end -- a
    70-wide motif whose bins outgrow one block (``fused_plan`` sends it to
    the unfused ``scan_runs.cu``, ``hist.cu`` on a cluster of blocks and
    ``compact.cu``) on 100 kbp of phase 5's chromosome before its first
    pocket (inside one, a 70 bp window spans so many variant sites that
    the haplotype windows run to hundreds of millions): one launch of each
    a slice block, no fused launch and no plain version on the card, and
    the cuda TSV and GFF3 byte-identical to the cpu ones.  Returns the
    launches of each kernel on the card."""
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr

    motif = os.path.join(wd, "wide70.meme")
    _wide_motif(motif)
    lo = synth["pockets"][0][0] // 2
    bed = os.path.join(wd, "wide.bed")
    with open(bed, "w") as f:
        f.write(f"chr21\t{lo}\t{lo + 100_000}\n")
    reports, launches = {}, None
    for dev in ("cuda", "cpu"):
        for counts in (sr, hist, compact):
            counts.reset_counts()
        outdir = os.path.join(wd, f"out_wide_{dev}")
        _, dt = _findmotif([
            "findmotif", "-d", gdir, "-b", bed, "-m", motif, "-t", "1e-3",
            "-o", outdir, "--verbose", "--device", dev])
        reports[dev] = _report(outdir)[0]
        with open(os.path.join(outdir, "grafimo_out.gff"), "rb") as f:
            reports[dev] += f.read()
        if dev == "cuda":
            n = sr.COUNTS["kernel"]
            launches = {"scan_runs": n, "exact_hist": hist.COUNTS["kernel"],
                        "compact_hits": compact.COUNTS["kernel"]}
            if (n <= 0 or sr.COUNTS != {"kernel": n, "fused": 0, "plain": 0}
                    or hist.COUNTS != {"kernel": n, "plain": 0}
                    or compact.COUNTS != {"kernel": n, "plain": 0}):
                raise RuntimeError(
                    f"70-wide motif: scan_runs {dict(sr.COUNTS)}, hist "
                    f"{dict(hist.COUNTS)}, compact {dict(compact.COUNTS)}; "
                    f"want the three launches a slice block")
        log(f"70-wide motif on 100 kbp from {lo} on {dev}: wall {dt:.2f}s")
    if reports["cuda"] != reports["cpu"]:
        raise RuntimeError("70-wide motif: cuda and cpu reports differ")
    log(f"70-wide motif: the three-launch route, {launches} launches on "
        f"cuda; TSV and GFF3 byte-identical to cpu's")
    return launches


LADDER_FINDMOTIF_T = 1e-5  # phase 17's ladder: a few report rows a motif
THREE = ("scan_runs", "exact_hist", "compact_hits")  # the three launches
GENOME_CHROMS = [str(i) for i in range(1, 23)] + ["X", "Y"]


def _captured_findmotif(argv):
    """``_findmotif``, with the report's frames by motif id captured from
    ``workflows._scan_runs`` as the CLI writes or prints them."""
    import grafimo_tpu_torch.workflows as wf

    real, frames = wf._scan_runs, {}

    def scan(*args, **kwargs):
        out = real(*args, **kwargs)
        frames.update(out)
        return out

    wf._scan_runs = scan
    try:
        text, dt = _findmotif(argv, echo=False)
    finally:
        wf._scan_runs = real
    return frames, text, dt


def _motifs_meme(meme, motif_ids, path):
    """The MEME file ``meme`` with the motifs ``motif_ids`` alone."""
    with open(meme) as f:
        head, *blocks = f.read().split("\nMOTIF ")
    kept = [b.rstrip("\n") for b in blocks if b.split()[0] in motif_ids]
    with open(path, "w") as f:
        f.write(head + "".join("\nMOTIF " + b + "\n" for b in kept))


def _launches():
    """The launches of every route since the counts were last reset."""
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr

    return {"scan_runs_fused": sr.COUNTS["fused"],
            "scan_runs": sr.COUNTS["kernel"],
            "exact_hist": hist.COUNTS["kernel"],
            "compact_hits": compact.COUNTS["kernel"],
            "plain": sr.COUNTS["plain"] + hist.COUNTS["plain"]
            + compact.COUNTS["plain"]}


def _reset_launches():
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr

    for counts in (sr, hist, compact):
        counts.reset_counts()


def _ladder_on_pocket(torch, wd, gdir):
    """Phase 17 (a): the 800-PWM ladder through ``findmotif`` on phase
    5's pocket region on the card; three sampled motifs alone on the card
    and on the CPU give the ladder's report rows byte for byte."""
    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch import kernels
    from grafimo_tpu_torch.ops.score_runs import fused_plan

    meme, by_width = _ladder_motifs(wd)
    bed = os.path.join(wd, "pocket.bed")
    t = str(LADDER_FINDMOTIF_T)
    _reset_launches()
    frames, text, dt = _captured_findmotif([
        "findmotif", "-d", gdir, "-b", bed, "-m", meme, "-t", t,
        "--text-only", "--device", "cuda"])
    launches = _launches()
    n_motifs = sum(len(v) for v in by_width.values())
    if len(frames) != n_motifs or text.count("Scanned sequences:") != len(
            by_width):
        raise RuntimeError(f"800-PWM ladder: {len(frames)} reports, "
                           f"{text.count('Scanned sequences:')} passes")
    # the route each width's block takes at every row bucket
    three = any(
        fused_plan(2 * len(ms), k, r,
                   rb.hist_layout(_ladder_kernel(ms, LADDER_T)[0])[2],
                   kernels.smem_block(0))["route"] != "fused"
        for k, ms in by_width.items() for r in rb.BUCKETS)
    n3 = launches["scan_runs"]
    if (launches["plain"] or launches["scan_runs_fused"] <= 0
            or launches["exact_hist"] != n3 or launches["compact_hits"] != n3
            or (n3 and not three)):
        raise RuntimeError(f"800-PWM ladder: launches {launches}; want the "
                           f"fused kernel, and the three launches only where "
                           f"the plan gives them")
    rows = sum(len(df) for df in frames.values())
    log(f"800-PWM ladder ({len(by_width)} widths) on the pocket region on "
        f"cuda, -t {t} --text-only: {rows} report rows, wall {dt:.2f}s, "
        f"launches {launches}")
    ks = sorted(by_width)
    modal = max(ks, key=lambda w: len(by_width[w]))
    # the three widths differ: each motif is alone in its width's pass
    sampled = [by_width[w][0].motif_id for w in (ks[0], modal, ks[-1])]
    alone = os.path.join(wd, "sampled.meme")
    _motifs_meme(meme, sampled, alone)
    for dev in ("cuda", "cpu"):
        got, _, dt = _captured_findmotif([
            "findmotif", "-d", gdir, "-b", bed, "-m", alone, "-t", t,
            "--text-only", "--device", dev])
        for mid in sampled:
            if got[mid].to_csv(sep="\t") != frames[mid].to_csv(sep="\t"):
                raise RuntimeError(f"800-PWM ladder: {mid} alone on {dev} "
                                   f"differs from its ladder rows")
        log(f"    {', '.join(sampled)} alone on {dev}: "
            f"{[len(got[mid]) for mid in sampled]} rows, wall {dt:.2f}s")
    if not sum(len(frames[mid]) for mid in sampled):
        raise RuntimeError("800-PWM ladder: the sampled motifs have no rows")
    log(f"800-PWM ladder: {', '.join(sampled)} (widths {ks[0]}, {modal}, "
        f"{ks[-1]}) alone on cuda and cpu: report rows byte-identical to "
        f"the ladder's")
    return launches


def _genome_directory(wd, rng):
    """24 small per-chromosome graphs (``1``..``22``, ``X``, ``Y``; 1 kbp,
    12 SNPs over 8 haplotypes each) in one directory, a BED of them and a
    MEME file of two motifs of widths 9 and 13."""
    from grafimo_tpu_torch.graph.sitegraph import build_graph
    from grafimo_tpu_torch.io.vcf import VcfRecord

    gdir = os.path.join(wd, "genome24")
    os.makedirs(gdir)
    bed = []
    for chrom in GENOME_CHROMS:
        seq = "".join(rng.choice(list("ACGT"), 1000))
        records = []
        for pos0 in sorted(rng.choice(range(5, 995), 12, replace=False)):
            ref = seq[pos0]
            alt = str(rng.choice([c for c in "ACGT" if c != ref]))
            records.append(VcfRecord(chrom, int(pos0) + 1, ref, [alt],
                                     [int(g) for g in rng.integers(0, 2, 8)]))
        graph = build_graph(chrom, seq, records)
        graph.save(os.path.join(gdir, f"{chrom}.gvt.npz"))
        bed.append(f"chr{chrom}\t0\t{graph.length}\n")
    with open(os.path.join(wd, "genome24.bed"), "w") as f:
        f.writelines(bed)
    lines = ["MEME version 4", "", "ALPHABET= ACGT", ""]
    for mid, w in (("W9", 9), ("W13", 13)):
        lines += [f"MOTIF {mid}", "letter-probability matrix: alength= 4 "
                  f"w= {w} nsites= 100 E= 0"]
        lines += [" ".join(f"{x:.6f}" for x in rng.dirichlet([1.0] * 4))
                  for _ in range(w)]
        lines.append("")
    with open(os.path.join(wd, "genome24.meme"), "w") as f:
        f.write("\n".join(lines))
    return gdir


def _genome_directory_run(wd, gdir):
    """Phase 17 (b): BASELINE config 4, the 24-graph directory through
    ``findmotif -d`` on the card and on the CPU: one pass a width, hits
    from many chromosomes in each motif's report, q-values over the
    merged hit set, and the cuda TSV and GFF3 byte-identical to cpu's."""
    import pandas as pd

    reports, launches = {}, None
    for dev in ("cuda", "cpu"):
        _reset_launches()
        out = os.path.join(wd, f"out_genome24_{dev}")
        text, dt = _findmotif([
            "findmotif", "-d", gdir, "-b", os.path.join(wd, "genome24.bed"),
            "-m", os.path.join(wd, "genome24.meme"), "-t", "0.05",
            "--recomb", "-o", out, "--device", dev])
        if text.count("Scanned sequences:") != 2:
            raise RuntimeError("24-graph directory: want one pass a width")
        if dev == "cuda":
            launches = _launches()
            if launches["plain"] or launches["scan_runs_fused"] <= 0:
                raise RuntimeError(f"24-graph directory: launches "
                                   f"{launches}")
        reports[dev] = b""
        for mid in ("W9", "W13"):
            df = pd.read_csv(os.path.join(out, f"grafimo_out_{mid}.tsv"),
                             sep="\t", index_col=0)
            chroms = {name.split(":")[0] for name in df["sequence_name"]}
            if (len(chroms) < 12 or not (df["q-value"] <= 1.0).all()
                    or not (df["q-value"] >= df["p-value"] - 1e-12).all()):
                raise RuntimeError(f"24-graph directory: {mid} holds "
                                   f"{len(chroms)} chromosomes, or q < p")
            for ext in ("tsv", "gff"):
                with open(os.path.join(out, f"grafimo_out_{mid}.{ext}"),
                          "rb") as f:
                    reports[dev] += f.read()
        log(f"24-graph directory on {dev}: wall {dt:.2f}s")
    if reports["cuda"] != reports["cpu"]:
        raise RuntimeError("24-graph directory: cuda and cpu reports differ")
    log(f"24-graph directory (BASELINE config 4): 2 widths, q-values over "
        f"the merged hit set, cuda TSV and GFF3 byte-identical to cpu's; "
        f"launches on cuda {launches}")
    return launches


def phase_many_motifs(torch, wd, gdir):
    """Phase 17: many motifs -- (a) the 800-PWM ladder on the pocket
    region, three sampled motifs alone equal to it on both devices; (b)
    the 24-graph genome directory, cuda == cpu; (c), the fused kernel at
    the ladder's block shapes, rides phase 15."""
    import numpy as np

    t0 = time.perf_counter()
    ladder = _ladder_on_pocket(torch, wd, gdir)
    genome = _genome_directory_run(
        wd, _genome_directory(wd, np.random.default_rng(SEED + 17)))
    log(f"phase 17 (many motifs): {time.perf_counter() - t0:.1f}s")
    return ladder, genome


# what hit assembly memoises on a graph (graph/runs.py)
GRAPH_CACHES = ("_cluster_cache", "_dense_delpref_cache", "_ref_node_arr",
                "_site_deletable_arr")


def _route_columns(rs, res, by_key, motifs, col_meta, k, backbone_run):
    """The report columns of ``res``'s hits from
    ``runscan._assemble_columns``, on its own route or, with
    ``backbone_run``, with each backbone hit read by
    ``reconstruct_hits_batch`` off its region's whole backbone run
    (``build_single_run`` -> ``_build_backbone_run``), the route that
    ``assemble.backbone_hits`` replaced; every other hit takes the one
    route.  The graphs' memos and the regions' run caches are dropped
    first, so each route pays for its own.  Returns ``(columns,
    seconds)``."""
    from grafimo_tpu_torch.graph.runs import (
        build_single_run,
        reconstruct_hits_batch,
    )

    real = rs._hit_fields

    def run_fields(rr, ref, offs, k):
        if ref[0] != -1:
            return real(rr, ref, offs, k)
        run = rr._run_cache.get(ref)
        if run is None:
            run = rr._run_cache[ref] = build_single_run(
                rr.graph, rr.start, rr.stop, k, ref)
        return reconstruct_hits_batch(rr.graph, run, offs, k)

    saved = {key: dict(rr._run_cache) for key, rr in by_key.items()}
    for rr in by_key.values():
        for name in GRAPH_CACHES:
            rr.graph.__dict__.pop(name, None)
    if backbone_run:
        rs._hit_fields = run_fields
    try:
        t0 = time.perf_counter()
        cols = rs._assemble_columns(res, motifs, by_key, col_meta, k)
        return cols, time.perf_counter() - t0
    finally:
        rs._hit_fields = real
        for key, rr in by_key.items():
            rr._run_cache = saved[key]


# BASELINE config 1's shape: tools/bench_chrom_scale.py's ENCODE-shaped
# BED, CTCF over 3,000 peaks of 270 bp drawn from seed 7
# (utils/synth.encode_like_bed)
ENCODE_PEAKS = 3000


def _encode_assembly(torch, gdir, bed, card):
    """Phase 18's regions scanned on ``cuda:0`` in this process, their
    hits assembled on both routes: the report columns must be equal."""
    from grafimo_tpu_torch import runscan as rs
    from grafimo_tpu_torch.io.bed import read_bed_regions
    from grafimo_tpu_torch.models.parse import load_motifs
    from grafimo_tpu_torch.utils.constants import UNIF
    from grafimo_tpu_torch.workflows import load_graph_file

    graph = load_graph_file(os.path.join(gdir, "21.gvt.npz"))
    regions, _ = read_bed_regions(bed)
    kernel, mins, cuts, k, hist_size = _ctcf_scan_inputs()
    rrs = rs.build_region_runs(graph, "21", regions["chr21"], k)
    res = rs.scan_batches(rs.batch_runs(rrs, k), kernel, mins, cuts, k,
                          hist_size, torch.device("cuda", 0))
    res.hits.sort()
    kinds = {"backbone": 0, "cluster": 0, "dense": 0, "fallback": 0}
    for (_key, (c_idx, _x)), _off, _col in res.hits:
        kinds["backbone" if c_idx == -1 else "cluster" if c_idx >= 0
              else "fallback" if c_idx == -2 else "dense"] += 1
    by_key = {rr.key: rr for rr in rrs}
    motifs = load_motifs(MOTIF, UNIF, 0.1, False)
    col_meta = [(0, "+"), (0, "-")]
    new, t_new = _route_columns(rs, res, by_key, motifs, col_meta, k, False)
    old, t_old = _route_columns(rs, res, by_key, motifs, col_meta, k, True)
    if new != old:
        raise RuntimeError("ENCODE-shaped peak set: hit assembly differs "
                           "between the backbone-run route and the new one")
    if not res.hits or not kinds["backbone"]:
        raise RuntimeError(f"ENCODE-shaped peak set: hits {kinds}; want "
                           f"backbone hits among them")
    log(f"ENCODE-shaped peak set, hit assembly of {len(res.hits)} raw hits "
        f"{kinds}: new route {t_new:.3f}s, backbone-run route {t_old:.3f}s "
        f"({t_old / max(t_new, 1e-9):.1f}x), columns equal ({card})")


def phase_encode_peaks(torch, wd, gdir, synth, card):
    """Phase 18: the JAX tool's ENCODE-shaped BED over phase 5's graph
    through ``findmotif`` on the card, one fused launch a slice block and
    nothing else, then on the CPU: TSV and GFF3 byte-identical; then its
    hit assembly on both routes (``_encode_assembly``)."""
    from grafimo_tpu_torch.utils.synth import encode_like_bed

    t0 = time.perf_counter()
    bed = os.path.join(wd, "encode_like.bed")
    encode_like_bed(bed, synth["length"], ENCODE_PEAKS)
    launches, walls = None, {}
    for dev in ("cuda", "cpu"):
        _reset_launches()
        _, walls[dev] = _findmotif([
            "findmotif", "-d", gdir, "-b", bed, "-m", MOTIF, "-t", "1e-4",
            "-o", os.path.join(wd, f"out_encode_{dev}"), "--verbose",
            "--device", dev])
        if dev == "cuda":
            launches = _one_fused_launch_a_block("ENCODE-shaped peak set")
    _same_report(os.path.join(wd, "out_encode_cuda"),
                 os.path.join(wd, "out_encode_cpu"), "ENCODE-shaped peak set")
    _, n_hits = _report(os.path.join(wd, "out_encode_cuda"))
    log(f"ENCODE-shaped peak set ({ENCODE_PEAKS} x 270 bp, seed 7): "
        f"{n_hits} hits, wall cuda {walls['cuda']:.2f}s, cpu "
        f"{walls['cpu']:.2f}s, fused scan_runs.cu launches {launches}; cuda "
        f"TSV and GFF3 byte-identical to cpu's")
    _encode_assembly(torch, gdir, bed, card)
    log(f"phase 18 (ENCODE-shaped peak set): {time.perf_counter() - t0:.1f}s")
    return launches


KINDS = ("packed", "gathered", "strided", "patched", "spliced")
# int32 adds outside the tensor cores: an H100 SM issues 64 a clock against
# 128 float32 FMAs, so a quarter of the data sheet's 67 TFLOP/s float32
# rate (2 flops an FMA; 132 SMs at 1.98 GHz)
INT32_ADDS_PER_S = 67e12 / 4
SMEM_BYTES_PER_S = 132 * 128 * 1.755e9  # 128 B a clock per SM


def _words_read(plane, starts, r, bits):
    """Bytes of a resident word plane that rows of ``r`` bases from
    ``starts`` cover, each word counted once however many rows share it."""
    import numpy as np

    per = 32 // bits
    n = plane.shape[0]
    cover = np.zeros(n + 1, np.int64)
    np.add.at(cover, np.minimum(starts // per, n), 1)
    np.add.at(cover, np.minimum((starts + r - 1) // per + 1, n), -1)
    return int((np.cumsum(cover[:n]) > 0).sum()) * plane.element_size()


def _scan_runs_genome(torch, wd, rng):
    """Phase 5's chromosome with seeded N runs written into it (the
    synthetic chromosome has none): its codes and N mask on the host, and
    the run engine's resident word planes of it on the card."""
    import types

    import numpy as np

    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch.ops.score_runs import genome_planes_to_device

    with open(os.path.join(wd, "ref.fa"), "rb") as f:
        f.readline()
        seq = np.frombuffer(f.read().replace(b"\n", b""), np.uint8).copy()
    for start in rng.integers(0, len(seq) - 64, 2000):
        seq[start : start + int(rng.integers(1, 20))] = ord("N")
    table = np.zeros(256, np.uint8)
    table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    planes = rb._resident_genome(
        types.SimpleNamespace(seq=seq.tobytes().decode("ascii")))
    return (table[seq], seq == ord("N"),
            *genome_planes_to_device(*planes, torch.device("cuda")))


def _kind_batch(torch, kind, genome, b, r, k, rng, masks=True, n_slots=16):
    """A seeded slice block of ``kind`` over ``genome`` (from
    :func:`_scan_runs_genome`) as the five ``scan_runs_*`` functions, their
    plain versions and the kernel's launch take it.  Rows of real
    chromosome; with ``masks``, the N plane and validity bits (row 0 all
    valid, the last row all invalid).  Patches: row 0 empty, row 1 full,
    row 2 one over a genome N, the others 0 to ``n_slots`` slots, slots
    may repeat a position (the later wins).  Splice: rows 0 and 2 unused,
    the others one or two pairs with shifts of either sign, every third
    an unused pair before a used one."""
    import numpy as np

    from grafimo_tpu_torch.ops import score_runs as sr

    codes, nmask, g4, gn = genome
    dev = torch.device("cuda")
    length = len(codes)
    noff = r - k + 1
    if kind == "strided":
        b = min(b, (length - r) // noff)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    vb = None
    if masks:
        v = rng.random((b, noff)) < 0.95
        v[0] = True
        v[-1] = False
        vb = put(sr.pack_bits(v))
    else:
        gn = None
    if kind == "packed":
        idx = rng.integers(0, length - r, b)[:, None] + np.arange(r)
        packed = put(sr.pack_run_seqs(codes[idx]))
        nbits = put(sr.pack_bits(nmask[idx])) if masks else None
        return dict(
            b=b, r=r, vb=vb, head=(packed, nbits, vb), tail=(k,),
            rows=sr.packed_rows(packed, nbits),
            fn=sr.scan_runs_device, plain=sr.scan_runs_device_reference)
    if kind == "strided":
        lo = int(rng.integers(0, length - b * noff - r + 1))
        return dict(
            b=b, r=r, vb=vb, head=(g4, gn, lo, vb), tail=(b, noff, r, k),
            rows=sr.strided_rows(g4, gn, lo, b, noff, r),
            fn=sr.scan_runs_resident_strided,
            plain=sr.scan_runs_resident_strided_reference)
    gstart = rng.integers(0, length - r, b).astype(np.int32)
    npos = np.flatnonzero(nmask)
    gstart[2] = npos[(npos >= 100) & (npos < length - r)][0] - 100
    gs = put(gstart)
    if kind == "gathered":
        return dict(
            b=b, r=r, vb=vb, head=(g4, gn, gs, vb), tail=(r, k),
            rows=sr.resident_rows(g4, gn, gs, r),
            fn=sr.scan_runs_resident, plain=sr.scan_runs_resident_reference)
    used = np.arange(n_slots)[None, :] < rng.integers(0, n_slots + 1,
                                                      (b, 1))
    used[0], used[1], used[2] = False, True, np.arange(n_slots) == 0
    ent = rng.integers(0, r, (b, n_slots)) * 4 + rng.integers(0, 4,
                                                              (b, n_slots))
    ent[2, 0] = 100 * 4 + 1
    pt = put(np.where(used, ent, -1).astype(np.int16))
    if kind == "patched":
        return dict(
            b=b, r=r, vb=vb, head=(g4, gn, gs, pt, vb), tail=(r, k),
            rows=sr.patched_rows(g4, gn, gs, pt, r),
            fn=sr.scan_runs_resident_patched,
            plain=sr.scan_runs_resident_patched_reference)
    bounds = np.sort(rng.integers(2, r - 2, (b, 2)), axis=1)
    shifts = rng.integers(-40, 41, (b, 2))
    pairs = np.stack([bounds, shifts], axis=2).reshape(b, 4)
    splice = np.full((b, 4), 0x7FFF, np.int64)
    one = rng.random(b) < 0.5
    splice[~one] = pairs[~one]
    first = one & (np.arange(b) % 3 != 0)
    splice[first, :2] = pairs[first, :2]
    last = one & (np.arange(b) % 3 == 0)
    splice[last, 2:] = pairs[last, :2]
    splice[[0, 2]] = 0x7FFF
    sp = put(splice.astype(np.int16))
    return dict(
        b=b, r=r, vb=vb, head=(g4, gn, gs, sp, pt, vb), tail=(r, k),
        rows=sr.spliced_rows(g4, gn, gs, sp, pt, r),
        fn=sr.scan_runs_resident_spliced,
        plain=sr.scan_runs_resident_spliced_reference)


def _block_bytes_read(torch, batch, lut):
    """Bytes a slice block's scoring must read: descriptors, masks, the
    LUT and minima, and the genome words the rows cover (2 bits a base in
    the code plane, 1 in the N plane), rows that overlap sharing them; the
    words a splice shift reaches past its row are left out, so the bound
    stays a least one."""
    import numpy as np

    rows, b, r = batch["rows"], batch["b"], batch["r"]
    ins = sum(x.numel() * x.element_size() for x in batch["head"]
              if isinstance(x, torch.Tensor) and x.dim() == 2)
    if rows.source != 0:
        if rows.source == 1:
            starts = rows.tensors["gstart"].cpu().numpy().astype(np.int64)
            ins += starts.size * 4
        else:
            starts = rows.lo + rows.stride * np.arange(b, dtype=np.int64)
        for name, bits in (("genome", 2), ("ngenome", 1)):
            if rows.tensors[name] is not None:
                ins += _words_read(rows.tensors[name], starts, r, bits)
    return ins + lut.numel() * 4 + lut.shape[2] * 4


def _scan_runs_case(torch, label, batch, lut, mins):
    """The scoring-core kernel against its plain version on one block, bit
    for bit, through the dispatching function and the bare launch; the
    ``conv1d`` yardstick (one-hot rows built outside the timed call, TF32
    off) equal to it once masked; then the case's timings and bounds."""
    import numpy as np
    import torch.nn.functional as F

    from grafimo_tpu_torch.ops import score_runs as sr

    b, r, vb = batch["b"], batch["r"], batch["vb"]
    k, m = lut.shape[0], lut.shape[2]
    head, tail = batch["head"], batch["tail"]

    def kernel():
        return sr._launch(batch["rows"], k, lut, mins, vb)

    def plain():
        return batch["plain"](*head, lut, mins, *tail)

    _, got = batch["fn"](*head, lut, mins, *tail, 1020 * k + 1)
    want = plain()
    bare = kernel()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err or not (torch.equal(got, want) and torch.equal(bare, got)):
        raise RuntimeError(f"scan_runs != plain at {label}: max err {err}")
    codes, n_ind = batch["rows"].expand()
    onehot = F.one_hot(codes, 4).permute(0, 2, 1).float().contiguous()
    weight = lut.permute(2, 1, 0).float().contiguous()

    def conv():
        return F.conv1d(onehot, weight)

    raw = conv().round().to(torch.int32).transpose(1, 2)
    if not torch.equal(sr.apply_masks(raw, n_ind, vb, mins, k), got):
        raise RuntimeError(f"conv1d yardstick != scan_runs at {label}")
    # windows whose sums the masks leave (the data's work)
    summed = int((sr.apply_masks(torch.full_like(raw, -2), n_ind, vb,
                                 torch.full_like(mins, -3), k) == -2).sum())
    del raw, want, bare, codes, n_ind
    t = _timings(torch, kernel, "scan_runs_kernel", plain=plain,
                 library=conv)
    del onehot
    # bytes: the plane written, the block's inputs read once
    nbytes = got.numel() * 4 + _block_bytes_read(torch, batch, lut)
    adds = summed * (k - 1)  # each kept window's k LUT entries summed
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / INT32_ADDS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    smem_ms = summed * k * 4 / SMEM_BYTES_PER_S * 1e3
    log(f"scan_runs vs plain [{label}] (B, R, k, M) = ({b}, {r}, {k}, {m}): "
        f"bit-identical, max_abs_err 0, conv1d equal; "
        f"{_fmt(t, bound, 'conv1d')} ({'bytes' if bytes_ms >= ops_ms else 'operations'}"
        f"; LUT reads from shared memory {smem_ms:.5f} ms)")
    return dict(t, label=label, max_abs_err=err, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                smem_ms=smem_ms, bytes=nbytes, adds=adds)


def phase_scan_runs_vs_plain(torch, wd):
    """Phase 14: the run engine's scoring core, ``csrc/scan_runs.cu``,
    against its plain version on the card, bit for bit, for every kind:
    the main path's block (8192 rows of R = 2048 of phase 5's chromosome,
    real CTCF forward and reverse complement; the strided kind as many
    rows as the chromosome holds), R = 64 and 256 with 4-slot patches,
    k in {8, 30, 70}, M in {16, 40}, a clean block (no vbits, no N plane),
    LUT entries at 1020 (M = 5) and a LUT tiled over columns (M = 400)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    genome = _scan_runs_genome(torch, wd, rng)
    ctcf, ctcf_lut, ctcf_mins = _ctcf_lut(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def motif(k, m):
        lut, bases, _ = _random_motif_lut(torch, k, m, SEED + k + m)
        return lut, (bases - 1).to(torch.int32)

    def random_lut(k, m):
        lut = torch.randint(0, 1001, (k, 4, m), device="cuda", generator=gen,
                            dtype=torch.int32)
        lut[:, :, 0] = 1020
        return lut, lut.amin(dim=(0, 1)).to(torch.int32)

    cases = []
    shapes = [  # (label, B, R, LUT, patch slots, masks)
        ("main path block, real CTCF", 8192, 2048, (ctcf_lut, ctcf_mins),
         16, True),
        ("R=64 k=8 M=16", 16384, 64, motif(8, 16), 4, True),
        ("R=256 k=30 M=40", 4096, 256, motif(30, 40), 4, True),
        ("R=2048 k=70 M=16", 1024, 2048, motif(70, 16), 16, True),
        ("clean block (no vbits, no N plane), CTCF", 1024, 2048,
         (ctcf_lut, ctcf_mins), 16, False),
    ]
    torch.backends.cudnn.allow_tf32 = False
    try:
        for label, b, r, (lut, mins), slots, masks in shapes:
            for kind in KINDS:
                batch = _kind_batch(torch, kind, genome, b, r, lut.shape[0],
                                    rng, masks, slots)
                cases.append(_scan_runs_case(torch, f"{kind}, {label}",
                                             batch, lut, mins))
                del batch
        for label, b, r, (lut, mins) in [
                ("LUT entries at 1020, M=5", 4096, 256, random_lut(19, 5)),
                ("LUT over column tiles, k=30 M=400", 256, 256,
                 motif(30, 400))]:
            batch = _kind_batch(torch, "spliced", genome, b, r, lut.shape[0],
                                rng)
            cases.append(_scan_runs_case(torch, f"spliced, {label}", batch,
                                         lut, mins))
            del batch
    finally:
        torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    return cases


THREE_KERNELS = ("scan_runs_kernel", "exact_hist_kernel",
                 "compact_hits_kernel")


# windows times columns of the plain version's score plane a pass: a
# larger slice block runs it in row ranges (2 GiB of int32 scores)
PLAIN_PLANE = 1 << 29


def _row_range(rows, a, b):
    """Rows ``a:b`` of a slice block, as its kind gives them."""
    from grafimo_tpu_torch.ops import score_runs as sr

    t = rows.tensors
    if rows.source == sr._PACKED:
        nb = t["nbits"]
        return sr.packed_rows(t["packed"][a:b],
                              None if nb is None else nb[a:b])
    g4, gn = t["genome"], t["ngenome"]
    if rows.source == sr._STRIDED:
        return sr.strided_rows(g4, gn, rows.lo + a * rows.stride, b - a,
                               rows.stride, rows.r)
    gs = t["gstart"][a:b]
    if t.get("splice") is not None:
        return sr.spliced_rows(g4, gn, gs, t["splice"][a:b],
                               t["patches"][a:b], rows.r)
    if t.get("patches") is not None:
        return sr.patched_rows(g4, gn, gs, t["patches"][a:b], rows.r)
    return sr.resident_rows(g4, gn, gs, rows.r)


def _plain_block(torch, rows, vb, lut, mins, k, cuts, comp_size, bases,
                 capacity):
    """``scan_block_reference`` over a slice block, in row ranges whose
    score planes hold at most ``PLAIN_PLANE`` windows times columns:
    the histogram, the packed hit bits, the hit count and, when there are
    no more than ``capacity``, every hit's flat index in ascending order
    (else None)."""
    from grafimo_tpu_torch.ops import score_runs as sr

    noff, m = rows.r - k + 1, lut.shape[2]
    step = max(1, PLAIN_PLANE // (noff * m))
    hist, bits, flat, n = None, [], [], 0
    for a in range(0, rows.b, step):
        b = min(rows.b, a + step)
        count = torch.zeros(1, dtype=torch.int32, device=lut.device)
        idx = torch.full((capacity,), -1, dtype=torch.int32,
                         device=lut.device)
        h, bt = sr.scan_block_reference(
            _row_range(rows, a, b), None if vb is None else vb[a:b], lut,
            mins, k, cuts, comp_size, bases, count, idx)
        hist = h if hist is None else hist + h
        bits.append(bt)
        c = int(count)
        if n + c <= capacity:
            flat.append(idx[:c] + a * noff * m)
        n += c
    return (hist, torch.cat(bits), n,
            torch.cat(flat) if n <= capacity else None)


def _fused_block_case(torch, label, batch, lut, mins, cuts, comp_size,
                      bases):
    """A slice block through ``scan_block`` on the card against its plain
    version on the same tensors (in row ranges past ``PLAIN_PLANE``):
    histogram, count and hit bits exact, indices equal once sorted (past
    the index capacity, distinct hits); the route the plan gives it
    launched as the plan says.  Then the timings of that route, of the
    three launches beside it ("before") and of the plain version, and the
    bound; a block past ``PLAIN_PLANE`` repeats each fewer times."""
    import numpy as np

    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch import kernels
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr

    rows, vb = batch["rows"], batch["vb"]
    k, m = lut.shape[0], lut.shape[2]
    noff = rows.r - k + 1
    smallk, topk = rb.SCAN_SMALLK, rb.SCAN_TOPK
    plan = sr.fused_plan(m, k, rows.r, comp_size, kernels.smem_block(0))
    big = rows.b * noff * m > PLAIN_PLANE
    reps = (2, 10, 5) if big else (10, 100, 20)  # plain, back to back, device

    got = (torch.zeros(1, dtype=torch.int32, device="cuda"),
           torch.full((smallk,), -1, dtype=torch.int32, device="cuda"),
           torch.full((topk - smallk,), -1, dtype=torch.int32,
                      device="cuda"))
    _reset_launches()
    h, bits = sr.scan_block(rows, vb, lut, mins, k, cuts, comp_size, bases,
                            *got)
    launched = (dict(sr.COUNTS), hist.COUNTS["kernel"],
                compact.COUNTS["kernel"])
    fused = plan["route"] == "fused"
    if launched != ({"kernel": int(not fused), "fused": int(fused),
                     "plain": 0}, int(not fused), int(not fused)):
        raise RuntimeError(f"scan_block at {label}: launches {launched} on "
                           f"the {plan['route']} route")
    h_want, bits_want, n_want, idx_want = _plain_block(
        torch, rows, vb, lut, mins, k, cuts, comp_size, bases, topk)
    torch.cuda.synchronize()
    n = int(got[0])
    err = max(abs(n - n_want), int((h.long() - h_want.long()).abs().max()),
              int((bits.int() - bits_want.int()).abs().max()))
    if err or not (torch.equal(h, h_want) and torch.equal(bits, bits_want)):
        raise RuntimeError(f"scan_block != plain at {label}: counts {n} / "
                           f"{n_want}, max err {err}")
    kept = min(n, topk)
    idx = torch.cat(got[1:])[:kept]
    if n <= topk:
        if not torch.equal(torch.sort(idx).values, idx_want):
            raise RuntimeError(f"scan_block != plain at {label}: indices")
    else:
        flat = torch.from_numpy(np.flatnonzero(
            sr.unpack_hitbits(bits.cpu().numpy(), noff)).astype(np.int32))
        if not (torch.isin(idx.cpu(), flat).all()
                and len(torch.unique(idx)) == kept):
            raise RuntimeError(f"scan_block at {label}: kept indices are "
                               f"not distinct hits")
    if int(h.sum()) <= 0:
        raise RuntimeError(f"scan_block at {label}: nothing counted")
    tier = ("flush read" if n <= smallk else "block's indices" if n <= topk
            else "hit bits")
    del h_want, bits_want

    def call():
        sr.scan_block(rows, vb, lut, mins, k, cuts, comp_size, bases, *got)

    def plain():
        _plain_block(torch, rows, vb, lut, mins, k, cuts, comp_size, bases,
                     topk)

    def three():
        s = sr._launch(rows, k, lut, mins, vb)
        hist.exact_hist(s, comp_size, bases)
        compact.compact_hits(s, cuts, *got)

    t = _timings(torch, call, "scan_runs_fused_kernel" if fused
                 else THREE_KERNELS, plain=plain, reps=reps)
    if not fused:
        t["device_ms"] = _device_ms(torch, call, THREE_KERNELS, reps=reps[2],
                                    per_call=True)
    before = {"ms_back_to_back": _back_to_back_ms(torch, three, reps[1]),
              "device_ms": _device_ms(torch, three, THREE_KERNELS,
                                      reps=reps[2], per_call=True)}
    torch.cuda.empty_cache()
    # the work these inputs need: each kept window's pair-table sums
    # (ceil(k / 2) a table word; two columns a word when every window sum
    # fits 16 bits) and one count a valid window and column; the inputs
    # read once, the bits, histogram, count and kept indices written once
    codes, n_ind = rows.expand()
    probe = sr.apply_masks(
        torch.full((rows.b, noff, 1), -2, dtype=torch.int32, device="cuda"),
        n_ind, vb, torch.full((1,), -3, dtype=torch.int32, device="cuda"), k)
    summed, valid = int((probe == -2).sum()), int((probe != -1).sum())
    del codes, n_ind, probe
    pack = bool((lut >= 0).all()) and int(lut.max()) * k <= 0xFFFF
    words = (m + 1) // 2 if pack else m
    adds = summed * ((k + 1) // 2) * words + valid * m
    nbytes = (_block_bytes_read(torch, batch, lut) + 2 * m * 4
              + bits.numel() + comp_size * m * 4 + 4 + kept * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / INT32_ADDS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    route = (f"fused, {plan['groups']} column group(s)" if fused
             else "three launches")
    log(f"scan_block vs plain [{label}] (B, R, k, M) = ({rows.b}, {rows.r}, "
        f"{k}, {m}), {comp_size} bins, {route}: {n} hits ({tier} tier), "
        f"histogram, count, indices and bits identical, max_abs_err 0; "
        f"{_fmt(t, bound, 'no one call')} "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}); three "
        f"launches: back to back {before['ms_back_to_back']:.4f} ms, device "
        f"{before['device_ms'] or float('nan'):.4f} ms")
    return dict(t, label=label, max_abs_err=err, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, adds=adds, hits=n, tier=tier,
                route=plan["route"], groups=plan["groups"],
                shape=[rows.b, rows.r, k, m],
                before_ms_back_to_back=before["ms_back_to_back"],
                before_device_ms=before["device_ms"])


def phase_scan_block_vs_plain(torch, wd):
    """Phase 15: the run engine's slice-block entry, ``scan_block`` -- one
    launch of ``csrc/scan_runs.cu``'s fused kernel that scores, counts and
    compacts -- against its plain version on the card, bit for bit: all
    five kinds at the main path's block (8192 rows of R = 2048 of phase
    5's chromosome with seeded N runs, real CTCF forward and reverse
    complement, compressed bins, p < 1e-4); the hit tiers on gathered
    rows (the flush read's, past the index capacity at p < 1e-3, dense at
    ``-t 1``); M = 16 and 40 in column groups; both sides of the bin count
    at which a column stops fitting one block; k = 70 on the route the plan
    gives it; and phase 14's other shapes (a clean block of each kind, M =
    40 at k = 30 on R = 256, short rows, LUT entries at 1020, a LUT of
    400 columns).  The kinds' edge rows ride every block: an all-invalid
    row, empty, full and repeated patch slots, negative splice shifts."""
    import numpy as np

    from grafimo_tpu_torch import kernels
    from grafimo_tpu_torch.models.pvalue import PvalueLookup
    from grafimo_tpu_torch.ops import score_runs as sr

    rng = np.random.default_rng(SEED + 9)
    genome = _scan_runs_genome(torch, wd, rng)
    ctcf, lut, mins = _ctcf_lut(torch)
    lookup = PvalueLookup(ctcf.pval_table)
    k = ctcf.width

    def compressed(lut):
        bases = lut.min(dim=1).values.sum(dim=0).to(torch.int32)
        return bases, int((lut.max(dim=1).values.sum(dim=0) - bases).max()) + 2

    def ctcf_cuts(p):
        return torch.full((2,), lookup.score_cutoff(p), dtype=torch.int32,
                          device="cuda")

    bases, comp = compressed(lut)
    cases = []
    for kind in KINDS:
        batch = _kind_batch(torch, kind, genome, 8192, 2048, k, rng)
        cases.append(_fused_block_case(
            torch, f"{kind}, main path block, real CTCF, p < 1e-4", batch,
            lut, mins, ctcf_cuts(1e-4), comp, bases))
        del batch
    for label, b, p in [("flush read tier, p < 1e-4", 2048, 1e-4),
                        ("past the index capacity, p < 1e-3", 8192, 1e-3),
                        ("dense, -t 1", 2048, 1.0)]:
        batch = _kind_batch(torch, "gathered", genome, b, 2048, k, rng)
        cases.append(_fused_block_case(
            torch, f"gathered, real CTCF, {label}", batch, lut, mins,
            ctcf_cuts(p), comp, bases))
        del batch
    # a CTCF column's bins that just fit one block, and one bin more (the
    # three launches)
    fit, over = comp, 1 << 20
    while over - fit > 1:
        mid = (fit + over) // 2
        one_block = sr.fused_plan(1, k, 2048, mid, kernels.smem_block(0))
        fit, over = ((mid, over) if one_block["route"] == "fused"
                     else (fit, mid))
    for size in (fit, fit + 1):
        batch = _kind_batch(torch, "spliced", genome, 1024, 2048, k, rng)
        cases.append(_fused_block_case(
            torch, f"spliced, CTCF forward, {size} bins", batch,
            lut[:, :, :1].contiguous(), mins[:1], ctcf_cuts(1e-4)[:1], size,
            bases[:1]))
        del batch
    # phase 14's other shapes: the kinds' clean block (no vbits, no N
    # plane), column groups at k = 19 and 30, k = 70, short rows, LUT
    # entries at 1020 and a LUT of 400 columns
    for kind in KINDS:
        batch = _kind_batch(torch, kind, genome, 1024, 2048, k, rng, False)
        cases.append(_fused_block_case(
            torch, f"{kind}, clean block (no vbits, no N plane), CTCF",
            batch, lut, mins, ctcf_cuts(1e-4), comp, bases))
        del batch
    for kind, k_, m, b, r in [
            ("patched", 19, 16, 1024, 2048), ("patched", 19, 40, 1024, 2048),
            ("gathered", 30, 40, 4096, 256), ("patched", 70, 2, 2048, 2048),
            ("patched", 70, 16, 1024, 2048), ("packed", 8, 16, 16384, 64),
            ("spliced", 30, 400, 256, 256)]:
        lut_r, b_r, t_r = _random_motif_lut(torch, k_, m, SEED + 9 + k_ + m)
        cases.append(_random_block_case(
            torch, f"{kind}, random motifs k={k_} M={m}",
            _kind_batch(torch, kind, genome, b, r, k_, rng, True,
                        4 if r <= 256 else 16), lut_r, b_r, t_r))
        del lut_r
    lut_r = torch.randint(0, 1001, (k, 4, 5), device="cuda", dtype=torch.int32,
                          generator=torch.Generator(device="cuda").manual_seed(
                              SEED + 9))
    lut_r[:, :, 0] = 1020
    cases.append(_random_block_case(
        torch, "spliced, LUT entries at 1020, M=5",
        _kind_batch(torch, "spliced", genome, 4096, 256, k, rng), lut_r,
        lut_r.min(dim=1).values.sum(dim=0), lut_r.max(dim=1).values.sum(dim=0)))
    del lut_r
    cases += _ladder_block_cases(torch, wd, genome, rng)
    torch.cuda.empty_cache()
    return cases


def _ladder_motifs(wd):
    """``synth_meme``'s ladder (seed 0) as a MEME file in ``wd`` (written
    once) and its motifs by width."""
    import numpy as np

    from grafimo_tpu_torch.models.parse import load_motifs
    from grafimo_tpu_torch.utils import synth
    from grafimo_tpu_torch.utils.constants import UNIF

    meme = os.path.join(wd, "ladder.meme")
    if not os.path.exists(meme):
        synth.synth_meme(meme, LADDER_MOTIFS, np.random.default_rng(SEED))
    by_width = {}
    for mo in load_motifs(meme, UNIF, 0.1, False):
        by_width.setdefault(mo.width, []).append(mo)
    return meme, by_width


def _ladder_kernel(motifs, threshold):
    """The columns of one ladder width as ``compute_results_runs`` builds
    them: the PWM kernel of every motif's forward and reverse-complement
    columns, their minimum scores and p < ``threshold`` cutoffs."""
    from grafimo_tpu_torch.models.pvalue import PvalueLookup
    from grafimo_tpu_torch.ops.score_runs import (
        pwms_to_conv_kernel,
        reverse_complement_pwm,
    )

    mats, mins, cuts = [], [], []
    for mo in motifs:
        cut = PvalueLookup(mo.pval_table).score_cutoff(threshold)
        for mat in (mo.score_matrix, reverse_complement_pwm(mo.score_matrix)):
            mats.append(mat)
            mins.append(mo.min_score)
            cuts.append(cut)
    return pwms_to_conv_kernel(mats), mins, cuts


def _ladder_lut(torch, motifs, threshold):
    """:func:`_ladder_kernel`'s inputs on the card: the LUT, minimum
    scores, cutoffs and compressed bins (bases and bins a column)."""
    import numpy as np

    import grafimo_tpu_torch.runscan as rb
    from grafimo_tpu_torch.ops.score_runs import pwm_lut_from_kernel

    kernel, mins, cuts = _ladder_kernel(motifs, threshold)
    bases, _, comp = rb.hist_layout(kernel)
    dev = torch.device("cuda")

    def put(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    return (pwm_lut_from_kernel(kernel, dev), put(mins), put(cuts),
            put(bases), comp)


def _ladder_block_cases(torch, wd, genome, rng):
    """Phase 15's ladder shapes: ``synth_meme``'s 800 PWMs at the
    narrowest, the modal and the widest width of the file (every motif of
    the width, forward and reverse complement), the ladder's p < 1e-6
    cutoffs, at the rows ``runscan.slice_rows`` gives the fused route:
    gathered rows of R = 2048 at the narrowest and modal widths, the
    modal width's patched rows of R = 256, strided rows at the widest."""
    import grafimo_tpu_torch.runscan as rb

    _, by_width = _ladder_motifs(wd)
    ks = sorted(by_width)
    modal = max(ks, key=lambda w: len(by_width[w]))
    cases = []
    for kind, k, r in [("gathered", ks[0], 2048), ("gathered", modal, 2048),
                       ("patched", modal, 256), ("strided", ks[-1], 2048)]:
        lut, mins, cuts, bases, comp = _ladder_lut(torch, by_width[k],
                                                   LADDER_T)
        m = lut.shape[2]
        b = rb.slice_rows(r, k, m, rb.MAX_BASES_PER_DISPATCH, plane=False)
        batch = _kind_batch(torch, kind, genome, b, r, k, rng, True,
                            4 if r <= 256 else 16)
        cases.append(_fused_block_case(
            torch, f"{kind}, 800-PWM ladder width {k}, M={m}, p < 1e-6",
            batch, lut, mins, cuts, comp, bases))
        del batch, lut
        torch.cuda.empty_cache()
    return cases


def _random_block_case(torch, label, batch, lut, lo, hi):
    """Phase 15's case for a LUT with column minima sums ``lo`` and maxima
    sums ``hi``: compressed bins, cutoffs 4/5 of the way up, N windows at
    the base less one."""
    bases = lo.to(torch.int32)
    comp = int((hi - lo).max()) + 2
    cuts = (lo + (hi - lo) * 4 // 5).to(torch.int32)
    return _fused_block_case(torch, label, batch, lut,
                             (lo - 1).to(torch.int32), cuts, comp, bases)


def _kernel_line(name, source, replaces, launches, cases, headline, by_path):
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ms_back_to_back",
            "device_ms")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, launches_by_path=by_path,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        bound_by=headline.get("bound_by", "bytes"), case=headline["label"],
        **{k: headline.get(k) for k in keys},
    )


def main() -> int:
    # the port must run without JAX and without the reference package
    sys.modules["jax"] = sys.modules["grafimo_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device; nothing "
                         "to test\n")
        return 1
    cases_json = None
    if sys.argv[1:2] == ["--cases-json"]:
        cases_json = sys.argv[2]
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    card = phase_environment(torch)
    phase_build()
    hist_cases = phase_kernel_vs_plain(torch)
    phase_cuda_vs_cpu(torch)
    with tempfile.TemporaryDirectory(prefix="grafimo_smoke_") as wd:
        launches, gdir, synth, batches = phase_main_path(torch, wd)
        peaked = phase_peaked_hist(torch, wd)
        # phases 14 and 15 need phase 5's chromosome, and their device
        # times a profiler that no --profile run in this process has used
        scan_runs_cases = phase_scan_runs_vs_plain(torch, wd)
        block_cases = phase_scan_block_vs_plain(torch, wd)
        scan_cases = phase_scan_packed_vs_plain(torch)
        fused_cases = phase_fused_vs_plain(torch)
        hist_cases += phase_hist_variants(torch)
        scan_launches, peak_launches = phase_window_engine(torch, wd, gdir,
                                                           synth)
        shard_launches = phase_multi_device(torch, wd, gdir, batches)
        del batches
        grid_launches = phase_grid(torch)
        rank_launches = phase_two_processes(torch, wd, gdir)
        profile_launches = phase_profile(torch, wd, gdir)
        compact_cases, comp_hist_cases = phase_device_half(torch, wd, gdir)
        three = phase_three_launch_route(torch, wd, gdir, synth)
        ladder, genome24 = phase_many_motifs(torch, wd, gdir)
        encode_launches = phase_encode_peaks(torch, wd, gdir, synth, card)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    if cases_json:
        with open(cases_json, "w") as f:
            json.dump({"exact_hist": [peaked] + hist_cases + comp_hist_cases,
                       "scan_packed": scan_cases,
                       "scan_packed_fused": fused_cases,
                       "compact_hits": compact_cases,
                       "scan_runs": scan_runs_cases,
                       "scan_runs_fused": block_cases}, f, indent=1)
    # the compaction's headline: the sparse case at the (2048, 2030, 2)
    # plane, the shape of the histogram's headline
    compact_head = next(c for c in compact_cases if c["hits"]
                        and "p < 1e-4" in c["label"])
    # the scoring core's headline: the main path's block of gathered rows
    # (8192 x 2048, the shape a slice takes; the chromosome holds fewer
    # strided rows), unfused and fused
    scan_head = next(c for c in scan_runs_cases
                     if c["label"] == "gathered, main path block, real CTCF")
    block_head = next(c for c in block_cases if c["label"].startswith(
        "gathered, main path block"))
    # each kernel at the shape its engine's main path gives it: the run
    # engine's slice block and plane of real CTCF scores, the window
    # engine's region batch; launches on each kernel's own path (the run
    # engine's fused route, the window engine, the run engine's
    # three-launch route), counted from 0 just before it
    fused_route = {
        "run engine 10 Mbp, 1 device": launches,
        "run engine 10 Mbp, 2 shards of cuda:0": shard_launches,
        "run engine, peak set": peak_launches,
        "(4, 2) grid functions": grid_launches["scan_runs_fused"],
        "2 processes, both ranks, peak set + one region": rank_launches,
        "--profile, peak set": profile_launches,
        "run engine, 800-PWM ladder, pocket": ladder["scan_runs_fused"],
        "run engine, 24-graph directory": genome24["scan_runs_fused"],
        "run engine, ENCODE-shaped 3,000 x 270 bp peaks": encode_launches,
    }
    # the fused route's paths check that they launch nothing else; the
    # ladder and the directory count what they launch
    counted = {"run engine, 800-PWM ladder, pocket": ladder,
               "run engine, 24-graph directory": genome24}
    three_route = {name: {key: counted[name][key] if name in counted
                          else 0 for key in THREE}
                   for name in fused_route}
    def unfused(key):
        return {f"{name}, fused route": counts[key]
                for name, counts in three_route.items()}

    print(json.dumps({"kernels": [
        _kernel_line("exact_hist", "grafimo_tpu_torch/csrc/hist.cu",
                     "grafimo_tpu/ops/pallas_hist.py:90",
                     three["exact_hist"],
                     [peaked] + hist_cases + comp_hist_cases,
                     comp_hist_cases[0], dict(unfused("exact_hist"), **{
                         "run engine, 70-wide motif (three launches)":
                             three["exact_hist"],
                         "(4, 2) grid functions": grid_launches["exact_hist"],
                     })),
        _kernel_line("scan_packed", "grafimo_tpu_torch/csrc/scan_packed.cu",
                     "grafimo_tpu/ops/pallas_scan.py:74", scan_launches,
                     scan_cases + fused_cases, fused_cases[0], {
                         "window engine, peak set": scan_launches,
                         "(4, 2) grid functions":
                             grid_launches["scan_packed"],
                     }),
        _kernel_line("compact_hits", "grafimo_tpu_torch/csrc/compact.cu",
                     "grafimo_tpu/ops/score_runs.py:684",
                     three["compact_hits"], compact_cases, compact_head,
                     dict(unfused("compact_hits"), **{
                         "run engine, 70-wide motif (three launches)":
                             three["compact_hits"],
                         "(4, 2) grid functions":
                             grid_launches["compact_hits"],
                     })),
        _kernel_line("scan_runs", "grafimo_tpu_torch/csrc/scan_runs.cu",
                     "grafimo_tpu/ops/score_runs.py:410", three["scan_runs"],
                     scan_runs_cases, scan_head, dict(unfused("scan_runs"), **{
                         "run engine, 70-wide motif (three launches)":
                             three["scan_runs"],
                         "(4, 2) grid functions": grid_launches["scan_runs"],
                     })),
        _kernel_line("scan_runs_fused", "grafimo_tpu_torch/csrc/scan_runs.cu",
                     "grafimo_tpu/ops/pallas_hist.py:90", launches,
                     block_cases, block_head, fused_route),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
