"""Time the port's CUDA kernels on one NVIDIA card, for an A/B of two
trees of the repository in one call.

    python3 tools/bench_torch_kernels.py --root DIR --out FILE.json

imports ``grafimo_tpu_torch`` from the tree at ``DIR``, builds its
kernels, and times them on seeded inputs at the shapes the two engines
give them:

- ``exact_hist`` on the run engine's (2048, 2030, 2) plane, random and
  of CTCF (MA0139.1) scores over uniform random sequence (the peaked
  case), on M = 16 and 40 columns and on k = 70, and at the window
  engine's region batch (2,653, 1);
- ``score_packed`` at 2^18 rows and at the region batch;
- one region of the window engine's device work: in a tree without the
  fused entry ``score_packed_hist``, what the window engine ran before it
  (scores, clamp, a fresh histogram, the int64 add), else the fused
  launch;
- the run engine's histogram at compressed bins (CTCF M = 2, random
  k = 19 motifs of M = 16 and 40): in a tree whose ``exact_hist`` takes no
  ``bases``, the torch remap it ran before, then the histogram;
- a run-engine slice block of each of the five batch kinds (8192 rows of
  R = 2048 over 10 Mbp of seeded sequence with N runs; the strided kind
  as many rows as it holds; CTCF forward and
  reverse complement, validity bits, 16 patch slots, two splice pairs):
  the tree's ``scan_runs_*`` function, its scores and compressed
  histogram, whatever it launches for them; then the whole block's
  device work at CTCF's p < 1e-4 cutoff -- the three launches (that
  function, then ``compact_hits`` of its scores) and, in a tree with the
  fused entry ``scan_block``, its one launch.

Per case: the median of 10 single calls and the mean of 100 calls issued
back to back (CUDA events), and the device time per call of everything
the call puts on the card (``torch.profiler``: kernels and memsets).
Run it for each tree in turns (parent, change, change, parent) to compare
two trees on one card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SEED = 0
WINDOW_BATCH = 2653  # window rows of one 500 bp peak (both strands)


def _ctcf(root):
    """CTCF's integer score matrix, min score and p < 1e-4 score cutoff,
    read by the tree's own motif loader (older trees of the port used the
    reference's)."""
    motif = os.path.join(root, "tests", "data", "input", "MA0139.1.meme")
    try:
        from grafimo_tpu_torch.models.parse import load_motifs
        from grafimo_tpu_torch.models.pvalue import PvalueLookup
        from grafimo_tpu_torch.utils.constants import UNIF
    except ImportError:
        from grafimo_tpu.models.parse import load_motifs
        from grafimo_tpu.models.pvalue import PvalueLookup
        from grafimo_tpu.utils.constants import UNIF
    m = load_motifs(motif, UNIF, 0.1, False)[0]
    return (m.score_matrix, m.min_score,
            PvalueLookup(m.pval_table).score_cutoff(1e-4))


def _timed(torch, fn):
    fn()
    torch.cuda.synchronize()
    single = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        single.append(a.elapsed_time(b))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(100):
        fn()
    b.record()
    b.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    device_us = sum(
        getattr(e, "self_device_time_total", None)
        or getattr(e, "self_cuda_time_total", 0)
        for e in prof.key_averages()
    )
    return {"ms": sorted(single)[5], "ms_back_to_back": a.elapsed_time(b) / 100,
            "device_ms": device_us / 20 / 1e3}


def _run_engine_cases(torch, rng, dev, case, th, lut2, min_score, cut):
    """The compressed histogram and the five batch kinds' slice blocks."""
    import inspect
    import types

    from grafimo_tpu_torch import runscan
    from grafimo_tpu_torch.ops import score_runs as sr

    takes_bases = "bases" in inspect.signature(th.exact_hist).parameters

    def comp_hist(s, hs, bases):
        if takes_bases:
            return th.exact_hist(s, hs, bases)
        return th.exact_hist(
            torch.where(s < 0, -1, torch.clamp(s - bases + 1, min=0)), hs)

    def compressed(lut):
        bases = lut.amin(dim=1).sum(dim=0).to(torch.int32)
        return bases, int((lut.amax(dim=1).sum(dim=0) - bases).max()) + 2

    for name, k, m, lut in [("CTCF k=19 M=2", 19, 2, lut2),
                            ("M=16 k=19", 19, 16, None),
                            ("M=40 k=19", 19, 40, None)]:
        if lut is None:
            lut = torch.from_numpy(
                rng.integers(0, 1001, (k, 4, m)).astype(np.int32)).to(dev)
        codes = torch.from_numpy(rng.integers(0, 4, (2048, 2048))).to(dev)
        s = sr._window_scores(codes, lut, k).to(torch.int32).contiguous()
        bases, hs = compressed(lut)
        case(f"hist compressed bins {name}",
             lambda: comp_hist(s, hs, bases))
        del s, codes
        torch.cuda.empty_cache()

    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 10_000_000)
    for start in rng.integers(0, len(seq) - 64, 2000):
        seq[start : start + int(rng.integers(1, 20))] = ord("N")
    planes = runscan._resident_genome(
        types.SimpleNamespace(seq=seq.tobytes().decode("ascii")))
    g4, gn = sr.genome_planes_to_device(*planes, dev)
    b, r, k = 8192, 2048, 19
    noff = r - k + 1
    mins = torch.tensor([min_score] * 2, dtype=torch.int32, device=dev)
    bases, hs = compressed(lut2)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    vb = put(sr.pack_bits(rng.random((b, noff)) < 0.95))
    starts = rng.integers(0, len(seq) - r, b)
    gs = put(starts.astype(np.int32))
    table = np.zeros(256, np.uint8)  # N reads as A under its N bit
    table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    rows = seq[starts[:, None] + np.arange(r)]
    packed = put(sr.pack_run_seqs(table[rows]))
    nbits = put(sr.pack_bits(rows == ord("N")))
    del rows
    ent = rng.integers(0, r, (b, 16)) * 4 + rng.integers(0, 4, (b, 16))
    pt = put(np.where(rng.random((b, 16)) < 0.5, ent, -1).astype(np.int16))
    bounds = np.sort(rng.integers(2, r - 2, (b, 2)), axis=1)
    shifts = rng.integers(-40, 41, (b, 2))
    sp = put(np.stack([bounds, shifts], axis=2).reshape(b, 4)
             .astype(np.int16))
    # the strided kind: as many rows as the sequence holds
    bs = min(b, (len(seq) - r) // noff - 1)
    lo = int(rng.integers(0, len(seq) - bs * noff - r))
    blocks = {
        "packed": lambda: sr.scan_runs_device(
            packed, nbits, vb, lut2, mins, k, hs, hist_bases=bases),
        "gathered": lambda: sr.scan_runs_resident(
            g4, gn, gs, vb, lut2, mins, r, k, hs, hist_bases=bases),
        "strided": lambda: sr.scan_runs_resident_strided(
            g4, gn, lo, vb[:bs], lut2, mins, bs, noff, r, k, hs,
            hist_bases=bases),
        "patched": lambda: sr.scan_runs_resident_patched(
            g4, gn, gs, pt, vb, lut2, mins, r, k, hs, hist_bases=bases),
        "spliced": lambda: sr.scan_runs_resident_spliced(
            g4, gn, gs, sp, pt, vb, lut2, mins, r, k, hs,
            hist_bases=bases),
    }
    for kind, fn in blocks.items():
        rows = bs if kind == "strided" else b
        case(f"run engine block {kind} ({rows}, {r}) CTCF M=2", fn)
        torch.cuda.empty_cache()

    # the block's whole device work: scores, histogram and hits
    from grafimo_tpu_torch.ops.compact import compact_hits

    cuts = torch.full((2,), cut, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    idx = torch.empty(1 << 10, dtype=torch.int32, device=dev)
    more = torch.empty((1 << 13) - (1 << 10), dtype=torch.int32, device=dev)
    for kind, fn in blocks.items():
        rows = bs if kind == "strided" else b
        name = f"run engine block {kind} ({rows}, {r}) CTCF M=2, p < 1e-4"

        def three(fn=fn):
            compact_hits(fn()[1], cuts, count, idx, more)

        case(f"{name}: three launches", three)
        if hasattr(sr, "scan_block"):
            block = {
                "packed": sr.packed_rows(packed, nbits),
                "gathered": sr.resident_rows(g4, gn, gs, r),
                "strided": sr.strided_rows(g4, gn, lo, bs, noff, r),
                "patched": sr.patched_rows(g4, gn, gs, pt, r),
                "spliced": sr.spliced_rows(g4, gn, gs, sp, pt, r),
            }[kind]
            vbk = vb[:bs] if kind == "strided" else vb
            case(f"{name}: scan_block",
                 lambda: sr.scan_block(block, vbk, lut2, mins, k, cuts, hs,
                                       bases, count, idx, more))
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.modules["jax"] = None
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("bench_torch_kernels: no CUDA device\n")
        return 1
    from grafimo_tpu_torch import kernels
    from grafimo_tpu_torch.ops import hist as th
    from grafimo_tpu_torch.ops import scan_packed as sp
    from grafimo_tpu_torch.ops.pack import pack_codes
    from grafimo_tpu_torch.ops.score_runs import (
        _window_scores,
        pwm_lut_from_kernel,
        pwms_to_conv_kernel,
        reverse_complement_pwm,
    )

    kernels.load()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {"root": root, "card": smi.splitlines()[0], "cases": {}}

    def case(name, fn):
        out["cases"][name] = _timed(torch, fn)
        print(name, out["cases"][name], flush=True)

    mat, min_score, cut = _ctcf(root)
    lut2 = pwm_lut_from_kernel(
        pwms_to_conv_kernel([mat, reverse_complement_pwm(mat)]), dev)
    lut1 = pwm_lut_from_kernel(pwms_to_conv_kernel([mat]), dev)
    mins1 = torch.tensor([min_score], dtype=torch.int32, device=dev)

    def plane(k, m, lut=None):
        codes = torch.from_numpy(rng.integers(0, 4, (2048, 2048))).to(dev)
        if lut is None:
            lut = torch.from_numpy(
                rng.integers(0, 1001, (k, 4, m)).astype(np.int32)).to(dev)
        return (_window_scores(codes, lut, k) + 1).contiguous()

    for name, s, hs in [
        ("hist main path random k=19 M=2", plane(19, 2), 19002),
        ("hist main path CTCF (peaked) k=19 M=2", plane(19, 2, lut2), 19002),
        ("hist M=16 k=19", plane(19, 16), 19002),
        ("hist M=40 k=19", plane(19, 40), 19002),
        ("hist k=70 M=2", plane(70, 2), 70002),
    ]:
        case(name, lambda: th.exact_hist(s, hs))
        del s
        torch.cuda.empty_cache()

    def region(b):
        codes = rng.integers(0, 4, (b, 19)).astype(np.uint8)
        codes[rng.random(b) < 0.01, 3] = 4
        packed, flags = pack_codes(codes)
        return (torch.from_numpy(packed).to(dev),
                torch.from_numpy(flags).to(dev))

    packed, flags = region(WINDOW_BATCH)
    s = sp.score_packed(packed, flags, lut1, mins1).clamp(max=19000)
    case(f"hist window shape ({WINDOW_BATCH}, 1)",
         lambda: th.exact_hist(s, 19001))
    big = region(1 << 18)
    case("score_packed B=2^18 k=19 M=1",
         lambda: sp.score_packed(*big, lut1, mins1))
    case(f"score_packed B={WINDOW_BATCH} k=19 M=1",
         lambda: sp.score_packed(packed, flags, lut1, mins1))
    hist_dev = torch.zeros((19001, 1), dtype=torch.int64, device=dev)
    if hasattr(sp, "score_packed_hist"):
        def one_region():
            sp.score_packed_hist(packed, flags, lut1, mins1, hist_dev)
    else:
        def one_region():
            scores = sp.score_packed(packed, flags, lut1, mins1)
            h = th.exact_hist(scores.clamp(max=19000), 19001)
            hist_dev[:, 0] += h[:, 0]
    case(f"window engine region B={WINDOW_BATCH} (device work)", one_region)
    del big, hist_dev
    _run_engine_cases(torch, rng, dev, case, th, lut2, min_score, cut)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
