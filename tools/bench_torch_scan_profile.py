#!/usr/bin/env python3
"""The run engine's device idle share during its scan, from
``--profile`` traces, for one or more trees of the port on one card.

    python3 tools/bench_torch_scan_profile.py [--out FILE] TREE [TREE ...]

Makes the input of ``chip_smoke.py``'s phase 5 (a synthetic 10 Mbp
chromosome at the 1KGP profile, seed 0, 5096 haplotypes, built into a
graph by this checkout's port), then runs each TREE in turn -- a checkout
of this repository; list trees in turns to compare two versions on one
card, e.g. ``PARENT . . PARENT`` -- in a fresh interpreter with that
tree's ``grafimo_tpu_torch`` first on ``sys.path`` and JAX blocked:
the whole-chromosome CTCF ``findmotif --device cuda`` (``-t 1e-4``) once
to warm up, then once with ``--profile``, ``runscan.scan_batches``
wrapped in a ``torch.profiler.record_function`` span.  From the trace:
the span's wall time, the device's busy time inside it (the union of
kernel, memcpy and memset intervals), the idle share ``1 - busy /
wall``, the kernel time by kernel, and the copies each way.  Prints one
JSON object per run; ``--out`` also writes them as a JSON list.  Needs a
CUDA card; exits 1 without one.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = "bench::scan_batches"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def analyse(trace_path: str) -> dict:
    """Busy and idle time of the device inside the scan span of a Chrome
    trace written by ``torch.profiler``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events
             if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"{trace_path}: {len(spans)} {SPAN} spans")
    lo = spans[0]["ts"]
    hi = lo + spans[0]["dur"]
    inside = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy, end = 0.0, lo
    for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                       for e in inside):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel = {}
    for e in inside:
        if e["cat"] == "kernel":
            k = by_kernel.setdefault(e["name"][:60], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "scan_ms": (hi - lo) / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / (hi - lo),
        "kernel_launches": sum(n for n, _ in by_kernel.values()),
        "kernel_ms": sum(t for _, t in by_kernel.values()),
        "top_kernels": [[name, n, t] for name, (n, t) in top],
        "copies_dtoh": sum("DtoH" in e["name"] for e in inside
                           if e["cat"] == "gpu_memcpy"),
        "copies_htod": sum("HtoD" in e["name"] for e in inside
                           if e["cat"] == "gpu_memcpy"),
    }


def one(tree: str, gdir: str, bed: str, motif: str, work: str) -> dict:
    """Warm-up run, then the profiled run, of ``tree``'s port."""
    sys.modules["jax"] = sys.modules["grafimo_tpu"] = None
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import grafimo_tpu_torch
    import grafimo_tpu_torch.runscan as rs
    from grafimo_tpu_torch.cli import main

    if not grafimo_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {grafimo_tpu_torch.__file__}, not "
                           f"{tree}'s port")
    real = rs.scan_batches

    def spanned(*args, **kwargs):
        with torch.profiler.record_function(SPAN):
            return real(*args, **kwargs)

    rs.scan_batches = spanned
    out = {"tree": tree}
    for run in ("warm-up", "profiled"):
        argv = ["findmotif", "-d", gdir, "-b", bed, "-m", motif, "-t",
                "1e-4", "--verbose", "--device", "cuda", "-o",
                os.path.join(work, run)]
        if run == "profiled":
            argv += ["--profile", os.path.join(work, "trace")]
            if hasattr(rs, "reset_reads"):
                rs.reset_reads()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        m = re.search(r"run scan: .*\(([\d.]+)s\)", buf.getvalue())
        if rc != 0 or m is None:
            raise RuntimeError(f"{run} findmotif rc={rc}:\n"
                               f"{buf.getvalue()[-2000:]}")
        out[f"{run}_scan_s"] = float(m.group(1))
    out.update(analyse(os.path.join(work, "trace",
                                    "grafimo_rank0.pt.trace.json")))
    if hasattr(rs, "READS"):
        out["reads"] = dict(rs.READS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default="")
    ap.add_argument("--one", nargs=5, metavar=("TREE", "GRAPHS", "BED",
                                                "MOTIF", "WORK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(*args.one)))
        return 0
    sys.modules["jax"] = sys.modules["grafimo_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("bench_torch_scan_profile: no CUDA device\n")
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    results = []
    with tempfile.TemporaryDirectory(prefix="grafimo_profile_") as wd:
        out, _ = cs.run_checked(
            [sys.executable, "-c", cs.SYNTH_PROG, wd, str(cs.SMOKE_MBP),
             str(cs.SEED), str(cs.HAPLOTYPES)], timeout=900)
        length = json.loads(out.strip().splitlines()[-1])["length"]
        gdir = os.path.join(wd, "graphs")
        cs.run_checked(
            [sys.executable, "-c", cs.RUN_MODULE_PROG, "buildvg",
             "-l", os.path.join(wd, "ref.fa"),
             "-v", os.path.join(wd, "synth.vcf.gz"), "-o", gdir],
            timeout=900)
        bed = os.path.join(wd, "whole.bed")
        with open(bed, "w") as f:
            f.write(f"chr21\t0\t{length}\n")
        for i, tree in enumerate(args.trees):
            work = os.path.join(wd, f"run{i}")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 gdir, bed, cs.MOTIF, work],
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                raise RuntimeError(f"{tree}: rc={proc.returncode}\n"
                                   f"{proc.stdout[-2000:]}\n"
                                   f"{proc.stderr[-3000:]}")
            results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(results[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
