#!/usr/bin/env python3
"""The JASPAR-CORE-scale mixed-width ladder (BASELINE config 5) on the
port, one card, for one or more trees of the port.

    python3 tools/bench_torch_jaspar_ladder.py [--mbp 10] [--motifs 800]
        [--out FILE] [TREE ...]

The port's counterpart of ``tools/bench_jaspar_ladder.py``, with its
inputs: seed 0, ``--motifs`` synthetic PWMs drawn from JASPAR CORE
vertebrates' width histogram (widths 6-30) as one MEME file, then a
``--mbp`` Mbp random chromosome with one SNP every 30 bp and 1-in-7 alt
genotypes over 5096 haplotypes (``grafimo_tpu_torch/utils/synth.py``,
this checkout's port), built into a graph once.  Each TREE (a checkout
of this repository, default this one; list trees in turns to compare
two versions on one card, e.g. ``PARENT . . PARENT``) then runs in a
fresh interpreter with that tree's ``grafimo_tpu_torch`` first on
``sys.path`` and JAX and the reference package blocked: per width, one
``build_region_runs`` + ``compute_results_runs`` pass over the whole
chromosome on ``cuda:0`` (``threshold=1e-6``, ``recomb=False``), with
``runscan.scan_batches`` inside a ``torch.profiler`` span.

Per width it prints the motifs and device columns, the slice blocks and
rows per block, the host batching (``runscan.batch_runs``), scan
(``scan_batches``), report (hit assembly, ``_assemble_columns``, plus
per-motif statistics, ``_build_reports``) and whole-pass seconds, the
report's split by function where the tree has it (``graph/runs.py``'s
``backbone_run_s``, reached only for runs cached by the Python
extraction, and ``cluster_sites_s``; ``assemble.backbone_hits_s``;
``ref_nodes_s``, the reference node array, in ``graph/runs.py`` or, in
a tree that has them, ``assemble.py``, with ``clusters_s`` there;
``qvalue_s``, the q-value tables on either route), the kernel launches per
route (``ops/score_runs.COUNTS``, ``ops/hist.COUNTS``,
``ops/compact.COUNTS``), the device's busy time and idle share inside
the scan span, the hits, and window-strand-motif scorings (the
histogram's count: every window of every strand and motif) per second
of scan and of pass.  Each run's totals are one JSON line on stdout;
``--out`` also writes every run, widths included, as a JSON list.
Needs a CUDA card; exits 1 without one.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
HAPLOTYPES = 5096
THRESHOLD = 1e-6
SPAN = "bench::scan_batches"
# the report's split by function (``report_s`` = assembly + statistics)
SPLIT = ("assembly_s", "statistics_s", "backbone_run_s", "cluster_sites_s",
         "backbone_hits_s", "clusters_s", "ref_nodes_s", "qvalue_s")


def _analyse(trace_path: str) -> dict:
    sys.path.insert(0, os.path.join(HERE, "tools"))
    try:
        from bench_torch_scan_profile import analyse
    finally:
        sys.path.pop(0)
    return analyse(trace_path)


def ladder(tree: str, graph_path: str, meme: str, work: str,
           device: str = "cuda") -> dict:
    """Every width's pass of ``tree``'s port over the graph at
    ``graph_path`` for the motifs in ``meme``; on a card each scan is
    profiled into ``work``."""
    sys.modules["jax"] = sys.modules["grafimo_tpu"] = None
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import grafimo_tpu_torch
    import grafimo_tpu_torch.graph.runs as runs
    import grafimo_tpu_torch.runscan as rs
    from grafimo_tpu_torch.models.parse import load_motifs
    from grafimo_tpu_torch.ops import compact, hist
    from grafimo_tpu_torch.ops import score_runs as sr
    from grafimo_tpu_torch.utils.constants import UNIF
    from grafimo_tpu_torch.workflows import load_graph_file

    if not grafimo_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {grafimo_tpu_torch.__file__}, not "
                           f"{tree}'s port")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:  # the kernels' build and the context, outside the timings
        from grafimo_tpu_torch import kernels

        kernels.load()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    motifs = load_motifs(meme, UNIF, 0.1, False)
    t_motifs = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = load_graph_file(graph_path)
    t_graph = time.perf_counter() - t0
    by_width = {}
    for mo in motifs:
        by_width.setdefault(mo.width, []).append(mo)

    # time and count through the runscan module's own names
    seen = {"batch_s": 0.0, "scan_s": 0.0, "rows": [], "wsm": 0,
            **{key: 0.0 for key in SPLIT}}
    real_scan, real_block = rs.scan_batches, rs.scan_block

    def timed(fn, key):
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            seen[key] += time.perf_counter() - t
            return out
        return call

    def scan_block(rows, *args, **kwargs):
        seen["rows"].append(rows.b)
        return real_block(rows, *args, **kwargs)

    def scan_batches(*args, **kwargs):
        t = time.perf_counter()
        with torch.profiler.record_function(SPAN):
            res = real_scan(*args, **kwargs)
            if on_card:
                torch.cuda.synchronize(dev)
        seen["scan_s"] += time.perf_counter() - t
        seen["wsm"] += int(res.hists.sum())
        return res

    rs.scan_batches, rs.scan_block = scan_batches, scan_block
    rs.batch_runs = timed(rs.batch_runs, "batch_s")
    rs._assemble_columns = timed(rs._assemble_columns, "assembly_s")
    rs._build_reports = timed(rs._build_reports, "statistics_s")
    runs._build_backbone_run = timed(runs._build_backbone_run,
                                     "backbone_run_s")
    runs.cluster_sites = rs.cluster_sites = timed(runs.cluster_sites,
                                                  "cluster_sites_s")
    for name, key in (("backbone_hits", "backbone_hits_s"),
                      ("qvalue_table", "qvalue_s"),
                      ("qvalues_from_histogram", "qvalue_s")):
        if hasattr(rs, name):
            setattr(rs, name, timed(getattr(rs, name), key))
    try:
        import grafimo_tpu_torch.assemble as asm
    except ImportError:  # a tree from before the module
        asm = None
    if hasattr(asm, "region_clusters"):  # a tree with the arrays there
        asm.region_clusters = timed(asm.region_clusters, "clusters_s")
        asm.ref_node_array = timed(asm.ref_node_array, "ref_nodes_s")
    elif asm is not None:
        runs._ref_node_array = asm._ref_node_array = timed(
            runs._ref_node_array, "ref_nodes_s")
    widths = []
    t_all = time.perf_counter()
    for k in sorted(by_width):
        ms = by_width[k]
        seen.update(batch_s=0.0, scan_s=0.0, rows=[], wsm=0,
                    **{key: 0.0 for key in SPLIT})
        for counts in (sr, hist, compact):
            counts.reset_counts()
        trace = os.path.join(work, f"trace_k{k}.json")
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if on_card
            else contextlib.nullcontext())
        t0 = time.perf_counter()
        with prof, contextlib.redirect_stdout(io.StringIO()):
            rr = rs.build_region_runs(graph, graph.chrom, [(0, graph.length)],
                                      k)
            dfs = rs.compute_results_runs(ms, rr, dev, threshold=THRESHOLD,
                                          recomb=False)
        dt = time.perf_counter() - t0
        row = {
            "k": k, "motifs": len(ms), "columns": 2 * len(ms),
            "blocks": len(seen["rows"]),
            "rows_per_block": [min(seen["rows"], default=0),
                               int(statistics.median(seen["rows"] or [0])),
                               max(seen["rows"], default=0)],
            "pass_s": dt, "batch_s": seen["batch_s"],
            "scan_s": seen["scan_s"],
            "report_s": seen["assembly_s"] + seen["statistics_s"],
            **{key: seen[key] for key in SPLIT},
            "launches": {"scan_runs_fused": sr.COUNTS["fused"],
                         "scan_runs": sr.COUNTS["kernel"],
                         "exact_hist": hist.COUNTS["kernel"],
                         "compact_hits": compact.COUNTS["kernel"],
                         "plain": sr.COUNTS["plain"] + hist.COUNTS["plain"]
                         + compact.COUNTS["plain"]},
            "hits": sum(len(d) for d in dfs.values()),
            "window_strand_motif": seen["wsm"],
            "wsm_per_scan_s": seen["wsm"] / max(seen["scan_s"], 1e-9),
            "wsm_per_pass_s": seen["wsm"] / dt,
        }
        if on_card:
            prof.export_chrome_trace(trace)
            a = _analyse(trace)
            os.remove(trace)
            row.update(scan_span_ms=a["scan_ms"],
                       device_busy_ms=a["device_busy_ms"],
                       idle_share=a["idle_share"],
                       kernel_ms=a["kernel_ms"], top_kernels=a["top_kernels"],
                       copies_htod=a["copies_htod"],
                       copies_dtoh=a["copies_dtoh"])
        widths.append(row)
        sys.stderr.write(
            f"width {k:2d}: {row['motifs']:3d} motifs, {row['columns']:3d} "
            f"columns; {row['blocks']} blocks of {row['rows_per_block']} "
            f"rows; batching {row['batch_s']:.2f}s, scan {row['scan_s']:.2f}s"
            f", report {row['report_s']:.2f}s (assembly "
            f"{row['assembly_s']:.2f}, statistics {row['statistics_s']:.2f})"
            f", pass {dt:.2f}s; launches {row['launches']}; idle share "
            f"{row.get('idle_share', float('nan')):.3f}; hits {row['hits']}; "
            f"{row['wsm_per_scan_s'] / 1e9:.2f} G window-strand-motif/s of "
            f"scan\n")
        sys.stderr.flush()
    wall = time.perf_counter() - t_all
    total = {key: sum(w[key] for w in widths)
             for key in ("blocks", "batch_s", "scan_s", "report_s", "hits",
                         "window_strand_motif") + SPLIT}
    launches = {key: sum(w["launches"][key] for w in widths)
                for key in widths[0]["launches"]}
    out = {"tree": tree, "device": device, "motifs": len(motifs),
           "widths": len(widths), "graph_length": graph.length,
           "motif_processing_s": t_motifs, "graph_load_s": t_graph,
           "ladder_wall_s": wall, **{f"total_{k}": v for k, v in
                                     total.items()},
           "launches": launches,
           "wsm_per_wall_s": total["window_strand_motif"] / wall,
           "wsm_per_scan_s": total["window_strand_motif"]
           / max(total["scan_s"], 1e-9)}
    if on_card:
        busy = sum(w["device_busy_ms"] for w in widths)
        span = sum(w["scan_span_ms"] for w in widths)
        out.update(device_busy_ms=busy, scan_span_ms=span,
                   idle_share=1.0 - busy / span)
    out["per_width"] = widths
    return out


def make_inputs(wd: str, mbp: float, n_motifs: int,
                haplotypes: int = HAPLOTYPES) -> dict:
    """The MEME file and the graph, from seed 0 as the JAX tool makes
    them (its motifs first, then its chromosome)."""
    import numpy as np

    from grafimo_tpu_torch.graph.sitegraph import build_graph
    from grafimo_tpu_torch.utils import synth

    rng = np.random.default_rng(SEED)
    meme = os.path.join(wd, "jaspar_core_like.meme")
    t0 = time.perf_counter()
    histo = synth.synth_meme(meme, n_motifs, rng)
    seq, records = synth.ladder_pangenome(rng, int(mbp * 1_000_000),
                                          haplotypes)
    graph = build_graph("c", seq, records)
    del seq, records
    path = os.path.join(wd, "c.gvt.npz")
    graph.save(path)
    return {"meme": meme, "graph": path, "variants": len(graph.sites),
            "width_histogram": dict(sorted(histo.items())),
            "inputs_s": time.perf_counter() - t0}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--mbp", type=float, default=10.0)
    ap.add_argument("--motifs", type=int, default=800)
    ap.add_argument("--out", default="")
    ap.add_argument("--one", nargs=4, metavar=("TREE", "GRAPH", "MEME",
                                                "WORK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.modules["jax"] = sys.modules["grafimo_tpu"] = None
    if args.one:
        print(json.dumps(ladder(*args.one)))
        return 0
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("bench_torch_jaspar_ladder: no CUDA device\n")
        return 1
    if args.mbp > 10 or args.motifs > 800:
        ap.error("--mbp and --motifs scale the ladder down, not up")
    sys.path.insert(0, HERE)
    card = _card()
    print(f"card: {card}", flush=True)
    results = []
    with tempfile.TemporaryDirectory(prefix="grafimo_ladder_") as wd:
        inputs = make_inputs(wd, args.mbp, args.motifs)
        print(json.dumps({"mbp": args.mbp, "haplotypes": HAPLOTYPES,
                          **inputs}), flush=True)
        for i, tree in enumerate(args.trees or [HERE]):
            work = os.path.join(wd, f"run{i}")
            os.makedirs(work)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 inputs["graph"], inputs["meme"], work],
                capture_output=True, text=True, timeout=3000)
            sys.stderr.write("".join(
                line for line in proc.stderr.splitlines(True)
                if line.startswith("width")) if proc.returncode == 0
                else proc.stderr[-6000:])
            if proc.returncode != 0:
                raise RuntimeError(f"{tree}: rc={proc.returncode}\n"
                                   f"{proc.stdout[-2000:]}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run.update(card=card, mbp=args.mbp)
            results.append(run)
            print(json.dumps({k: v for k, v in run.items()
                              if k != "per_width"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
