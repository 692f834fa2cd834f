#!/usr/bin/env python3
"""Chromosome-scale run of the port (BASELINE configs 1, 2 and 4) on one
card.

    python3 tools/bench_torch_chrom_scale.py [--mbp 50]
        [--encode-regions 0] [--dir 0] [--dir-mbp 8] [--seed 0]
        [--workdir DIR] [--reuse] [--check-cpu] [TREE ...]

The port's counterpart of ``tools/bench_chrom_scale.py``, with its
inputs: a ``--mbp`` Mbp chromosome ``21`` at the 1KGP profile (variants
every 30 bp, 12% indels, rare-skewed allele frequencies, 5096
haplotypes, three MHC-like pockets at 5x density) as a FASTA and a BGZF
VCF; ``--encode-regions`` 270 bp regions drawn from seed 7
(``encode_like.bed``, the reference's headline workload shape: CTCF over
3,000 ENCODE peaks); and ``--dir`` pocket-free ``--dir-mbp`` Mbp
chromosomes ``d1``..``dN``.  They are drawn from ``--seed`` in the JAX
tool's order and written by ``grafimo_tpu_torch/utils/synth.py``, so
with the same arguments every input file is the JAX tool's byte for
byte (as in that tool, ``--reuse`` skips the main chromosome's draws
when its graph exists, so the directory's chromosomes then come from the
seed's first draws).

Every phase is the port's CLI (``python -m grafimo_tpu_torch``) in its
own interpreter, with JAX and the reference package blocked:
``buildvg --reindex`` of the chromosome; the whole-chromosome CTCF
(MA0139.1) ``findmotif`` on ``--device cuda``, twice, whose reports
must be equal; the ENCODE-shaped BED; ``buildvg`` of each directory
chromosome into the same graph directory and one ``findmotif -d`` over
them all (q-values over the merged hit set).  Each TREE (a checkout of
this repository, default this one) runs every ``findmotif`` with its own
port, in the order listed, once each (list trees in turns to compare two
versions on one card, e.g. ``PARENT . . PARENT``); the inputs and graphs
are this checkout's, made once, and every report must be equal across
trees and runs.  Each ``findmotif`` prints
its wall, peak RSS, peak device memory, ``Scanned sequences``, the
``run scan:`` line's windows/strand and raw hits, its slice blocks and
flush blocks (``runscan.plan_slices``), its device->host reads
(``runscan.READS``), its launches by route (``ops/score_runs.COUNTS``,
``ops/hist.COUNTS``, ``ops/compact.COUNTS``), its hits, and the split
of its wall: graph load, host batching, scan, hit assembly, statistics,
report writing.  Within hit assembly and statistics, each function a
tree has: ``backbone_run_s`` (``graph/runs._build_backbone_run``, reached
only for runs cached by the Python extraction or rebuilt after a
checkpoint), ``cluster_sites_s`` (``graph/runs.cluster_sites``),
``backbone_hits_s`` (``assemble.backbone_hits``, the first reference
node array build included), ``ref_nodes_s`` (the reference node array:
``graph/runs._ref_node_array``, or ``assemble.ref_node_array`` in a tree
that has it) and, in such a tree, ``clusters_s``
(``assemble.region_clusters``, whose memo its ``cluster_sites`` calls
then read); ``qvalue_s`` is the q-value tables on either route.  With ``--check-cpu`` each ``findmotif`` runs once more on
``--device cpu`` and its TSV and GFF3 must equal the card's byte for
byte; the timed runs stay on the card.  The tool exits non-zero when a
run fails or a check does not hold: reports that differ, a plain
version launched on the card, flush reads that are not one a flush
block.  It prints the card's name and power limit first and one JSON
object of every number last.  Needs a CUDA card; exits 1 without one.
"""

import argparse
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAPLOTYPES = 5096  # 2548 diploid samples, the 1KGP panel
K = 19
MOTIF = os.path.join(HERE, "tests", "data", "input", "MA0139.1.meme")

# the port's CLI in a fresh interpreter with JAX and the reference
# blocked, its phases timed through the module names it calls them by;
# one "BENCH {json}" line on stderr at the end
CLI_PROG = r"""
import sys
sys.modules['jax'] = sys.modules['grafimo_tpu'] = None
import json, resource, time
import torch
import grafimo_tpu_torch.graph.runs as runs
import grafimo_tpu_torch.runscan as rs
import grafimo_tpu_torch.workflows as wf
from grafimo_tpu_torch.cli import main
from grafimo_tpu_torch.ops import compact, hist
from grafimo_tpu_torch.ops import score_runs as sr

seen = {'slices': 0, 'flush_blocks': 0, 'devices': 0}

def timed(mod, name, key):
    real = getattr(mod, name)
    seen[key] = 0.0
    def call(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            seen[key] += time.perf_counter() - t
    setattr(mod, name, call)

real_plan = rs.plan_slices
def plan_slices(batches, k, m, comp_size, devices):
    plan = real_plan(batches, k, m, comp_size, devices)
    seen['slices'] += len(plan)
    seen['flush_blocks'] += sum(flush for *_, flush in plan)
    seen['devices'] = len(rs._as_devices(devices))
    return plan
rs.plan_slices = plan_slices
timed(wf, '_load_graphs', 'graph_load_s')
timed(rs, 'batch_runs', 'batching_s')
timed(rs, 'scan_batches', 'scan_s')
timed(rs, '_assemble_columns', 'hit_assembly_s')
timed(runs, '_build_backbone_run', 'backbone_run_s')
timed(runs, 'cluster_sites', 'cluster_sites_s')
rs.cluster_sites = runs.cluster_sites
# the assembly route of grafimo_tpu_torch/assemble.py, where the tree has it
for name, key in (('backbone_hits', 'backbone_hits_s'),
                  ('qvalue_table', 'qvalue_s'),
                  ('qvalues_from_histogram', 'qvalue_s')):
    if hasattr(rs, name):
        timed(rs, name, key)
try:
    import grafimo_tpu_torch.assemble as asm
except ImportError:
    asm = None
if hasattr(asm, 'region_clusters'):
    timed(asm, 'region_clusters', 'clusters_s')
    timed(asm, 'ref_node_array', 'ref_nodes_s')
elif asm is not None:
    timed(runs, '_ref_node_array', 'ref_nodes_s')
    asm._ref_node_array = runs._ref_node_array
timed(rs, '_build_reports', 'statistics_s')
timed(wf, 'write_results', 'report_write_s')
rc = main(sys.argv[1:])
seen['maxrss_gb'] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
if torch.cuda.is_initialized():
    seen['device_peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    seen['device_reserved_gib'] = torch.cuda.max_memory_reserved() / 2**30
seen['reads'] = dict(rs.READS)
seen['launches'] = {
    'scan_runs_fused': sr.COUNTS['fused'], 'scan_runs': sr.COUNTS['kernel'],
    'exact_hist': hist.COUNTS['kernel'],
    'compact_hits': compact.COUNTS['kernel'],
    'plain': sr.COUNTS['plain'] + hist.COUNTS['plain']
    + compact.COUNTS['plain']}
sys.stderr.write('BENCH ' + json.dumps(seen) + '\n')
sys.exit(rc)
"""

# a tree's kernels and C++ engine built before its first timed run
WARM_PROG = r"""
import sys
sys.modules['jax'] = sys.modules['grafimo_tpu'] = None
from grafimo_tpu_torch import kernels, native
kernels.load()
native._lib()
"""

RUN_SCAN = re.compile(r"run scan: (\d+) device batches, (\d+) windows/strand, "
                      r"(\d+) raw hits \(([\d.]+)s\)")
PHASES = ("graph_load_s", "batching_s", "scan_s", "hit_assembly_s",
          "statistics_s", "report_write_s")


def log(msg: str) -> None:
    sys.stderr.write(f"# {msg}\n")
    sys.stderr.flush()


SPLIT = ("backbone_run_s", "cluster_sites_s", "backbone_hits_s",
         "clusters_s", "ref_nodes_s", "qvalue_s")


def run_cli(args, timeout=7200, tree=HERE) -> dict:
    """``tree``'s port's CLI with ``args`` in a fresh interpreter: its
    wall, its stdout and the numbers of its ``BENCH`` line; raises on
    failure."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_PROG, *args], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    bench = [ln for ln in proc.stderr.splitlines() if ln.startswith("BENCH ")]
    if proc.returncode != 0 or not bench:
        raise RuntimeError(f"{args[:1]} failed rc={proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    out = json.loads(bench[-1][len("BENCH "):])
    out.update(wall_s=wall, stdout=proc.stdout)
    return out


def write_inputs(wd: str, mbp: float, encode_regions: int, n_dir: int,
                 dir_mbp: float, seed: int, reuse: bool,
                 haplotypes: int = HAPLOTYPES) -> dict:
    """Every input of a run, drawn in ``tools/bench_chrom_scale.py``'s
    order (``:221-345``): the main chromosome from ``seed`` (skipped by
    ``reuse`` when ``graphs/21.gvt.npz`` exists), ``encode_like.bed``
    from seed 7, then the directory's chromosomes from the main draws'
    generator.  Returns the counts drawn and the directory's names and
    lengths."""
    from grafimo_tpu_torch.utils import synth

    L = int(mbp * 1e6)
    rng = np.random.default_rng(seed)
    out = {"length": L}
    if reuse and os.path.isfile(os.path.join(wd, "graphs", "21.gvt.npz")):
        out["reused"] = True
    else:
        t0 = time.perf_counter()
        seq, pos, pockets = synth.synth_chrom(rng, L, haplotypes)
        variants, n_indel = synth.make_variants(rng, seq, pos, haplotypes)
        out.update(n_variants=len(variants), n_indels=n_indel,
                   pockets=pockets)
        synth.write_fasta(os.path.join(wd, "ref.fa"), "21", seq)
        synth.write_vcf(os.path.join(wd, "synth.vcf.gz"), "21", seq,
                        variants, haplotypes)
        del seq, pos, variants
        out["synth_s"] = time.perf_counter() - t0
        out["vcf_bytes"] = os.path.getsize(os.path.join(wd, "synth.vcf.gz"))
    if encode_regions:
        synth.encode_like_bed(os.path.join(wd, "encode_like.bed"), L,
                              encode_regions)
    t0 = time.perf_counter()
    names = []
    for i in range(n_dir):
        Ld = int(dir_mbp * 1e6)
        # pocket-free: the main chromosome holds the pockets
        seq, pos, _ = synth.synth_chrom(rng, Ld, haplotypes, pockets=0)
        variants, _ = synth.make_variants(rng, seq, pos, haplotypes)
        name = f"d{i + 1}"
        synth.write_fasta(os.path.join(wd, f"{name}.fa"), name, seq)
        synth.write_vcf(os.path.join(wd, f"{name}.vcf.gz"), name, seq,
                        variants, haplotypes)
        names.append((name, Ld))
    if n_dir:
        out["dir_synth_s"] = time.perf_counter() - t0
        with open(os.path.join(wd, "dir.bed"), "w") as f:
            for name, Ld in names:
                f.write(f"chr{name}\t0\t{Ld}\n")
    out["dir"] = names
    return out


def _report_bytes(outdir: str) -> bytes:
    blob = b""
    for name in ("grafimo_out.tsv", "grafimo_out.gff"):
        with open(os.path.join(outdir, name), "rb") as f:
            blob += f.read()
    return blob


def findmotif(gdir: str, bed: str, outdir: str, device: str,
              tree: str = HERE) -> dict:
    """One ``findmotif`` of CTCF over ``bed`` on ``device`` (the JAX
    tool's flags) by ``tree``'s port: its numbers, checked."""
    r = run_cli(["findmotif", "-d", gdir, "-b", bed, "-m", MOTIF,
                 "-o", outdir, "--verbose", "--device", device, "--debug"],
                tree=tree)
    r["tree"] = tree
    text = r.pop("stdout")
    m = RUN_SCAN.findall(text)
    scanned = [int(ln.split()[-1]) for ln in text.splitlines()
               if ln.startswith("Scanned sequences")]
    if not m or not scanned:
        raise RuntimeError(f"findmotif printed no run-scan summary:\n"
                           f"{text[-2000:]}")
    with open(os.path.join(outdir, "grafimo_out.tsv")) as f:
        r["hits"] = sum(1 for _ in f) - 1
    r.update(device=device, scanned_sequences=sum(scanned),
             windows_per_strand=sum(int(g[1]) for g in m),
             raw_hits=sum(int(g[2]) for g in m),
             wire=[ln for ln in text.splitlines() if ln.startswith("wire:")])
    r["other_s"] = r["wall_s"] - sum(r[p] for p in PHASES)
    want = r["flush_blocks"] * r["devices"]
    if r["reads"]["flush"] != want or r["reads"]["hist"] != r["devices"]:
        raise RuntimeError(f"{bed} on {device}: reads {r['reads']}, want "
                           f"{want} flush reads and {r['devices']} histogram")
    la = r["launches"]
    if device == "cuda" and (
            la["plain"] or la["scan_runs_fused"] + la["scan_runs"]
            != r["slices"] * r["devices"]):
        raise RuntimeError(f"{bed} on cuda: launches {la} for {r['slices']} "
                           f"slices; want one kernel launch a slice block "
                           f"and no plain version")
    log(f"findmotif {os.path.basename(bed)} on {device}: "
        f"{r['wall_s']:.1f}s, {r['hits']} hits, "
        f"{r['windows_per_strand']} windows/strand, {r['slices']} slices, "
        f"{r['flush_blocks']} flush blocks, reads {r['reads']}, launches "
        f"{la}, RSS {r['maxrss_gb']:.2f} GB, device peak "
        f"{r.get('device_peak_gib', 0.0):.2f} GiB; "
        + ", ".join(f"{p} {r[p]:.1f}" for p in PHASES)
        + "".join(f", {p} {r[p]:.2f}" for p in SPLIT if p in r)
        + f"; {tree}")
    return r


def scan_leg(gdir: str, bed: str, outdir: str, reps: int,
             check_cpu: bool, trees=(HERE,)) -> dict:
    """``reps`` runs of each tree in turn on the card, reports equal
    across them, then with ``check_cpu`` one on the CPU whose TSV and
    GFF3 must be the card's."""
    runs = [findmotif(gdir, bed, f"{outdir}_rep{rep}_{i}", "cuda", tree)
            for rep in range(reps) for i, tree in enumerate(trees)]
    first = _report_bytes(f"{outdir}_rep0_0")
    if any(_report_bytes(f"{outdir}_rep{rep}_{i}") != first
           for rep in range(reps) for i in range(len(trees))):
        raise RuntimeError(f"{bed}: reports differ between runs")
    leg = {"runs": runs}
    if check_cpu:
        cpu = findmotif(gdir, bed, f"{outdir}_cpu", "cpu")
        if _report_bytes(f"{outdir}_cpu") != first:
            raise RuntimeError(f"{bed}: cuda and cpu reports differ")
        leg["cpu"] = cpu
        leg["cpu_identical"] = True
        log(f"{os.path.basename(bed)}: cuda TSV and GFF3 byte-identical to "
            f"cpu's")
    return leg


def buildvg(fasta: str, vcf: str, gdir: str, reindex: bool) -> dict:
    r = run_cli(["buildvg", "-l", fasta, "-v", vcf, "-o", gdir]
                + (["--reindex", "--verbose"] if reindex else []))
    r.pop("stdout")
    return {"wall_s": r["wall_s"], "maxrss_gb": r["maxrss_gb"]}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mbp", type=float, default=50.0)
    ap.add_argument("--dir", type=int, default=0,
                    help="chromosomes for a directory scan")
    ap.add_argument("--dir-mbp", type=float, default=8.0)
    ap.add_argument("--encode-regions", type=int, default=0,
                    help="also scan N regions of 270 bp (seed 7)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "grafimo_torch_scale"))
    ap.add_argument("--reuse", action="store_true",
                    help="reuse the chromosome's graph in --workdir")
    ap.add_argument("--check-cpu", action="store_true",
                    help="rerun each findmotif on the CPU and compare")
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("bench_torch_chrom_scale: torch sees no CUDA "
                         "device\n")
        return 1
    card = _card()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, HERE)
    from grafimo_tpu_torch import kernels

    trees = [os.path.abspath(t) for t in args.trees] or [HERE]
    t0 = time.perf_counter()
    kernels.load()  # the build once, outside every timed run
    for tree in sorted(set(trees) - {HERE}):  # other trees' builds too
        subprocess.run([sys.executable, "-c", WARM_PROG], cwd=tree,
                       check=True, timeout=1800)
    reps = 2 if len(trees) == 1 else 1
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    gdir = os.path.join(wd, "graphs")
    out = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "mbp": args.mbp, "haplotypes": HAPLOTYPES, "k": K,
           "seed": args.seed, "kernel_build_s": time.perf_counter() - t0,
           "nproc": os.cpu_count()}
    inputs = write_inputs(wd, args.mbp, args.encode_regions, args.dir,
                          args.dir_mbp, args.seed, args.reuse)
    out["inputs"] = {k: v for k, v in inputs.items() if k != "dir"}
    log(f"inputs: {out['inputs']}")
    if not inputs.get("reused"):
        out["buildvg"] = buildvg(os.path.join(wd, "ref.fa"),
                                 os.path.join(wd, "synth.vcf.gz"), gdir,
                                 reindex=True)
        out["gvt_bytes"] = os.path.getsize(os.path.join(gdir, "21.gvt.npz"))
        log(f"buildvg: {out['buildvg']}")
    whole = os.path.join(wd, "whole.bed")
    with open(whole, "w") as f:
        f.write(f"chr21\t0\t{inputs['length']}\n")
    out["trees"] = trees
    out["scan"] = scan_leg(gdir, whole, os.path.join(wd, "out_whole"), reps,
                           args.check_cpu, trees)
    log(f"so far: {json.dumps(out)}")
    if args.encode_regions:
        out["encode_scan"] = scan_leg(
            gdir, os.path.join(wd, "encode_like.bed"),
            os.path.join(wd, "out_encode"), 1, args.check_cpu, trees)
        out["encode_scan"]["regions"] = args.encode_regions
        log(f"so far: {json.dumps(out)}")
    if args.dir:
        t0 = time.perf_counter()
        for name, _ in inputs["dir"]:
            buildvg(os.path.join(wd, f"{name}.fa"),
                    os.path.join(wd, f"{name}.vcf.gz"), gdir, reindex=False)
        out["dir_build_s"] = time.perf_counter() - t0
        out["dir_scan"] = scan_leg(gdir, os.path.join(wd, "dir.bed"),
                                   os.path.join(wd, "out_dir"), 1,
                                   args.check_cpu, trees)
        out["dir_scan"].update(chroms=args.dir, mbp_each=args.dir_mbp)
    out["tool_maxrss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # the tool's own process runs without JAX and the reference, as its
    # CLI runs do
    sys.modules["jax"] = sys.modules["grafimo_tpu"] = None
    sys.exit(main())
