#!/usr/bin/env python3
"""The whole-chromosome backbone tail of the 50 Mbp scale run, at a small
size on the CPU, through several trees of this repo.

    python3 tools/check_strided_tail.py --workdir DIR --out FILE.json
        TREE [TREE ...]
    python3 tools/check_strided_tail.py --count TSV [--mbp 50]
        [--haplotypes 5096] [--slice-rows 4096]

The 50 Mbp chromosome of ``tools/bench_chrom_scale.py`` ends in a
backbone tail whose remainder chunk re-lands in the top bucket (R =
4096, k = 19 for CTCF): the last backbone row starts one stride after
the one before it, so the strided span decode of the last slice reads
about 2R codes past the chromosome's end.  The first form draws that
tool's inputs (seed 0, 64 haplotypes, ``grafimo_tpu_torch/utils/synth.py``)
at the length nearest 0.8 Mbp whose backbone remainder is the 50 Mbp
chromosome's, so the tail geometry is the same, and runs ``buildvg``
and a whole-chromosome CTCF ``findmotif`` through each TREE's JAX
package (``python -m grafimo_tpu``, jax CPU backend, one device so the
strided kernel runs; the CPU's slice cap, 2^19 bases, gives 128 rows a
slice) and through this checkout's port on ``--device cpu``.  Each TREE
is an unpacked commit of this repo (``git archive``).  For each run it
prints the hit count and, against the port's TSV (rows compared without
their q-values, which move with the hit set), the hits it lacks and
adds, how many of those lie in the last strided slice, and how many of
the port's hits there are backbone hits: the reference sequence on
every haplotype, which only backbone rows score.

The second form counts, in a whole-chromosome TSV of ``--mbp``, the
hits and the backbone hits whose windows start in the last slice of
``--slice-rows`` backbone rows (4096: the JAX package's 2^24-base cap
over R on a TPU).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOTIF = os.path.join(HERE, "tests", "data", "input", "MA0139.1.meme")
K, R = 19, 4096          # CTCF's width; the top run bucket
STRIDE = R - K + 1
CPU_SLICE_ROWS = (1 << 19) // R  # the JAX package's CPU cap over R
TPU_SLICE_ROWS = (1 << 24) // R  # and its TPU cap
HAPLOTYPES, SEED = 64, 0
BLOCK = "import sys; sys.modules['jax'] = sys.modules['grafimo_tpu'] = None\n"


def tail_length(like_mbp: float, near_mbp: float) -> int:
    """The chromosome length nearest ``near_mbp`` (not below it) whose
    backbone remainder ``(L - K + 1) % STRIDE`` is ``like_mbp``'s."""
    like = int(like_mbp * 1e6)
    n = (like - int(near_mbp * 1e6)) // STRIDE
    return like - n * STRIDE


def run(cmd, cwd, env=None) -> None:
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{cmd[:4]} in {cwd}: rc {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def hits(tsv: str) -> set:
    """The hit rows of a TSV as tuples, less the running index and the
    q-value."""
    out = set()
    with open(tsv) as f:
        for ln in f.read().splitlines()[1:]:
            row = ln.split("\t")[1:]
            del row[8]
            out.add(tuple(row))
    return out


def in_last_slice(row: tuple, L: int, slice_rows: int) -> bool:
    """Whether a hit's window starts in the last strided slice."""
    backbone = (L - K + 1 + STRIDE - 1) // STRIDE
    first = (backbone - 1) // slice_rows * slice_rows
    start, stop = int(row[3]), int(row[4])
    return min(start, stop) - 1 >= first * STRIDE


def backbone_hit(row: tuple, haplotypes: int) -> bool:
    """The reference sequence on every haplotype: a window no variant
    touches, scored by backbone rows only."""
    return row[-1] == "ref" and row[-2] == str(haplotypes)


def tail_counts(rows: set, L: int, slice_rows: int, haplotypes: int) -> dict:
    last = [r for r in rows if in_last_slice(r, L, slice_rows)]
    return {"hits": len(rows), "in_last_slice": len(last),
            "backbone_in_last_slice": sum(backbone_hit(r, haplotypes)
                                          for r in last)}


def compare_trees(args) -> dict:
    sys.path.insert(0, HERE)
    from grafimo_tpu_torch.utils import synth

    L = tail_length(50.0, 0.8)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(SEED)
    seq, pos, _ = synth.synth_chrom(rng, L, HAPLOTYPES)
    variants, _ = synth.make_variants(rng, seq, pos, HAPLOTYPES)
    fa, vcf = os.path.join(wd, "ref.fa"), os.path.join(wd, "synth.vcf.gz")
    synth.write_fasta(fa, "21", seq)
    synth.write_vcf(vcf, "21", seq, variants, HAPLOTYPES)
    bed = os.path.join(wd, "whole.bed")
    with open(bed, "w") as f:
        f.write(f"chr21\t0\t{L}\n")
    out = {"length": L, "remainder": (L - K + 1) % STRIDE,
           "backbone_rows": (L - K + 1 + STRIDE - 1) // STRIDE,
           "slice_rows": CPU_SLICE_ROWS, "runs": {}}

    env = dict(os.environ, JAX_PLATFORMS="cpu", GRAFIMO_TPU_SINGLE_DEVICE="1")
    legs = [("port", HERE, [sys.executable, "-c", BLOCK
             + "from grafimo_tpu_torch.cli import main; "
             "sys.exit(main(sys.argv[1:]))"], ["--device", "cpu"])]
    legs += [(os.path.basename(os.path.abspath(t)), os.path.abspath(t),
              [sys.executable, "-m", "grafimo_tpu"], []) for t in args.trees]
    got = {}
    for name, cwd, cli, extra in legs:
        g, o = os.path.join(wd, f"g_{name}"), os.path.join(wd, f"o_{name}")
        run(cli + ["buildvg", "-l", fa, "-v", vcf, "-o", g, "--reindex"],
            cwd, env)
        run(cli + ["findmotif", "-d", g, "-b", bed, "-m", MOTIF, "-o", o]
            + extra, cwd, env)
        got[name] = hits(os.path.join(o, "grafimo_out.tsv"))
    port = got["port"]
    for name, rows in got.items():
        lacks, adds = port - rows, rows - port
        out["runs"][name] = {
            **tail_counts(rows, L, CPU_SLICE_ROWS, HAPLOTYPES),
            "lacks": len(lacks), "adds": len(adds),
            **{f"{what}_{k}": v for what, diff in (("lacks", lacks),
                                                   ("adds", adds))
               for k, v in tail_counts(diff, L, CPU_SLICE_ROWS,
                                       HAPLOTYPES).items()
               if k != "hits"}}
        print(name, json.dumps(out["runs"][name]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--workdir")
    ap.add_argument("--out")
    ap.add_argument("--count", metavar="TSV")
    ap.add_argument("--mbp", type=float, default=50.0)
    ap.add_argument("--haplotypes", type=int, default=5096)
    ap.add_argument("--slice-rows", type=int, default=TPU_SLICE_ROWS)
    args = ap.parse_args()
    if args.count:
        L = int(args.mbp * 1e6)
        out = {"length": L, "slice_rows": args.slice_rows,
               "backbone_rows": (L - K + 1 + STRIDE - 1) // STRIDE,
               **tail_counts(hits(args.count), L, args.slice_rows,
                             args.haplotypes)}
    else:
        if not args.trees or not args.workdir:
            ap.error("give TREEs and --workdir, or --count TSV")
        out = compare_trees(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
