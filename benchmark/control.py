"""The control of the comparison: the plain reference put in the port's
place with its p-values, q-values and score distribution in float32, the
precision below the float64 the configuration states.  ``correct`` has
to come out false for it.

    python3 benchmark/control.py --workload CELL --seed N [--seed M ...]

For each seed, draws the cell's inputs (without the graph: nothing of
the port runs), writes the float32 reference's rows as the report writer
lays them out, with its window counts as ``findmotif`` prints them, and
judges them as ``benchmark/run.py`` judges a run's reports.  Prints one
JSON line a seed: the compared numbers and whether they pass the limits.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pandas as pd

HERE = os.path.dirname(os.path.abspath(__file__))


def write_report(rows: dict, outdir: str) -> None:
    """``rows`` (a motif's reference columns) as the port's writer saves
    a report: the frame sorted by p-value, tab-separated, indexed."""
    from benchmark.compare import COLUMNS, report_files

    os.makedirs(outdir, exist_ok=True)
    for mid, path in report_files(outdir, list(rows)).items():
        df = pd.DataFrame(rows[mid], columns=COLUMNS)
        df = df.sort_values(["p-value"]).reset_index(drop=True)
        df.to_csv(path, sep="\t", encoding="utf-8")


def control(cell: dict, seed: int, workdir: str, dtype=np.float32) -> dict:
    """The compared numbers of the reference in ``dtype`` put in the
    port's place, on ``seed``'s inputs of ``cell``."""
    from benchmark import compare, inputs, reference

    with open(cell["config_path"]) as f:
        config = json.load(f)
    with open(cell["traffic_path"]) as f:
        traffic = json.load(f)
    inputs.make(config, traffic, seed, workdir, graph=False)
    truth = os.path.join(workdir, "truth.npz")
    with open(os.path.join(workdir, "motifs.meme")) as f:
        meme = f.read()
    want = reference.report(truth, meme, config["chrom"],
                            config["threshold"], np.float64)
    low = reference.report(truth, meme, config["chrom"],
                           config["threshold"], dtype)
    outdir = os.path.join(workdir, "control")
    write_report(low["rows"], outdir)
    stdout = "".join(f"Scanned sequences:\t{2 * n}\n" for _, n in
                     sorted(low["work"]["windows_per_strand"].items()))
    numbers = compare.judge([(outdir, stdout)], want["rows"],
                            want["work"]["windows_per_strand"])
    return {"seed": seed, "numbers": numbers,
            "passes": compare.verdict(numbers, config["limits"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark import spec

    cell = spec.cell(args.workload)
    for seed in args.seed:
        workdir = tempfile.mkdtemp(prefix=f"grafimo_control_{seed}_")
        try:
            print(json.dumps(control(cell, seed, workdir)), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
