"""The benchmark's configuration ``jaspar800_1kgp_1mbp`` at a test's size,
on the CPU: its inputs drawn at 40 kbp with 64 of its motifs (every
width of the 800 kept), scanned by the port's CLI at ``p < 1e-6`` (most
reports empty) and ``p < 1e-4`` (most with rows), and every report
judged by the plain reference: no row, field, window count or format
apart, p- and q-values within a few float64 rounding steps; the three
spans of the many-motif path open, ``pvalue_cutoffs_s`` once a width
pass; and the committed MEME file is its generator call's output."""

import json
import os
import re

import numpy as np
import pytest
import torch

from benchmark import inputs as bench_inputs
from benchmark import run as bench_run
from benchmark import spec
from grafimo_tpu_torch import spans
from grafimo_tpu_torch.utils import synth

torch.set_num_threads(1)

CONFIG = "jaspar800_1kgp_1mbp"
LENGTH_BP = 40_000
N_MOTIFS = 64
SEED = 2**31 + 1717


def _config() -> dict:
    (entry,) = [c for c in spec.load_benchmark()["configs"]
                if c["name"] == CONFIG]
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        return json.load(f)


def _subset(meme: str, n: int) -> str:
    """The first motif of each width, then the next in file order, ``n``
    in all, in file order."""
    head, *blocks = re.split(r"(?m)^(?=MOTIF )", meme)
    widths = [int(b.split("w=")[1].split()[0]) for b in blocks]
    keep = {widths.index(w) for w in set(widths)}
    for i in range(len(blocks)):
        if len(keep) >= n:
            break
        keep.add(i)
    return head + "".join(blocks[i] for i in sorted(keep))


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    """The configuration's inputs at 40 kbp with 64 of its motifs, and
    its graph, drawn as a benchmark run draws them."""
    root = tmp_path_factory.mktemp("jaspar")
    cfg = _config()
    with open(os.path.join(spec.ROOT, cfg["motif_file"])) as f:
        meme = _subset(f.read(), N_MOTIFS)
    (root / "motifs.meme").write_text(meme)
    cfg.update(length_bp=LENGTH_BP, motif_file=str(root / "motifs.meme"))
    with open(os.path.join(spec.ROOT, "benchmark", "traffic",
                           "whole_chromosome.json")) as f:
        traffic = json.load(f)
    out = bench_inputs.make(cfg, traffic, SEED, str(root / "in"))
    out["dir"] = str(root / "in")
    return cfg, out, meme


def test_committed_meme_is_its_generator_call(tmp_path):
    path = tmp_path / "synth800.meme"
    synth.synth_meme(str(path), 800, np.random.default_rng(0))
    with open(os.path.join(spec.ROOT, _config()["motif_file"]), "rb") as f:
        assert f.read() == path.read_bytes()


def test_subset_keeps_every_width(drawn):
    _, _, meme = drawn
    with open(os.path.join(spec.ROOT, _config()["motif_file"])) as f:
        full = f.read()
    width = re.compile(r"w= (\d+)")
    assert meme.count("MOTIF ") == N_MOTIFS
    assert set(width.findall(meme)) == set(width.findall(full))
    assert len(set(width.findall(full))) == 22


@pytest.mark.parametrize("threshold", [1e-6, 1e-4])
def test_reports_agree_with_the_reference(drawn, tmp_path, monkeypatch,
                                          threshold):
    """The reports, empty and not, as the reference has them; the
    many-motif spans open, ``pvalue_cutoffs_s`` once a width pass."""
    cfg, inputs, meme = drawn
    opened = []
    enter = spans.span.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(spans.span, "__enter__", counted)
    outdir = str(tmp_path / "out")
    rc, text, err = bench_run.findmotif(inputs, threshold, outdir, "cpu")
    assert rc == 0, err[-2000:]
    monkeypatch.setattr(spans.span, "__enter__", enter)
    widths = len(set(re.findall(r"w= (\d+)", meme)))
    counts = spans.last_call()["counts"]
    assert counts["scan.width_passes"] == widths
    assert opened.count("pvalue_cutoffs_s") == widths
    written, empty = (counts["report.motifs_written"],
                      counts["report.motifs_empty"])
    assert written + empty == N_MOTIFS
    assert opened.count("report_empty_s") == empty
    assert opened.count("qvalue_tables_s") == written
    assert (empty > N_MOTIFS // 2) == (threshold < 1e-5), (written, empty)
    assert written > 0 and empty > 0

    numbers, work = bench_run.judge(inputs, dict(cfg, threshold=threshold),
                                    [(outdir, text)])
    exact = {n: v for n, v in numbers.items() if not n.endswith("_rel_err")}
    assert all(v == 0 for v in exact.values()), numbers
    # the port sums a p-value's tail in the reference GRAFIMO's order,
    # the plain reference in its own: the two differ in the last bits
    assert numbers["pvalue_rel_err"] < 1e-12, numbers
    assert numbers["qvalue_rel_err"] < 1e-12, numbers
    assert sorted(work["windows_per_strand"]) == sorted(
        int(w) for w in set(re.findall(r"w= (\d+)", meme)))
