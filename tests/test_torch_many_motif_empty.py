"""A many-motif ``findmotif`` in which one motif has no report row, on
the CPU (ROADMAP C8): the call exits 0 and warns once, naming the motif;
each motif with rows gets the TSV, GFF3 and HTML of its run alone, byte
for byte; the motif without rows gets the same three files with a header
and no row; ``--text-only`` prints as before and writes nothing; the
counters ``report.motifs_written`` and ``report.motifs_empty`` count
them.  The reference GRAFIMO raises at the first empty motif instead."""

import re

import pandas as pd
import pytest
import torch

from grafimo_tpu_torch import spans
from grafimo_tpu_torch.cli import main as port_main

torch.set_num_threads(1)

THRESHOLD = "0.05"
# each column ties its two likeliest letters, so the best window scores
# p = (2 / 4) ** 4 = 0.0625: no window reaches p < 0.05
UNREACHABLE = """
MOTIF SYN0004.1 SYNW
letter-probability matrix: alength= 4 w= 4 nsites= 120 E= 0
 0.450000  0.450000  0.050000  0.050000
 0.050000  0.050000  0.450000  0.450000
 0.450000  0.050000  0.450000  0.050000
 0.050000  0.450000  0.050000  0.450000
"""
EMPTY = "SYN0004.1"
WITH_ROWS = ("MA0139.1", "SYN0008.1", "SYN0012.1")
SUFFIXES = ("tsv", "gff", "html")


@pytest.fixture(scope="module")
def toy(input_dir, tmp_path_factory):
    """The toy graph, a BED over all of it, ``multi.meme`` with the
    unreachable motif appended, and each motif of it in a file alone."""
    root = tmp_path_factory.mktemp("c8")
    assert port_main([
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(root / "g"),
    ]) == 0
    (root / "regions.bed").write_text("chrx\t0\t45\n")
    text = (input_dir / "multi.meme").read_text() + UNREACHABLE
    (root / "all.meme").write_text(text)
    head, *blocks = re.split(r"(?m)^(?=MOTIF )", text)
    for block in blocks:
        (root / f"{block.split()[1]}.meme").write_text(head + block)
    return root


def _findmotif(toy, meme, out, *extra):
    return port_main([
        "findmotif", "-d", str(toy / "g"), "-b", str(toy / "regions.bed"),
        "-m", str(toy / meme), "-t", THRESHOLD, "-o", str(out),
        "--device", "cpu", *extra,
    ])


@pytest.mark.parametrize("extra", [[], ["--no-qvalue"],
                                   ["--engine", "windows"]],
                         ids=["runs", "runs_noqvalue", "windows"])
def test_empty_motif_gets_a_header_only_report(toy, tmp_path, capsys,
                                               extra):
    capsys.readouterr()
    assert _findmotif(toy, "all.meme", tmp_path / "all", *extra) == 0
    err = capsys.readouterr().err
    warnings = [line for line in err.splitlines() if "C8" in line]
    assert len(warnings) == 1 and EMPTY in warnings[0], err
    counts = spans.last_call()["counts"]
    assert counts["report.motifs_written"] == len(WITH_ROWS)
    assert counts["report.motifs_empty"] == 1

    headers = set()
    for mid in WITH_ROWS:
        assert _findmotif(toy, f"{mid}.meme", tmp_path / mid, *extra) == 0
        for suffix in SUFFIXES:
            got = (tmp_path / "all" / f"grafimo_out_{mid}.{suffix}")
            alone = tmp_path / mid / f"grafimo_out.{suffix}"
            assert got.read_bytes() == alone.read_bytes(), (mid, suffix)
        tsv = (tmp_path / "all" / f"grafimo_out_{mid}.tsv").read_text()
        assert len(tsv.splitlines()) > 1, mid
        headers.add(tsv.splitlines(keepends=True)[0])
    (header,) = headers
    assert ("q-value" in header) == ("--no-qvalue" not in extra)
    empty = {s: (tmp_path / "all" / f"grafimo_out_{EMPTY}.{s}").read_text()
             for s in SUFFIXES}
    assert empty["tsv"] == header
    assert empty["gff"] == "##gff-version 3\n"
    frame = pd.read_csv(tmp_path / "all" / f"grafimo_out_{WITH_ROWS[0]}.tsv",
                        sep="\t", index_col=0)
    assert empty["html"] == frame.iloc[:0].to_html()


def test_text_only_prints_as_before(toy, tmp_path, capsys):
    """``--text-only`` prints each motif's frame, the empty one as pandas
    prints an empty frame, warns of nothing and writes no file."""
    capsys.readouterr()
    assert _findmotif(toy, "all.meme", tmp_path / "all", "--text-only") == 0
    out, err = capsys.readouterr()
    assert "C8" not in err and not (tmp_path / "all").exists()
    assert "Empty DataFrame" in out
    assert "report.motifs_empty" not in spans.last_call()["counts"]
    for mid in WITH_ROWS:
        assert _findmotif(toy, f"{mid}.meme", tmp_path / mid,
                          "--text-only") == 0
        alone = capsys.readouterr().out
        table = alone[alone.index("\n\n", alone.index("Scanned nucl")):]
        assert table.strip() and table in out, mid


def test_reference_raises_at_the_empty_motif(input_dir, toy, tmp_path):
    """The difference is the port's: the reference's run of the same
    inputs exits 1 at the motif with no row."""
    from grafimo_tpu.cli import main as ref_main

    assert ref_main([
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(tmp_path / "g"),
    ]) == 0
    assert ref_main([
        "findmotif", "-d", str(tmp_path / "g"), "-b", str(toy / "regions.bed"),
        "-m", str(toy / "all.meme"), "-t", THRESHOLD,
        "-o", str(tmp_path / "ref"),
    ]) == 1
