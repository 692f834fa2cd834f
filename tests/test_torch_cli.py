"""The port's CLI (``python -m grafimo_tpu_torch``) against the
reference's on the toy data: byte-identical TSV and GFF3 reports, a run
with JAX blocked from import, and the loud failures (no card behind
``--device cuda``, options not ported yet)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from grafimo_tpu.cli import main as ref_main
from grafimo_tpu_torch.cli import main as port_main

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# the flows of tests/test_cli_end_to_end.py:23, :70 and :99; the
# --text-only flows write their reports instead, so they can be compared
FLOWS = {
    "dir_jaspar_topgraphs": (
        "-d", ["-m", "MA0139.1.jaspar", "-t", "1", "--recomb",
               "--top-graphs", "1"]),
    "single_graph_meme": (
        "-g", ["-m", "MA0139.1.meme", "-t", "1", "--recomb"]),
    "noreverse_noqvalue": (
        "-d", ["-m", "MA0139.1.meme", "-t", "1", "--recomb", "--no-reverse",
               "--no-qvalue"]),
}


def _build(main, input_dir, outdir):
    assert main([
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(outdir),
    ]) == 0
    return outdir


def _findmotif_args(input_dir, graph_dir, bed, flow, outdir):
    src, rest = FLOWS[flow]
    graph = str(graph_dir / "x.gvt.npz") if src == "-g" else str(graph_dir)
    rest = [str(input_dir / a) if a.startswith("MA0139") else a for a in rest]
    return ["findmotif", src, graph, "-b", str(bed), *rest, "-o", str(outdir)]


@pytest.fixture()
def toy_bed(tmp_path):
    bed = tmp_path / "regions.bed"
    bed.write_text("chrx\t0\t20\n")
    return bed


@pytest.mark.parametrize("flow", list(FLOWS))
def test_reports_byte_identical(input_dir, tmp_path, toy_bed, flow,
                                monkeypatch):
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    g_port = _build(port_main, input_dir, tmp_path / "g_port")
    g_ref = _build(ref_main, input_dir, tmp_path / "g_ref")
    assert port_main([
        *_findmotif_args(input_dir, g_port, toy_bed, flow, tmp_path / "port"),
        "--device", "cpu",
    ]) == 0
    assert ref_main(
        _findmotif_args(input_dir, g_ref, toy_bed, flow, tmp_path / "ref")
    ) == 0
    for name in ("grafimo_out.tsv", "grafimo_out.gff"):
        got = (tmp_path / "port" / name).read_bytes()
        assert len(got.splitlines()) > 1
        assert got == (tmp_path / "ref" / name).read_bytes(), name
    if flow == "dir_jaspar_topgraphs":
        assert (tmp_path / "port" / "top_graphs" / "x:0-20.dot").read_bytes() \
            == (tmp_path / "ref" / "top_graphs" / "x:0-20.dot").read_bytes()


def test_cli_runs_with_jax_blocked(input_dir, tmp_path, toy_bed):
    """The port never imports jax: in a fresh interpreter where importing
    jax fails, buildvg + findmotif run and write the reference's TSV."""
    prog = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any later 'import jax' raises
        "from grafimo_tpu_torch.cli import main\n"
        "args = sys.argv[1:]\n"
        "rc = main(args[:7]) or main(args[7:])\n"
        "sys.exit(rc)\n"
    )
    graphs = tmp_path / "g"
    args = [
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(graphs),
        *_findmotif_args(input_dir, graphs, toy_bed, "dir_jaspar_topgraphs",
                         tmp_path / "port"),
        "--device", "cpu", "--debug",
    ]
    proc = subprocess.run(
        [sys.executable, "-c", prog, *args], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    g_ref = _build(ref_main, input_dir, tmp_path / "g_ref")
    assert ref_main(_findmotif_args(
        input_dir, g_ref, toy_bed, "dir_jaspar_topgraphs", tmp_path / "ref"
    )) == 0
    assert (tmp_path / "port" / "grafimo_out.tsv").read_bytes() == (
        tmp_path / "ref" / "grafimo_out.tsv"
    ).read_bytes()


def test_cuda_without_a_card_fails_loudly(input_dir, tmp_path, toy_bed,
                                          monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graphs = _build(port_main, input_dir, tmp_path / "g")
    out = tmp_path / "out"
    rc = port_main(_findmotif_args(input_dir, graphs, toy_bed,
                                   "single_graph_meme", out))
    assert rc == 1
    assert "--device cuda: torch sees no CUDA device" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize(
    "extra,item",
    [
        (["--engine", "windows"], "A11"),
        (["--profile", "prof"], "A15"),
        (["--coordinator", "localhost:1234"], "A13"),
        (["--num-processes", "2"], "A13"),
        (["--process-id", "0"], "A13"),
    ],
)
def test_unported_options_fail_loudly(input_dir, tmp_path, toy_bed, capsys,
                                      extra, item):
    graphs = _build(port_main, input_dir, tmp_path / "g")
    out = tmp_path / "out"
    rc = port_main([
        *_findmotif_args(input_dir, graphs, toy_bed, "single_graph_meme", out),
        "--device", "cpu", *extra,
    ])
    assert rc == 1
    assert f"ROADMAP {item}" in capsys.readouterr().err
    assert not out.exists()


def test_buildvg_export_fails_loudly(input_dir, tmp_path, capsys):
    """The reference's --export calls an undefined _export_graph; the
    port rejects the option before building anything."""
    out = tmp_path / "g"
    rc = port_main([
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(out),
        "--export", "gfa",
    ])
    assert rc == 1
    assert "ROADMAP C4" in capsys.readouterr().err
    assert not out.exists()


def test_package_has_no_jax_import():
    """No module of the port imports jax, directly or at function level."""
    pkg = REPO / "grafimo_tpu_torch"
    for path in pkg.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] != "jax", (path, name)
                # jax-importing reference modules stay out of reach
                assert not name.startswith((
                    "grafimo_tpu.ops", "grafimo_tpu.runscan",
                    "grafimo_tpu.workflows", "grafimo_tpu.scan",
                    "grafimo_tpu.parallel", "grafimo_tpu.windows",
                    "grafimo_tpu.graph.extract",
                )), (path, name)
    assert os.path.isfile(pkg / "csrc" / "hist.cu")
