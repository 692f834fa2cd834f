"""The port's CLI (``python -m grafimo_tpu_torch``) against the
reference's on the toy data: byte-identical TSV, GFF3 and HTML reports
from both engines, the two engines against each other, a run with JAX blocked
from import, ``--profile``, and the loud failures (no card behind
``--device cuda``, multi-host flags missing their settings, the window
engine over several processes, ``buildvg --export``)."""

import ast
import os
import pathlib
import subprocess
import sys

import pandas as pd
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
# the same flows through the per-window engine
FLOWS.update({
    f"windows_{name}": (src, [*rest, "--engine", "windows"])
    for name, (src, rest) in list(FLOWS.items())
})
# flows a CLI differential found unheld by the ones above: the
# tutorial's data with its background file on both engines, its
# chromosome filter and name maps, a pseudocount, TRANSFAC and PFM motifs with -q -r, and the vg-built
# inputs of tests/data/input (a source "-g:FILE" or "-d:DIR" is scanned
# as it is, with nothing built)
TUTORIAL = REPO / "tutorials" / "data"
NAMEMAP = str(TUTORIAL / "namemap.txt")
TUTORIAL_FLOW = ["-b", str(TUTORIAL / "regions.bed"),
                 "-m", str(TUTORIAL / "example.meme"),
                 "-k", str(TUTORIAL / "bg_nt"), "-t", "0.01"]
FLOWS.update({
    "tutorial_bgfile": ("-d", TUTORIAL_FLOW),
    "windows_tutorial_bgfile": ("-d", [*TUTORIAL_FLOW, "--engine", "windows"]),
    "tutorial_chroms_find": ("-d", [*TUTORIAL_FLOW, "--chroms-find", "y"]),
    "tutorial_namemaps": ("-d", [*TUTORIAL_FLOW, "--chroms-namemap-find",
                                 NAMEMAP]),
    "pseudocount": ("-d", ["-m", "MA0139.1.meme", "-t", "1", "--recomb",
                           "-p", "0.5"]),
    "transfac_noqvalue_noreverse": (
        "-d", ["-m", "MA0139.1.transfac", "-t", "1", "--recomb", "-q", "-r"]),
    "pfm_noqvalue_noreverse": (
        "-d", ["-m", "MA0139.1.pfm", "-t", "1", "--recomb", "-q", "-r"]),
    "xg_file": ("-g:x_toy.xg", ["-m", "MA0139.1.meme", "-t", "1",
                                "--recomb"]),
    "vg_file": ("-g:x_toy.vg", ["-m", "MA0139.1.meme", "-t", "1",
                                "--recomb"]),
    "xg_directory": ("-d:mygenome_xg", TUTORIAL_FLOW),
})
BUILD_OPTIONS = {"tutorial_namemaps": ["--chroms-namemap-build", NAMEMAP]}


def _build(main, input_dir, outdir, flow=None):
    """``buildvg`` of the toy data, or of the tutorial's for a flow that
    scans it, with the flow's buildvg options."""
    rest = FLOWS[flow][1] if flow else []
    data = TUTORIAL if any(str(TUTORIAL) in a for a in rest) else None
    fasta, vcf = ((data / "xy.fa", data / "xy2.vcf.gz") if data else
                  (input_dir / "test.fa", input_dir / "test.vcf.gz"))
    assert main([
        "buildvg", "-l", str(fasta), "-v", str(vcf), "-o", str(outdir),
        *BUILD_OPTIONS.get(flow, []),
    ]) == 0
    return outdir


def _findmotif_args(input_dir, graph_dir, bed, flow, outdir):
    src, rest = FLOWS[flow]
    if ":" in src:  # a vg-built input, scanned as it is
        src, name = src.split(":")
        graph = str(input_dir / name)
    else:
        graph = str(graph_dir / "x.gvt.npz") if src == "-g" else str(
            graph_dir)
    if "-b" not in rest:
        rest = ["-b", str(bed), *rest]
    rest = [str(input_dir / a) if a.startswith("MA0139") else a for a in rest]
    return ["findmotif", src, graph, *rest, "-o", str(outdir)]


@pytest.fixture()
def toy_bed(tmp_path):
    bed = tmp_path / "regions.bed"
    bed.write_text("chrx\t0\t20\n")
    return bed


@pytest.mark.parametrize("flow", list(FLOWS))
def test_reports_byte_identical(input_dir, tmp_path, toy_bed, flow,
                                monkeypatch):
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    g_port = _build(port_main, input_dir, tmp_path / "g_port", flow)
    g_ref = _build(ref_main, input_dir, tmp_path / "g_ref", flow)
    assert port_main([
        *_findmotif_args(input_dir, g_port, toy_bed, flow, tmp_path / "port"),
        "--device", "cpu",
    ]) == 0
    assert ref_main(
        _findmotif_args(input_dir, g_ref, toy_bed, flow, tmp_path / "ref")
    ) == 0
    for name in ("grafimo_out.tsv", "grafimo_out.gff", "grafimo_out.html"):
        got = (tmp_path / "port" / name).read_bytes()
        assert len(got.splitlines()) > 1
        assert got == (tmp_path / "ref" / name).read_bytes(), name
    if flow.endswith("dir_jaspar_topgraphs"):
        assert (tmp_path / "port" / "top_graphs" / "x:0-20.dot").read_bytes() \
            == (tmp_path / "ref" / "top_graphs" / "x:0-20.dot").read_bytes()


@pytest.mark.parametrize("engine", ["runs", "windows"])
def test_multi_width_reports_byte_identical(input_dir, tmp_path, toy_bed,
                                            engine, monkeypatch):
    """``multi.meme`` (widths 19, 8 and 12: one scan pass per width, each
    with its own histogram compression): every report file of the port
    byte-identical to the reference's."""
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    outs = {}
    for name, main, extra in (("port", port_main, ["--device", "cpu"]),
                              ("ref", ref_main, [])):
        graphs = _build(main, input_dir, tmp_path / f"g_{name}")
        assert main([
            "findmotif", "-d", str(graphs), "-b", str(toy_bed),
            "-m", str(input_dir / "multi.meme"), "-t", "1", "--recomb",
            "--engine", engine, "-o", str(tmp_path / name), *extra,
        ]) == 0
        outs[name] = {
            p.name: p.read_bytes() for p in (tmp_path / name).iterdir()
            if p.suffix in (".tsv", ".gff", ".html")
        }
    assert len(outs["port"]) == 9  # a TSV, a GFF3 and an HTML per motif
    assert outs["port"] == outs["ref"]


def _sorted_report(path):
    """A TSV report in the order ``tests/test_multi_motif.py:113-120``
    sorts both engines' reports before comparing them."""
    return (
        pd.read_csv(path, sep="\t", index_col=0)
        .sort_values(["sequence_name", "p-value", "start", "stop", "strand",
                      "matched_sequence"])
        .reset_index(drop=True)
    )


def _scanned(out):
    lines = [l for l in out.splitlines() if l.startswith("Scanned")]
    assert len(lines) == 2, lines
    return lines


@pytest.mark.parametrize("extra", [["--recomb"], ["--recomb", "--no-reverse"]])
def test_engines_agree(input_dir, tmp_path, toy_bed, capsys, extra):
    """The port's window and run engines give the same report rows and
    print the same ``Scanned`` counters
    (``tests/test_multi_motif.py:89``, ``tests/test_cli_end_to_end.py:132``)."""
    graphs = _build(port_main, input_dir, tmp_path / "g")
    capsys.readouterr()
    reports, counters = {}, {}
    for engine in ("runs", "windows"):
        out = tmp_path / engine
        assert port_main([
            "findmotif", "-d", str(graphs), "-b", str(toy_bed),
            "-m", str(input_dir / "MA0139.1.jaspar"), "-t", "1", *extra,
            "--engine", engine, "-o", str(out), "--device", "cpu",
        ]) == 0
        counters[engine] = _scanned(capsys.readouterr().out)
        reports[engine] = _sorted_report(out / "grafimo_out.tsv")
    assert len(reports["runs"]) > 0
    pd.testing.assert_frame_equal(reports["runs"], reports["windows"],
                                  check_exact=True)
    assert counters["runs"] == counters["windows"]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["windows", "runs"])
def test_card_report_matches_cpu(input_dir, tmp_path, toy_bed, engine):
    """On a card: each engine's report on cuda byte-identical to its report
    on the CPU, the run engine through the histogram kernel, the window
    engine through the fused score-and-count kernel alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grafimo_tpu_torch.ops import hist, scan_packed

    graphs = _build(port_main, input_dir, tmp_path / "g")
    for dev in ("cuda", "cpu"):
        hist.reset_counts()
        scan_packed.reset_counts()
        assert port_main([
            *_findmotif_args(input_dir, graphs, toy_bed,
                             "dir_jaspar_topgraphs", tmp_path / dev),
            "--engine", engine, "--device", dev,
        ]) == 0
        if dev == "cuda":
            assert hist.COUNTS["plain"] == scan_packed.COUNTS["plain"] == 0
            if engine == "windows":
                assert scan_packed.COUNTS["fused"] > 0
                assert hist.COUNTS["kernel"] == 0
            else:
                assert hist.COUNTS["kernel"] > 0
    for name in ("grafimo_out.tsv", "grafimo_out.gff"):
        assert (tmp_path / "cuda" / name).read_bytes() == (
            tmp_path / "cpu" / name).read_bytes()


def _run_jax_blocked(input_dir, tmp_path, toy_bed, flow):
    """buildvg + findmotif through the port's CLI in a fresh interpreter
    where importing jax fails; then the reference's report of the same
    flow, for comparison."""
    prog = (
        "import sys\n"
        # any later 'import jax' or 'import grafimo_tpu' raises
        "sys.modules['jax'] = sys.modules['grafimo_tpu'] = None\n"
        "from grafimo_tpu_torch.cli import main\n"
        "args = sys.argv[1:]\n"
        "rc = main(args[:7]) or main(args[7:])\n"
        "sys.exit(rc)\n"
    )
    graphs = tmp_path / "g"
    args = [
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(graphs),
        *_findmotif_args(input_dir, graphs, toy_bed, flow, tmp_path / "port"),
        "--device", "cpu", "--debug",
    ]
    proc = subprocess.run(
        [sys.executable, "-c", prog, *args], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    g_ref = _build(ref_main, input_dir, tmp_path / "g_ref")
    assert ref_main(_findmotif_args(
        input_dir, g_ref, toy_bed, flow, tmp_path / "ref"
    )) == 0
    assert (tmp_path / "port" / "grafimo_out.tsv").read_bytes() == (
        tmp_path / "ref" / "grafimo_out.tsv"
    ).read_bytes()


def test_cli_runs_with_jax_blocked(input_dir, tmp_path, toy_bed):
    """The port never imports jax nor the reference package: in a fresh
    interpreter where importing either fails, buildvg + findmotif run and
    write the reference's TSV."""
    _run_jax_blocked(input_dir, tmp_path, toy_bed, "dir_jaspar_topgraphs")


def test_window_engine_runs_with_jax_blocked(input_dir, tmp_path, toy_bed):
    """The same with ``--engine windows``: its modules import no jax."""
    _run_jax_blocked(input_dir, tmp_path, toy_bed,
                     "windows_dir_jaspar_topgraphs")


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
        (["--profile", "prof"], "A15"),
        (["--coordinator", "localhost:1234"], "A13"),
        (["--num-processes", "2"], "A13"),
        (["--process-id", "0"], "A13"),
    ],
)
def test_unported_options_fail_loudly(input_dir, tmp_path, toy_bed, capsys,
                                      monkeypatch, extra, item):
    """The options that ROADMAP A15 (``--profile``) and A13 (multi-host)
    ported no longer raise as unported: ``--profile`` runs; a multi-host
    flag without the rest of its settings fails with one line naming
    what is missing, before any report; ``--process-id`` alone is ignored,
    as in the reference (``grafimo_tpu/workflows.py:376``)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    graphs = _build(port_main, input_dir, tmp_path / "g")
    out = tmp_path / "out"
    extra = [str(tmp_path / a) if a == "prof" else a for a in extra]
    rc = port_main([
        *_findmotif_args(input_dir, graphs, toy_bed, "single_graph_meme", out),
        "--device", "cpu", *extra,
    ])
    err = capsys.readouterr().err
    assert "not ported" not in err and f"ROADMAP {item}" not in err
    if extra[0] in ("--profile", "--process-id"):
        assert rc == 0
        assert (out / "grafimo_out.tsv").exists()
        return
    assert rc == 1
    want = ("--num-processes N >= 1" if extra[0] == "--coordinator"
            else "MASTER_ADDR, MASTER_PORT, RANK not set")
    assert want in err
    assert not out.exists()


def test_profile_writes_trace_and_same_report(input_dir, tmp_path, toy_bed,
                                              capsys):
    """``--device cpu --profile DIR`` writes one Chrome trace of the scan
    phase into DIR (CPU activity: the histogram's plain version shows in
    it) and the same report bytes as a run without it."""
    import json

    graphs = _build(port_main, input_dir, tmp_path / "g")
    prof = tmp_path / "prof"
    for out, extra in (("plain", []), ("profiled", ["--profile", str(prof)])):
        assert port_main([
            *_findmotif_args(input_dir, graphs, toy_bed, "single_graph_meme",
                             tmp_path / out),
            "--device", "cpu", *extra,
        ]) == 0
    assert "profiler trace written to" in capsys.readouterr().out
    from grafimo_tpu_torch.cli import get_parser

    helps = {a.dest: a.help for a in get_parser()._actions}
    assert "torch.profiler" in helps["profile_dir"]
    assert "jax" not in helps["coordinator"]
    traces = sorted(p.name for p in prof.iterdir())
    assert traces == ["grafimo_rank0.pt.trace.json"]
    events = json.loads((prof / traces[0]).read_text())["traceEvents"]
    assert any("bincount" in str(e.get("name", "")) for e in events)
    for name in ("grafimo_out.tsv", "grafimo_out.gff"):
        assert (tmp_path / "profiled" / name).read_bytes() == (
            tmp_path / "plain" / name).read_bytes()


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
    """No module of the port imports jax or anything of the reference
    package, directly or at function level."""
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
                assert name.split(".")[0] not in ("jax", "grafimo_tpu"), (
                    path, name)
    assert os.path.isfile(pkg / "csrc" / "hist.cu")
    assert os.path.isfile(pkg / "csrc" / "scan_packed.cu")
