"""The port's phase spans and counters (``grafimo_tpu_torch/spans.py``) on
the toy data, on the CPU: every layer span and sub-phase span of a
``findmotif`` call, sub-phases that never nest and sum to at most their
layer, spans that need no profiler, ``--profile DIR`` tracing the whole
call, the ``--verbose`` table, nothing carried from one call to the next,
the launch and read counters as before, the window engine's spans and
uploads, and ``buildvg``'s spans."""

import itertools
import json

import numpy as np
import pytest
import torch

from grafimo_tpu_torch import spans
from grafimo_tpu_torch.cli import main as port_main
import grafimo_tpu_torch.ops.compact as compact
import grafimo_tpu_torch.ops.hist as hist
import grafimo_tpu_torch.ops.scan_packed as scan_packed
import grafimo_tpu_torch.ops.score_runs as score_runs
import grafimo_tpu_torch.runscan as runscan

torch.set_num_threads(1)

LAYERS = ("motif_processing_s", "graph_load_s", "batching_s", "scan_s",
          "hit_assembly_s", "statistics_s", "report_write_s")
SUBPHASES = {
    "graph_load_s": ("graph_inflate_s",),
    "batching_s": ("graph_flatten_s", "native_batch_s"),
    "statistics_s": ("qvalue_tables_s",),
    "report_write_s": ("report_tsv_s", "report_html_s", "report_gff_s"),
}
# a width pass's p-value lookups and cutoffs, outside the layer spans
SPANS = ("findmotif_s", *LAYERS, *itertools.chain(*SUBPHASES.values()),
         "pvalue_cutoffs_s")
REGISTERED = {"hist": hist.COUNTS, "compact": compact.COUNTS,
              "scan_packed": scan_packed.COUNTS,
              "score_runs": score_runs.COUNTS, "reads": runscan.READS}
COUNTERS = ("h2d_bytes", "scan.width_passes", "report.motifs_written",
            "report.motifs_empty", "graph_objects.member_graphs",
            "graph_objects.sites_built", *(
                f"{p}.{k}" for p, d in REGISTERED.items() for k in d))


@pytest.fixture(scope="module")
def toy(input_dir, tmp_path_factory):
    """The toy graph (built once) and a one-region BED."""
    root = tmp_path_factory.mktemp("spans")
    assert port_main([
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(root / "g"),
    ]) == 0
    bed = root / "regions.bed"
    bed.write_text("chrx\t0\t20\n")
    return root


def _findmotif(input_dir, toy, out, *extra):
    assert port_main([
        "findmotif", "-d", str(toy / "g"), "-b", str(toy / "regions.bed"),
        "-m", str(input_dir / "MA0139.1.meme"), "-t", "1", "--recomb",
        "-o", str(out), "--device", "cpu", *extra,
    ]) == 0
    return spans.last_call()


def _annotations(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append((e["ts"],
                                                  e["ts"] + e["dur"]))
    return out


def test_findmotif_records_every_span_and_counter(input_dir, toy, tmp_path,
                                                  monkeypatch):
    """One call holds every span and counter and opens fewer than 100
    spans; a layer's sub-phase spans lie inside it, never overlap one
    another, and sum to at most it."""
    opened = []
    enter = spans.span.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(spans.span, "__enter__", counted)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rec = _findmotif(input_dir, toy, tmp_path / "out")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert set(SPANS) <= set(rec["spans"]), set(SPANS) - set(rec["spans"])
    assert set(COUNTERS) <= set(rec["counts"])
    assert rec["counts"]["h2d_bytes"] == 0  # the CPU copies nothing
    assert rec["counts"]["reads.flush"] >= 1
    assert rec["counts"]["score_runs.plain"] >= 1
    assert set(SPANS) <= set(opened) and len(opened) < 100
    for layer in LAYERS:
        assert 0 < rec["spans"][layer] <= rec["spans"]["findmotif_s"]
    ann = _annotations(tmp_path / "trace.json")
    for layer, subs in SUBPHASES.items():
        assert sum(rec["spans"][s] for s in subs) <= rec["spans"][layer]
        (outer,) = ann[layer]
        inner = sorted(iv for s in subs for iv in ann[s])
        assert {s for s in subs if s in ann} == set(subs)
        assert all(outer[0] <= lo and hi <= outer[1] for lo, hi in inner)
        for (_, hi), (lo, _) in zip(inner, inner[1:]):
            assert hi <= lo, layer


def test_spans_need_no_profiler(input_dir, toy, tmp_path, monkeypatch):
    """Without a profiler recording, no span touches ``record_function``:
    with it broken, the call succeeds and writes the same report bytes."""
    _findmotif(input_dir, toy, tmp_path / "plain")

    def broken(*args, **kwargs):
        raise RuntimeError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    rec = _findmotif(input_dir, toy, tmp_path / "patched")
    assert set(SPANS) <= set(rec["spans"])
    for name in ("grafimo_out.tsv", "grafimo_out.gff", "grafimo_out.html"):
        assert (tmp_path / "patched" / name).read_bytes() == (
            tmp_path / "plain" / name).read_bytes()


def test_profile_traces_the_whole_call(input_dir, toy, tmp_path, capsys):
    """``--profile DIR`` writes one trace with a ``user_annotation`` for
    the whole call, each layer span and each sub-phase span."""
    from grafimo_tpu_torch.cli import get_parser

    _findmotif(input_dir, toy, tmp_path / "out", "--profile",
               str(tmp_path / "prof"))
    assert "profiler trace written to" in capsys.readouterr().out
    traces = sorted(p.name for p in (tmp_path / "prof").iterdir())
    assert traces == ["grafimo_rank0.pt.trace.json"]
    ann = _annotations(tmp_path / "prof" / traces[0])
    assert set(SPANS) <= set(ann), set(SPANS) - set(ann)
    (call,) = ann["findmotif_s"]
    assert all(call[0] <= lo and hi <= call[1]
               for name in LAYERS for lo, hi in ann[name])
    helps = {a.dest: a.help for a in get_parser()._actions}
    assert "whole findmotif call" in helps["profile_dir"]


def test_verbose_prints_the_phase_table(input_dir, toy, tmp_path, capsys):
    """``--verbose`` ends with the call's spans and counters, one a
    line, as ``spans.table`` formats them."""
    rec = _findmotif(input_dir, toy, tmp_path / "out", "--verbose")
    out = capsys.readouterr().out
    assert out.rstrip().endswith(spans.table(rec))
    lines = out.splitlines()
    for name in (*SPANS, *COUNTERS):
        assert any(line.split()[:1] == [name] for line in lines), name
    assert not any(" in " in line and line.startswith("width ")
                   for line in lines)


def test_calls_do_not_accumulate(input_dir, toy, tmp_path):
    """Two identical calls give the same counters and span names, and
    the record holds one call's seconds, not a running sum."""
    first = _findmotif(input_dir, toy, tmp_path / "a")
    second = _findmotif(input_dir, toy, tmp_path / "b")
    assert first["counts"] == second["counts"]
    assert list(first["spans"]) == list(second["spans"])
    assert second["spans"]["findmotif_s"] < (
        first["spans"]["findmotif_s"] + second["spans"]["findmotif_s"])
    assert spans._current is None


def test_counters_read_as_before(input_dir, toy, tmp_path):
    """``COUNTS`` and ``READS`` stay the module dicts, counted and reset
    as before; a call's record shows its increments of them."""
    for mod in (hist, compact, scan_packed, score_runs):
        mod.reset_counts()
    runscan.reset_reads()
    rec = _findmotif(input_dir, toy, tmp_path / "out")
    for prefix, live in REGISTERED.items():
        for key, n in live.items():
            assert rec["counts"][f"{prefix}.{key}"] == n, (prefix, key)
    assert runscan.READS["flush"] >= 1 and runscan.READS["hist"] == 1
    assert score_runs.COUNTS["plain"] >= 1
    runscan.reset_reads()
    assert set(runscan.READS.values()) == {0}
    rec = _findmotif(input_dir, toy, tmp_path / "again")
    assert rec["counts"]["reads.hist"] == runscan.READS["hist"] == 1


def test_h2d_bytes_counts_uploads_off_the_cpu():
    """Uploads to a device other than the CPU count their bytes; outside
    a call nothing is recorded and a call nested in another leaves the
    outer one running."""
    x = np.arange(10, dtype=np.int32)
    runscan._put(x, torch.device("meta"))  # outside any call: no record
    with spans.call("outer_s"):
        with spans.call("inner_s"):
            runscan._put(x, torch.device("meta"))
            score_runs.genome_planes_to_device(x.astype(np.uint32), x,
                                               torch.device("meta"))
        assert spans.last_call()["counts"]["h2d_bytes"] == 40 + 80 + 80
        runscan._put(x, torch.device("cpu"))
        spans.count("h2d_bytes", 8)
    rec = spans.last_call()
    assert rec["counts"]["h2d_bytes"] == 8
    assert list(rec["spans"]) == ["outer_s"]


def test_buildvg_records_its_spans(input_dir, tmp_path, capsys):
    """``buildvg`` is one call: VCF read, graph build and save, each a
    span inside ``buildvg_s``; ``--verbose`` prints the table."""
    assert port_main([
        "buildvg", "-l", str(input_dir / "test.fa"),
        "-v", str(input_dir / "test.vcf.gz"), "-o", str(tmp_path / "g"),
        "--verbose",
    ]) == 0
    rec = spans.last_call()
    names = ("vcf_read_s", "graph_build_s", "graph_save_s")
    assert list(rec["spans"]) == ["buildvg_s", *names]
    assert sum(rec["spans"][n] for n in names) <= rec["spans"]["buildvg_s"]
    assert capsys.readouterr().out.rstrip().endswith(spans.table(rec))


def test_window_engine_records_its_spans(input_dir, toy, tmp_path, capsys,
                                         monkeypatch):
    """``--engine windows`` times a width's extraction as ``batching_s``
    and a motif's scoring as ``scan_s``; its ``--verbose`` lines report
    those spans' seconds, and its uploads count in ``h2d_bytes``."""
    rec = _findmotif(input_dir, toy, tmp_path / "out", "--engine",
                     "windows", "--verbose")
    assert {"findmotif_s", "batching_s", "scan_s",
            "report_write_s"} <= set(rec["spans"])
    assert rec["spans"]["scan_s"] > 0
    assert rec["counts"]["h2d_bytes"] == 0  # the CPU copies nothing
    out = capsys.readouterr().out
    assert "candidate windows in " in out and "window rows scored in " in out
    from grafimo_tpu_torch.ops import score_windows

    # the copies to a device that runs no kernel: the launch is stubbed
    monkeypatch.setattr(score_windows, "score_packed_hist",
                        lambda packed, flags, lut, mins, hist: packed)
    meta = torch.device("meta")
    lut = torch.zeros((3, 4, 1), dtype=torch.int32, device=meta)
    codes = np.zeros((5, 3), dtype=np.uint8)
    with spans.call("windows_s"):
        score_windows.score_and_accumulate(
            codes, lut, np.zeros(1, np.int32),
            torch.zeros((8, 1), dtype=torch.int64, device=meta))
    packed_bytes = 5 * 1 + 5  # one packed byte and one flag per row
    assert spans.last_call()["counts"]["h2d_bytes"] == packed_bytes + 4
