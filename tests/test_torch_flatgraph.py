"""The C++ batcher's flat graph view built by the port
(``grafimo_tpu_torch/flatgraph.py``) on the CPU: ``flat_arrays`` equal to
the pinned ``native._flatten_graph`` array for array (values, dtype,
shape, C order) on graphs of every shape, each side on a graph object of
its own so that no cache is shared; ``runscan.batch_runs`` flattening
through it, so the pinned loop only ever reads its cache, with batches
byte-identical to those from the pinned arrays; and ``findmotif``
flattening each graph once, under the same spans as before."""

import numpy as np
import pytest

import grafimo_tpu_torch.native as port_native
import grafimo_tpu_torch.runscan as runscan
from grafimo_tpu_torch import flatgraph, spans
from grafimo_tpu_torch.graph.sitegraph import Site, SiteGraph, build_graph
from grafimo_tpu_torch.io.vcf import VcfRecord
from tests.test_torch_isolation import _host, _seeded_graph
from tests.test_torch_runscan import (
    _assert_batches_equal,
    _random_graph,
    _toy_graph,
)
from tests.test_torch_spans import _findmotif, toy  # noqa: F401 (fixture)

PORT = _host("grafimo_tpu_torch")
KEYS = ("seq", "site_start", "site_end", "site_aoff", "site_nall",
        "allele_off", "allele_len", "blob")


def _indels_graph(_tmp):
    """A pure insertion (empty ref allele), deletions of one and three
    bases, a multi-allelic SNP and a site of insertion and deletion."""
    seq = "ACGTACGTTAGCCATGACGTAGGCTAACGTTGCA" * 3
    gt = [0, 1, 1, 0]
    records = [
        VcfRecord("c", 4, seq[3], [seq[3] + "GGA"], gt),
        VcfRecord("c", 10, seq[9:11], [seq[9]], gt),
        VcfRecord("c", 20, "T", ["A", "C", "G"], [0, 2, 3, 1]),
        VcfRecord("c", 40, seq[39:43], [seq[39]], gt),
        VcfRecord("c", 60, seq[59:61], [seq[59], seq[59:61] + "TT"],
                  [1, 2, 0, 2]),
    ]
    return build_graph("c", seq, records)


def _mixed_case_graph(_tmp):
    """Lowercase bases, ``N`` and other letters in the sequence and in
    the alleles (loaders of ``.gfa``, ``.xg`` and ``.vg`` keep case)."""
    sites = [
        Site(1, 2, 3, ["g", "a", "Tt"], [1, 2, 3]),
        Site(2, 5, 5, ["", "nNa"], [0, 4]),
        Site(3, 8, 10, ["Ry", "", "acgtn"], [5, 0, 6]),
    ]
    return SiteGraph(
        chrom="m", seq="ACgTNnacRyGGtN", sites=sites,
        node_ref_start=np.zeros(7, np.int64),
        node_ref_end=np.zeros(7, np.int64),
        node_is_ref=np.zeros(7, bool), node_seqs=[""] * 7, segments=[],
    )


def _no_sites_graph(_tmp):
    return build_graph("z", "ACGTNACGTTGCA" * 4, [])


def _saved_graph(tmp):
    path = tmp / "s.gvt.npz"
    if not path.exists():
        _seeded_graph(PORT).save(str(path))
    return SiteGraph.load(str(path))


GRAPHS = {
    "seeded_dense": lambda _tmp: _seeded_graph(PORT),
    "seeded_sparse": lambda _tmp: _seeded_graph(PORT, seed=5, gap=(25, 90)),
    "indels": _indels_graph,
    "mixed_case": _mixed_case_graph,
    "no_sites": _no_sites_graph,
    "gvt_saved": _saved_graph,
}


@pytest.mark.parametrize("name", GRAPHS)
def test_flat_arrays_equal_pinned_flatten(name, tmp_path):
    got = flatgraph.flat_arrays(GRAPHS[name](tmp_path))
    want = port_native._flatten_graph(GRAPHS[name](tmp_path))
    assert tuple(got) == tuple(want) == KEYS
    for key in KEYS:
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.flags.c_contiguous and b.flags.c_contiguous, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    if name == "no_sites":
        assert all(got[key].size == 0 for key in KEYS if key != "seq")
    if name == "indels":
        assert (got["site_start"] == got["site_end"]).any()  # insertion
        assert (got["allele_len"] == 0).any() and got["site_nall"].max() > 3


def test_flat_arrays_fills_caches_once():
    """The result lands where the pinned function and ``site_spans``
    look; a set cache is returned as it is, uncounted; set site spans
    are left alone."""
    graph = _random_graph(3)
    with spans.call("t_s"):
        flat = flatgraph.flat_arrays(graph)
        assert port_native._flatten_graph(graph) is flat
        assert flatgraph.flat_arrays(graph) is flat
    rec = spans.last_call()
    assert rec["counts"]["graph_flatten.graphs"] == 1
    assert "graph_flatten_s" in rec["spans"]
    got = graph.site_spans()
    want = _random_graph(3).site_spans()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    other = _random_graph(3)
    preset = other.site_spans()
    flatgraph.flat_arrays(other)
    assert other.site_spans() is preset


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("which", ["toy", "random"])
def test_batch_runs_flattens_through_flat_arrays(input_dir, which, resident,
                                                 monkeypatch):
    """``batch_runs`` fills the flat cache before the native batcher
    runs, and its batches equal those cut from a graph whose cache the
    pinned ``_flatten_graph`` filled first."""
    def graph():
        return _toy_graph(input_dir) if which == "toy" else _random_graph(3)

    if which == "toy":
        display, regions, k = "x", [(0, 50)], 19
    else:
        display, regions, k = "r", [(0, 400), (350, 900)], 11
    seen = []
    pinned = port_native._flatten_graph

    def spy(g):
        seen.append(getattr(g, "_native_flat_cache", None))
        return pinned(g)

    fresh, primed = graph(), graph()
    pinned(primed)
    monkeypatch.setattr(port_native, "_flatten_graph", spy)
    out = {}
    for name, g in (("fresh", fresh), ("primed", primed)):
        with spans.call("t_s"):
            out[name] = runscan.batch_runs(
                runscan.build_region_runs(g, display, regions, k), k,
                resident=resident, threads=1,
            )
        out[name + "_counts"] = spans.last_call()["counts"]
    assert seen and all(s is not None for s in seen)
    assert out["fresh_counts"]["graph_flatten.graphs"] == 1
    assert "graph_flatten.graphs" not in out["primed_counts"]
    _assert_batches_equal(out["fresh"], out["primed"], (fresh, primed))


def test_findmotif_flattens_each_graph_once(input_dir, toy, tmp_path,
                                            monkeypatch):
    """One call flattens its one graph through ``flat_arrays``; the
    pinned loop only returns that cache; the call opens 36 spans, one
    of them ``graph_flatten_s`` (and one each of ``pvalue_cutoffs_s``
    and ``qvalue_tables_s``: one width, one motif with rows)."""
    made, seen, opened = [], [], []
    real, pinned = runscan.flat_arrays, port_native._flatten_graph
    enter = spans.span.__enter__

    def spy_flat(graph):
        made.append((graph, real(graph)))
        return made[-1][1]

    def spy_pinned(graph):
        seen.append(getattr(graph, "_native_flat_cache", None))
        return pinned(graph)

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(runscan, "flat_arrays", spy_flat)
    monkeypatch.setattr(port_native, "_flatten_graph", spy_pinned)
    monkeypatch.setattr(spans.span, "__enter__", counted)
    rec = _findmotif(input_dir, toy, tmp_path / "out")
    ((graph, flat),) = made
    assert graph._native_flat_cache is flat
    assert seen and all(s is flat for s in seen)
    assert rec["counts"]["graph_flatten.graphs"] == 1
    assert "graph_flatten_s" in rec["spans"]
    assert len(opened) == 36 and opened.count("graph_flatten_s") == 1
    assert opened.count("pvalue_cutoffs_s") == 1
    assert opened.count("qvalue_tables_s") == 1
