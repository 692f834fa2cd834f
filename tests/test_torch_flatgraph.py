"""The C++ batcher's flat graph view (``native._flatten_graph``, built by
the port in whole-graph passes) on the CPU: equal to the reference's
per-``Site`` loop array for array (values, dtype, shape, C order) on
graphs of every shape, each side on a graph its own package's loaders
built; built once per graph, from the graph's own site spans, under one
``graph_flatten_s`` span; ``runscan.batch_runs`` flattening through it
with no flatten call of its own, its batches byte-identical to those of
a graph flattened beforehand; and ``findmotif`` flattening each graph
once, under the same spans as before."""

import importlib

import numpy as np
import pytest

import grafimo_tpu_torch.native as port_native
import grafimo_tpu_torch.runscan as runscan
from grafimo_tpu_torch import spans
from tests.test_torch_isolation import _host, _seeded_graph
from tests.test_torch_runscan import (
    _assert_batches_equal,
    _random_graph,
    _toy_graph,
)
from tests.test_torch_spans import _findmotif, toy  # noqa: F401 (fixture)

PORT, REF = _host("grafimo_tpu_torch"), _host("grafimo_tpu")
KEYS = ("seq", "site_start", "site_end", "site_aoff", "site_nall",
        "allele_off", "allele_len", "blob")


def _indels_graph(h, _tmp):
    """A pure insertion (empty ref allele), deletions of one and three
    bases, a multi-allelic SNP and a site of insertion and deletion."""
    seq = "ACGTACGTTAGCCATGACGTAGGCTAACGTTGCA" * 3
    gt = [0, 1, 1, 0]
    records = [
        h.VcfRecord("c", 4, seq[3], [seq[3] + "GGA"], gt),
        h.VcfRecord("c", 10, seq[9:11], [seq[9]], gt),
        h.VcfRecord("c", 20, "T", ["A", "C", "G"], [0, 2, 3, 1]),
        h.VcfRecord("c", 40, seq[39:43], [seq[39]], gt),
        h.VcfRecord("c", 60, seq[59:61], [seq[59], seq[59:61] + "TT"],
                    [1, 2, 0, 2]),
    ]
    return h.build_graph("c", seq, records)


def _mixed_case_graph(h, _tmp):
    """Lowercase bases, ``N`` and other letters in the sequence and in
    the alleles (loaders of ``.gfa``, ``.xg`` and ``.vg`` keep case)."""
    Site = importlib.import_module(h.SiteGraph.__module__).Site
    sites = [
        Site(1, 2, 3, ["g", "a", "Tt"], [1, 2, 3]),
        Site(2, 5, 5, ["", "nNa"], [0, 4]),
        Site(3, 8, 10, ["Ry", "", "acgtn"], [5, 0, 6]),
    ]
    return h.SiteGraph(
        chrom="m", seq="ACgTNnacRyGGtN", sites=sites,
        node_ref_start=np.zeros(7, np.int64),
        node_ref_end=np.zeros(7, np.int64),
        node_is_ref=np.zeros(7, bool), node_seqs=[""] * 7, segments=[],
    )


def _no_sites_graph(h, _tmp):
    return h.build_graph("z", "ACGTNACGTTGCA" * 4, [])


def _saved_graph(h, tmp):
    """The seeded graph saved by the port, loaded by ``h``'s loader."""
    path = tmp / "s.gvt.npz"
    if not path.exists():
        _seeded_graph(PORT).save(str(path))
    return h.SiteGraph.load(str(path))


GRAPHS = {
    "seeded_dense": lambda h, _tmp: _seeded_graph(h),
    "seeded_sparse": lambda h, _tmp: _seeded_graph(h, seed=5, gap=(25, 90)),
    "indels": _indels_graph,
    "mixed_case": _mixed_case_graph,
    "no_sites": _no_sites_graph,
    "gvt_saved": _saved_graph,
}


@pytest.mark.parametrize("name", GRAPHS)
def test_flat_arrays_equal_pinned_flatten(name, tmp_path):
    got = PORT.native._flatten_graph(GRAPHS[name](PORT, tmp_path))
    want = REF.native._flatten_graph(GRAPHS[name](REF, tmp_path))
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


def test_flatten_graph_builds_once_per_graph(monkeypatch):
    """Within one call, a graph flattened again, and by the batcher, is
    flattened once: one ``graph_flatten_s`` span, ``graph_flatten.graphs``
    counted once; its site spans are the graph's own ``site_spans``."""
    graph = _random_graph(3)
    opened = []
    enter = spans.span.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(spans.span, "__enter__", counted)
    with spans.call("t_s"):
        flat = port_native._flatten_graph(graph)
        assert port_native._flatten_graph(graph) is flat
        port_native.batch_regions_native(graph, [(0, 400)], 11, (64, 128),
                                         n_threads=1)
    rec = spans.last_call()
    assert rec["counts"]["graph_flatten.graphs"] == 1
    assert opened.count("graph_flatten_s") == 1
    assert "graph_flatten_s" in rec["spans"]
    starts, ends = graph.site_spans()
    assert flat["site_start"] is starts and flat["site_end"] is ends


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("which", ["toy", "random"])
def test_batch_runs_flattens_through_flat_arrays(input_dir, which, resident,
                                                 monkeypatch):
    """``batch_runs`` makes no flatten call of its own: the native batcher
    flattens its graph (counted once), and its batches equal those cut
    from a graph flattened before the call (counted nowhere)."""
    def graph():
        return _toy_graph(input_dir) if which == "toy" else _random_graph(3)

    if which == "toy":
        display, regions, k = "x", [(0, 50)], 19
    else:
        display, regions, k = "r", [(0, 400), (350, 900)], 11
    seen = []
    real = port_native._flatten_graph

    def spy(g):
        seen.append(getattr(g, "_native_flat_cache", None))
        return real(g)

    fresh, primed = graph(), graph()
    real(primed)
    monkeypatch.setattr(port_native, "_flatten_graph", spy)
    out = {}
    for name, g in (("fresh", fresh), ("primed", primed)):
        with spans.call("t_s"):
            out[name] = runscan.batch_runs(
                runscan.build_region_runs(g, display, regions, k), k,
                resident=resident, threads=1,
            )
        out[name + "_counts"] = spans.last_call()["counts"]
    assert seen == [None, primed._native_flat_cache]
    assert out["fresh_counts"]["graph_flatten.graphs"] == 1
    assert "graph_flatten.graphs" not in out["primed_counts"]
    _assert_batches_equal(out["fresh"], out["primed"], (fresh, primed))


def test_findmotif_flattens_each_graph_once(input_dir, toy, tmp_path,
                                            monkeypatch):
    """One call flattens its one graph once, in the native batcher; the
    call opens 36 spans, one of them ``graph_flatten_s`` (and one each of
    ``pvalue_cutoffs_s`` and ``qvalue_tables_s``: one width, one motif
    with rows)."""
    made, opened = [], []
    real = port_native._flatten_graph
    enter = spans.span.__enter__

    def spy(graph):
        cold = getattr(graph, "_native_flat_cache", None) is None
        flat = real(graph)
        if cold:
            made.append((graph, flat))
        return flat

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(port_native, "_flatten_graph", spy)
    monkeypatch.setattr(spans.span, "__enter__", counted)
    rec = _findmotif(input_dir, toy, tmp_path / "out")
    ((graph, flat),) = made
    assert graph._native_flat_cache is flat
    assert rec["counts"]["graph_flatten.graphs"] == 1
    assert "graph_flatten_s" in rec["spans"]
    assert len(opened) == 36 and opened.count("graph_flatten_s") == 1
    assert opened.count("pvalue_cutoffs_s") == 1
    assert opened.count("qvalue_tables_s") == 1
