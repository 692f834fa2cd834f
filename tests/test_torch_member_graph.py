"""A format-2 ``.gvt.npz`` loaded as its member arrays (the port's
``SiteGraph.load``) on the CPU: every ``Site``, segment, element, node
array and haplotype count equal to the JAX package's eager load of the
same file; the on-read sequences behaving as the lists they replace; the
readers that take the member arrays (``site_spans``,
``native._flatten_graph``, ``runs.site_deletables``,
``runs._ref_node_array``) equal to their whole-graph passes; a re-save
writing the same members; one ``graph_inflate_s`` span per member read;
and, on a small ``ctcf_peaks``-shaped input, one ``findmotif`` call that
builds a small share of the graph's sites and writes the same reports as
the eager route.

The graphs are saved by the port's ``buildvg`` or ``build_graph(...)
.save``: SNPs, deletions, insertions (empty ref allele), multi-allelic
sites, a haplotype panel, a panel whose row map is stored out of site
order, a graph with no site, and a format-1 file."""

import json

import numpy as np
import pytest

import grafimo_tpu.graph.sitegraph as ref_sitegraph
import grafimo_tpu_torch.graph.runs as runs
import grafimo_tpu_torch.graph.sitegraph as sitegraph
import grafimo_tpu_torch.native as native
from grafimo_tpu_torch import spans
from grafimo_tpu_torch.cli import main as port_main
from tests.test_torch_flatgraph import KEYS, _indels_graph
from tests.test_torch_isolation import _host, _same, _seeded_graph

PORT = _host("grafimo_tpu_torch")


def _save_format1(graph, path):
    """``graph`` in the format-1 layout: sites, segments and elements in
    the JSON meta, the node and haplotype arrays as members."""
    meta = {
        "chrom": graph.chrom,
        "sites": [{"s": s.ref_start, "e": s.ref_end, "a": s.alleles,
                   "n": s.allele_nodes} for s in graph.sites],
        "segments": [list(s) for s in graph.segments],
        "elements": [list(e) for e in graph.elements],
    }
    arrays = {
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        "seq": np.frombuffer(graph.seq.encode("ascii"), dtype=np.uint8),
        "node_ref_start": graph.node_ref_start,
        "node_ref_end": graph.node_ref_end,
        "node_is_ref": graph.node_is_ref,
        "node_seqs": np.frombuffer("\n".join(graph.node_seqs).encode(),
                                   dtype=np.uint8),
    }
    if graph.haplo is not None:
        arrays.update(graph.haplo.to_arrays())
    np.savez_compressed(path, **arrays)


def _unsorted_rows(graph, path):
    """``graph`` saved with its haplotype row map stored in reverse."""
    graph.save(path)
    with np.load(path) as data:
        arrays = {name: data[name] for name in data.files}
    for name in ("hap_map_site", "hap_map_allele", "hap_map_row"):
        arrays[name] = arrays[name][::-1].copy()
    np.savez_compressed(path, **arrays)


def _buildvg(input_dir, tmp):
    assert port_main(["buildvg", "-l", str(input_dir / "test.fa"),
                      "-v", str(input_dir / "test.vcf.gz"),
                      "-o", str(tmp / "g")]) == 0
    (path,) = (tmp / "g").glob("*.gvt.npz")
    return path


GRAPHS = {
    "seeded": lambda d, p: _seeded_graph(PORT).save(p),
    "indels": lambda d, p: _indels_graph(PORT, None).save(p),
    "no_sites": lambda d, p: PORT.build_graph("z", "ACGTNACGTT" * 5,
                                              []).save(p),
    "rows_unsorted": lambda d, p: _unsorted_rows(_seeded_graph(PORT, 3), p),
    "format1": lambda d, p: _save_format1(_seeded_graph(PORT, 4), p),
}


@pytest.fixture(params=[*GRAPHS, "buildvg"])
def saved(request, input_dir, tmp_path):
    """(name, path) of one saved graph."""
    name = request.param
    if name == "buildvg":
        return name, str(_buildvg(input_dir, tmp_path))
    path = str(tmp_path / f"{name}.gvt.npz")
    GRAPHS[name](input_dir, path)
    return name, path


def _eager(graph):
    """``graph`` with its sequences as plain lists, so every reader takes
    its whole-graph pass."""
    graph.sites = list(graph.sites)
    graph.segments = list(graph.segments)
    graph.elements = list(graph.elements)
    if graph.haplo is not None:
        graph.haplo.site_allele_rows = list(graph.haplo.site_allele_rows)
    return graph


def _members_of(name):
    return name not in ("format1",)


def test_load_matches_reference(saved):
    """Every field, element by element, and the haplotype count of
    random allele paths equal the JAX package's load of the file."""
    name, path = saved
    got = sitegraph.SiteGraph.load(path)
    want = ref_sitegraph.SiteGraph.load(path)
    assert isinstance(got.sites, sitegraph._MemberSites) == _members_of(
        name)
    assert (got.haplo is None) == (want.haplo is None)
    if want.haplo is not None:
        rng = np.random.default_rng(5)
        n = len(want.sites)
        for _ in range(200):
            lo = int(rng.integers(0, n))
            choices = [
                (sid, int(rng.integers(0, len(want.sites[sid].alleles))))
                for sid in range(lo, min(n, lo + int(rng.integers(1, 4))))
            ]
            assert got.haplo.count(choices) == want.haplo.count(choices)
        for field in ("n_hap", "words", "site_allele_rows", "alt_bits"):
            _same(getattr(got.haplo, field), getattr(want.haplo, field),
                  field)
        assert [list(r.items()) for r in got.haplo.site_allele_rows] == [
            list(r.items()) for r in want.haplo.site_allele_rows]
    got.haplo = want.haplo = None
    _same(got, want, "graph")
    if name != "no_sites":
        assert len(got.sites) >= 5


def test_sequences_read_as_lists(saved):
    """``len``, indices (negative too), slices, iteration and equality as
    on the eager lists; a repeated read returns the same object."""
    _name, path = saved
    graph = sitegraph.SiteGraph.load(path)
    want = _eager(sitegraph.SiteGraph.load(path))
    seqs = [(graph.sites, want.sites), (graph.segments, want.segments),
            (graph.elements, want.elements)]
    if graph.haplo is not None:
        seqs.append((graph.haplo.site_allele_rows,
                     want.haplo.site_allele_rows))
    for got, ref in seqs:
        n = len(ref)
        assert len(got) == n
        for i in (0, 1, n // 2, n - 1, -1, -n):
            if -n <= i < n:
                assert got[i] == ref[i]
                assert got[i] is got[i] is got[i + n if i < 0 else i]
        for i in (n, -n - 1):
            with pytest.raises(IndexError):
                got[i]
        for cut in (slice(None), slice(1, None, 2), slice(-3, None),
                    slice(n, None), slice(None, None, -1)):
            assert isinstance(got[cut], list) and got[cut] == ref[cut]
        items = list(got)
        assert items == ref and got == ref and ref == got and got == got
        assert all(a is b for a, b in zip(items, got))
        assert got != ref + [None] and got != tuple(ref)


def test_readers_match_whole_graph_passes(saved):
    """``site_spans``, the flat arrays, the deletable spans and the
    reference node of every base equal the whole-graph passes over the
    same file loaded eagerly, dtypes included; the graph builds no
    ``Site`` for them."""
    name, path = saved
    want = _eager(sitegraph.SiteGraph.load(path))
    with spans.call("t_s"):
        graph = sitegraph.SiteGraph.load(path)
        got_flat = native._flatten_graph(graph)
        got_del = runs.site_deletables(graph)
        got_ref = runs._ref_node_array(graph)
        if _members_of(name):
            assert spans._current.counts["graph_objects.sites_built"] == 0
    for a, b in zip(graph.site_spans(), want.site_spans()):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    want_flat = native._flatten_graph(want)
    assert tuple(got_flat) == tuple(want_flat) == KEYS
    for key in KEYS:
        a, b = got_flat[key], want_flat[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.flags.c_contiguous, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    for a, b in ((got_del, runs.site_deletables(want)),
                 (got_ref, runs._ref_node_array(want))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert (graph.allele_table() is not None) == _members_of(name)
    assert want.allele_table() is None and want.ref_path_tables() is None


def test_save_writes_the_same_members(saved, tmp_path):
    """A lazily loaded graph saves the members that the JAX package's
    load and save of the same file write."""
    _name, path = saved
    sitegraph.SiteGraph.load(path).save(str(tmp_path / "port.npz"))
    ref_sitegraph.SiteGraph.load(path).save(str(tmp_path / "ref.npz"))
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "ref.npz") as want:
        assert got.files == want.files
        for name in want.files:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


def test_member_reads_open_one_span_each(saved, monkeypatch):
    """The load reads each member once, each under one
    ``graph_inflate_s`` span; a member load counts one
    ``graph_objects.member_graphs`` and no ``Site`` built."""
    name, path = saved
    opened = []
    enter = spans.span.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(spans.span, "__enter__", counted)
    with spans.call("t_s"):
        sitegraph.SiteGraph.load(path)
    with np.load(path) as data:
        members = len(data.files)
    assert opened.count("graph_inflate_s") == members
    counts = spans.last_call()["counts"]
    if _members_of(name):
        assert counts["graph_objects.member_graphs"] == 1
        assert counts["graph_objects.sites_built"] == 0
    else:
        assert "graph_objects.member_graphs" not in counts


# ------------------------------------------------- a ctcf_peaks-shaped call


@pytest.fixture(scope="module")
def peaks(tmp_path_factory):
    """The ``ctcf_peaks`` cell's inputs cut to 200 kbp, 64 haplotypes and
    60 peaks, from one seed, with the port's graph."""
    from benchmark import inputs, spec

    cell = spec.cell("ctcf_peaks")
    with open(cell["config_path"]) as f:
        config = json.load(f)
    with open(cell["traffic_path"]) as f:
        traffic = json.load(f)
    config.update(length_bp=200_000, haplotypes=64)
    traffic["regions"] = 60
    root = tmp_path_factory.mktemp("peaks")
    made = inputs.make(config, traffic, 2**31 + 101, str(root))
    return root, made["graph"]


def _peaks_call(peaks, out):
    root, graph = peaks
    assert port_main(["findmotif", "-g", graph, "-b",
                      str(root / "regions.bed"), "-m",
                      str(root / "motifs.meme"), "-t", "0.001", "-o",
                      str(out), "--device", "cpu"]) == 0
    return spans.last_call()


def test_findmotif_builds_few_sites(peaks, tmp_path, monkeypatch):
    """One call on the member route loads one graph from its members and
    builds a small share of its sites, the ones that hit-bearing regions'
    clusters read."""
    loaded = []
    real = sitegraph.SiteGraph.load

    def spy(path):
        loaded.append(real(path))
        return loaded[-1]

    monkeypatch.setattr(sitegraph.SiteGraph, "load", staticmethod(spy))
    rec = _peaks_call(peaks, tmp_path / "out")
    (graph,) = loaded
    built = rec["counts"]["graph_objects.sites_built"]
    assert rec["counts"]["graph_objects.member_graphs"] == 1
    assert 0 < built < len(graph.sites) / 5
    assert built == sum(s is not None for s in graph.sites._items)


def test_member_and_eager_routes_write_the_same_reports(peaks, tmp_path,
                                                        monkeypatch):
    """TSV, HTML and GFF3 are byte-identical between the member route and
    the eager route (the same file, its sequences made lists)."""
    lazy = _peaks_call(peaks, tmp_path / "members")
    real = sitegraph.SiteGraph.load
    monkeypatch.setattr(sitegraph.SiteGraph, "load",
                        staticmethod(lambda path: _eager(real(path))))
    eager = _peaks_call(peaks, tmp_path / "eager")
    assert (eager["counts"]["graph_objects.sites_built"]
            > lazy["counts"]["graph_objects.sites_built"])
    for name in ("grafimo_out.tsv", "grafimo_out.html", "grafimo_out.gff"):
        got = (tmp_path / "members" / name).read_bytes()
        assert got == (tmp_path / "eager" / name).read_bytes(), name
    assert got.count(b"\n") > 10
