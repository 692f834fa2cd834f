"""The run engine's hit assembly on the CPU: the backbone hits and
q-value tables of ``grafimo_tpu_torch/assemble.py`` against the run and
the loops they stand in for (``graph/runs.py``, ``ops/qvalue.py``); the
port's array builds in ``graph/runs.py`` (clusters, deletable spans, the
reference node array, a cold ``build_single_run``) against the JAX
package's loops, each side on a graph its own package's loaders built;
then ``compute_results_runs`` end to end against the JAX package's,
frames ``check_exact``.  Tolerance 0 throughout: integers, bytes,
``Site`` identity and float64 bits."""

import numpy as np
import pandas as pd
import pytest
import torch

import grafimo_tpu.runscan as ref_rs
from grafimo_tpu.graph import runs as ref_runs
import grafimo_tpu.native as ref_native
import grafimo_tpu_torch.native as port_native
import grafimo_tpu_torch.runscan as port_rs
from grafimo_tpu.utils.constants import UNIF
from grafimo_tpu_torch import assemble, pvalues
from grafimo_tpu_torch.graph import runs as port_runs
from grafimo_tpu_torch.ops.qvalue import qvalues_from_histogram

from test_torch_runscan import PORT, REF
from test_torch_tail_sums import jaspar_motifs

torch.set_num_threads(1)

CPU = torch.device("cpu")
BB = ("begins", "ends", "seq_bytes", "is_ref", "freqs")


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the reference shards over conftest's 8 CPU devices otherwise
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")


def _graph(seed, length=1200, h=PORT, step=(6, 18), snp=0.6, ins=0.2,
           long_del=0.0, pocket=None, n_bases=6, haplotypes=True):
    """A random chromosome with N bases and variants every ``step``
    bases: SNPs, insertions of 1-4 bases, deletions of 1-4 bases and,
    with ``long_del``, of 20-60; ``pocket = (lo, hi)`` adds a SNP at
    every third base of ``[lo, hi)``: a chain of 2^40 combinations,
    past the int32 combination index (an over-dense cluster)."""
    rng = np.random.default_rng(seed)
    seq = list(rng.choice(list("ACGT"), length))
    for p in rng.choice(np.arange(5, length - 5), n_bases, replace=False):
        seq[p] = "N"
    seq = "".join(seq)
    records, pos = [], 8
    while pos < length - 70:
        gt = [int(x) for x in rng.integers(0, 2, 6)]
        u = rng.random()
        if pocket and pocket[0] - 70 <= pos < pocket[1] + 2:
            pos = pocket[1] + 2
            continue
        if "N" not in seq[pos - 1 : pos + 62]:
            if u < snp:
                alt = rng.choice([c for c in "ACGT" if c != seq[pos - 1]])
                records.append(h.VcfRecord("c", pos, seq[pos - 1], [alt], gt))
            elif u < snp + ins:
                ins_s = "".join(rng.choice(list("ACGT"),
                                           int(rng.integers(1, 5))))
                records.append(h.VcfRecord("c", pos, seq[pos - 1],
                                           [seq[pos - 1] + ins_s], gt))
            else:
                ln = int(rng.integers(20, 61) if rng.random() < long_del
                         else rng.integers(1, 5))
                records.append(h.VcfRecord("c", pos, seq[pos - 1 : pos + ln],
                                           [seq[pos - 1]], gt))
                pos += ln
        pos += int(rng.integers(*step))
    if pocket:
        for p0 in range(*pocket, 3):
            if seq[p0] != "N":
                alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[seq[p0]]
                gt = [int(x) for x in rng.integers(0, 2, 6)]
                records.append(h.VcfRecord("c", p0 + 1, seq[p0], [alt], gt))
        records.sort(key=lambda r: r.pos)
    return h.build_graph("c", seq, records, with_haplotypes=haplotypes)


# -- backbone hits ---------------------------------------------------------


def _pinned_backbone(graph, start, stop, k):
    clusters = port_runs.cluster_sites(graph, start, stop, k)
    return port_runs._build_backbone_run(graph, clusters, start, stop, k)


@pytest.mark.parametrize("haplotypes", [True, False])
@pytest.mark.parametrize("k", [5, 11, 19])
def test_backbone_hits_match_pinned_run(k, haplotypes):
    """Every offset of the region's backbone run, valid or not (the
    pinned reader ignores validity), at the chromosome's start and end,
    past both ends, overlapping and repeated regions, N in windows, and
    indels under the window."""
    graph = _graph(3, long_del=0.3, haplotypes=haplotypes)
    L = graph.length
    assert (graph.haplo is None) != haplotypes
    regions = [(0, L), (-40, 90), (0, k + 3), (L - 100, L + 50),
               (300, 700), (500, 900), (500, 900), (L - k, L), (77, 77 + k)]
    n_n = n_runs = 0
    for start, stop in regions:
        run = _pinned_backbone(graph, start, stop, k)
        if run is None:  # every window determines a site: no backbone hit
            continue
        n_runs += 1
        offs = np.arange(len(run.valid), dtype=np.int64)
        want = port_runs.reconstruct_hits_batch(graph, run, offs, k)
        got = assemble.backbone_hits(graph, start, offs, k)
        for name, a, b in zip(BB, got, want):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {start}")
        n_n += int((got[2] == ord("N")).any(axis=1).sum())
    assert n_n and n_runs >= 6


def test_backbone_short_region_has_no_run():
    """A region shorter than ``k`` (or clipped to it) has no backbone run,
    so no backbone hit reaches the fast route."""
    graph = _graph(4)
    for start, stop in [(10, 20), (graph.length - 9, graph.length + 30),
                        (-50, 4)]:
        assert _pinned_backbone(graph, start, stop, 11) is None


def test_ref_node_array_slices_on_insertions_and_deletions():
    """The whole-chromosome ref node array, sliced to a region, is the
    sweep ``_build_backbone_run`` makes over it (insertions: empty ref
    allele, no ref node; deletions: ref allele node over the span)."""
    graph = _graph(5, long_del=0.5, ins=0.3, snp=0.2)
    assert any(s.ref_end == s.ref_start for s in graph.sites)
    assert any(s.ref_end - s.ref_start >= 20 for s in graph.sites)
    full = port_runs._ref_node_array(graph)
    for start, stop in [(0, graph.length), (113, 517), (-9, 30)]:
        run = _pinned_backbone(graph, start, stop, 5)
        lo = max(0, start)
        np.testing.assert_array_equal(
            run.node_of_base, full[lo : lo + len(run.node_of_base)]
        )


GRAPH_KINDS = {
    "snp_only": dict(snp=1.0, step=(3, 40)),
    "indels": dict(snp=0.5, ins=0.25, step=(4, 30)),
    "long_deletions": dict(snp=0.4, ins=0.1, long_del=0.5, step=(4, 60)),
    "insertions": dict(snp=0.2, ins=0.8, step=(2, 25)),
    "dense": dict(snp=0.6, ins=0.2, long_del=0.1, step=(1, 12),
                  pocket=(600, 720)),
}


@pytest.mark.parametrize("kind", list(GRAPH_KINDS) + ["no_sites", "toy"])
def test_ref_node_array_and_deletables_match_pinned(kind, input_dir):
    """The array builds of the reference node array and the per-site
    deletable span equal the reference's sweep and ``_site_deletable``."""
    def make(h):
        if kind == "toy":
            return _toy(input_dir, h)
        if kind == "no_sites":
            return h.build_graph("c", "ACGTN" * 50, [])
        return _graph(31, length=2400, h=h, **GRAPH_KINDS[kind])

    got, want = make(PORT), make(REF)
    arr = port_runs._ref_node_array(got)
    assert port_runs._ref_node_array(got) is arr
    swept = ref_runs._ref_node_array(want)
    assert arr.dtype == swept.dtype
    np.testing.assert_array_equal(arr, swept)
    dele = port_runs.site_deletables(got)
    assert dele.dtype == np.int64
    np.testing.assert_array_equal(
        dele, [ref_runs._site_deletable(x) for x in want.sites])


def _toy(input_dir, h=PORT):
    seqs = h.read_fasta(str(input_dir / "test.fa"))
    records = list(h.iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    return h.build_graph("x", seqs["x"], records)


@pytest.mark.parametrize("tamper", ["overlap", "no_ref_node"])
def test_ref_node_array_on_overlapping_or_nodeless_pieces(tamper):
    """Overlapping pieces take the sweep, whose later writes win; a site
    whose ref allele has no node writes nothing."""
    got, want = _graph(32), _graph(32, h=REF)
    for g in (got, want):
        if tamper == "overlap":
            s, e, nid = g.segments[3]
            g.segments.append((s - 2, e + 5, nid + 1000))
        else:
            site = next(x for x in g.sites[5:] if x.ref_end > x.ref_start)
            site.allele_nodes[0] = 0
    np.testing.assert_array_equal(port_runs._ref_node_array(got),
                                  ref_runs._ref_node_array(want))


RUN_FIELDS = ("seq", "valid", "pos_begin", "pos_end", "node_of_base",
              "site_info", "region_start", "region_end", "ref")


@pytest.mark.parametrize("k", [5, 19])
def test_build_single_run_cold_matches_reference(k):
    """Every run the native batcher emits for a region of the dense
    graph, rebuilt by ``build_single_run`` on a graph no other call has
    touched (dense-anchored rows, ``ref[0] <= -3``, first), equals the
    reference's rebuild, field for field."""
    got_g = _graph(33, length=2400, **GRAPH_KINDS["dense"])
    want_g = _graph(33, length=2400, h=REF, **GRAPH_KINDS["dense"])
    start, stop = -10, got_g.length - 200
    per_bucket, overflow, fallbacks = ref_native.batch_regions_native(
        want_g, [(start, stop)], k, (64, 128, 256, 512), n_threads=1,
        dense=True)
    assert not overflow and not fallbacks
    refs = set()
    for entry in per_bucket.values():
        for part in (entry, entry.get("patched", {}),
                     entry.get("spliced", {})):
            if "meta" in part:
                refs.update(map(tuple, part["meta"][:, 1:3].tolist()))
    refs = sorted(refs)
    assert refs[0][0] <= -3 and (-1, 0) in refs
    assert len({r[0] for r in refs if r[0] <= -3}) > 1
    assert (k == 5) == any(r[0] >= 0 for r in refs)
    for ref in refs:
        got = port_runs.build_single_run(got_g, start, stop, k, ref)
        want = ref_runs.build_single_run(want_g, start, stop, k, ref)
        assert (got is None) == (want is None), ref
        if got is None:
            continue
        for name in RUN_FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, (ref, name)
                np.testing.assert_array_equal(a, b, err_msg=f"{ref} {name}")
            else:
                assert a == b, (ref, name)


# -- clusters -------------------------------------------------------------


def _positions(clusters):
    return [[(s.site_id, s.ref_start, s.ref_end) for s in c]
            for c in clusters]


@pytest.mark.parametrize("k", [5, 11, 19, 30])
@pytest.mark.parametrize("kind", ["snp_only", "indels", "long_deletions",
                                  "insertions", "dense"])
def test_region_clusters_match_cluster_sites(kind, k):
    """``cluster_sites`` groups the same sites as the reference's
    chaining loop, for the whole chromosome and random sub-regions: the
    graph's own ``Site`` objects, memoised per region and width."""
    kw = GRAPH_KINDS[kind]
    seed = {"snp_only": 11, "indels": 12, "long_deletions": 13,
            "insertions": 14, "dense": 15}[kind]
    graph = _graph(seed, length=2400, **kw)
    ref_graph = _graph(seed, length=2400, h=REF, **kw)
    if kind in ("snp_only", "insertions"):
        assert not port_runs.site_deletables(graph).any()
        assert (kind == "insertions") == any(
            s.ref_end == s.ref_start for s in graph.sites)
    else:
        assert port_runs.site_deletables(graph).any()
    rng = np.random.default_rng(seed * 100 + k)
    regions = [(0, graph.length), (-30, graph.length + 30)] + [
        tuple(sorted(int(x) for x in rng.integers(-20, graph.length + 20, 2)))
        for _ in range(12)
    ]
    ids = {id(s) for s in graph.sites}
    n_multi = 0
    for start, stop in regions:
        got = port_runs.cluster_sites(graph, start, stop, k)
        want = ref_runs.cluster_sites(ref_graph, start, stop, k)
        assert _positions(got) == _positions(want)
        assert all(id(s) in ids for c in got for s in c)
        assert port_runs.cluster_sites(graph, start, stop, k) is got
        n_multi += sum(len(c) > 1 for c in got)
    assert n_multi


class _Sites:
    """The two things ``cluster_sites`` reads of a graph: its sites and
    their spans."""

    def __init__(self, sites):
        self.sites = sites

    def site_spans(self):
        return (np.array([s.ref_start for s in self.sites], np.int64),
                np.array([s.ref_end for s in self.sites], np.int64))


@pytest.mark.parametrize("seed", range(6))
def test_cluster_breaks_match_chaining_loop(seed):
    """Gaps around ``k + 1`` and deletable sums that make a candidate
    break fail, then pass again after a reset, and a long run past the
    early stop; nothing deletable (every candidate breaks) to mostly
    deletable: ``cluster_breaks`` starts a cluster where the reference's
    ``cluster_sites`` does over the same sites."""
    Site = ref_runs.Site
    rng = np.random.default_rng(seed)
    for _ in range(40):
        k = int(rng.integers(1, 40))
        n = int(rng.integers(0, 300))
        gaps = rng.integers(0, 2 * k + 8, n)
        share = rng.choice([0.0, 0.02, 0.2, 0.8])  # sites with a deletion
        dele = np.where(rng.random(n) < share, rng.integers(0, 30, n), 0)
        span = rng.integers(0, 4, n) + dele
        starts = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(span)[:-1]])
        ends = starts + span
        sites = [Site(i, int(a), int(b), ["A" * (b - a), "A" * (b - a - d)],
                      [0, 0])
                 for i, (a, b, d) in enumerate(zip(starts, ends, dele))]
        want = ref_runs.cluster_sites(_Sites(sites), -1, 1 << 40, k)
        firsts = np.cumsum([0] + [len(c) for c in want[:-1]]).tolist()
        assert port_runs.cluster_breaks(starts, ends, dele, k) == \
            (firsts if n else [])


# -- q-values -------------------------------------------------------------


def _as_dict(occupied, q):
    return dict(zip(occupied.tolist(), q.tolist()))


def _bits(values):
    return np.array(list(values), dtype=np.float64).view(np.uint64)


@pytest.fixture(scope="module")
def ctcf_pvalues(input_dir):
    motif = PORT.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                             False)[0]
    return PORT.PvalueLookup(motif.pval_table).pvalues


def _stair(step, n):
    """Non-increasing p-values that repeat over ``step`` scores: every
    block of bins shares one float p (zero-mass gaps)."""
    return lambda s: 1.0 - (np.asarray(s) // step) / float(n)


@pytest.fixture(scope="module")
def jaspar28_table(tmp_path_factory):
    (motif,) = jaspar_motifs(tmp_path_factory.mktemp("meme"), (28,))
    return motif.pval_table


QVALUE_CASES = ["random", "sparse", "ties", "stair", "one_bin", "all_zero",
                "huge_counts", "above_one", "jaspar_width"]


@pytest.mark.parametrize("case", QVALUE_CASES)
def test_qvalue_table_matches_pinned_bitwise(case, ctcf_pvalues,
                                             jaspar28_table):
    rng = np.random.default_rng(QVALUE_CASES.index(case))
    size, pv = 19001, ctcf_pvalues
    pv_want = None  # the pinned function's p-values, where not ``pv``
    hist = np.zeros(size, np.int64)
    if case == "random":
        hist[rng.integers(0, size, 3000)] = rng.integers(1, 1000, 3000)
    elif case == "sparse":
        hist[rng.integers(0, size, 7)] = rng.integers(1, 5, 7)
    elif case == "ties":
        # every score of a wide range: the motif's zero-mass gaps give
        # runs of equal p that must merge into one block
        hist[12000:19001] = rng.integers(1, 50, 7001)
    elif case == "stair":
        size = 2000
        hist = rng.integers(0, 3, size).astype(np.int64)
        pv = _stair(7, size)
    elif case == "one_bin":
        hist[15000] = 9
    elif case == "huge_counts":
        hist[rng.integers(0, size, 500)] = rng.integers(1, 1 << 40, 500)
    elif case == "above_one":  # not a p-value: drives the clip at 1
        hist[rng.integers(0, size, 300)] = rng.integers(1, 9, 300)
        pv = lambda s: 3.0 - np.asarray(s) / size  # noqa: E731
    elif case == "jaspar_width":
        # a width-28 motif's real table and thousands of occupied bins:
        # the dense-cache lookup's lane tail sums against the pinned
        # lookup's scalar ones
        table = jaspar28_table
        size = len(table)
        hist = np.bincount(rng.choice(size, 200_000, p=table / table.sum()),
                           minlength=size).astype(np.int64)
        assert np.count_nonzero(hist) > 2000
        pv = pvalues.PvalueLookup(table).pvalues
        pv_want = PORT.PvalueLookup(table).pvalues
    want = qvalues_from_histogram(hist, pv_want or pv)
    occupied, q = assemble.qvalue_table(hist, pv)
    assert occupied.dtype == np.int64 and q.dtype == np.float64
    got = _as_dict(occupied, q)
    assert list(got) == sorted(want)
    np.testing.assert_array_equal(_bits(got.values()),
                                  _bits(want[s] for s in got))
    if case in ("ties", "stair"):
        p = np.asarray(pv(occupied[::-1]))
        assert (p[1:] == p[:-1]).any()
    if case == "all_zero":
        assert got == {} == want
    if case == "above_one":
        assert (q == 1).any()


# -- end to end -----------------------------------------------------------


def _motif(h, seed, k, flat=False):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 60, (4, k)).astype(np.float64)
    if flat:  # two scores, p >= 1/4: no hit below that threshold
        counts[:] = 10
        counts[0, 0] = 11
    mid = f"M{seed}_{k}"
    return h.process_motif(h.prepare_counts_motif(
        h.Motif(motif_id=mid, motif_name=mid, counts=counts, width=k),
        h.load_bg(UNIF, False), 0.1))


MOTIF_SET = [(1, 8, False), (2, 8, True), (3, 12, False), (4, 12, False),
             (5, 12, True), (6, 19, False)]


def _e2e_inputs(h):
    graph = _graph(21, length=3000, h=h, snp=0.55, ins=0.2, long_del=0.15,
                   step=(5, 30), pocket=(1500, 1620))
    L = graph.length
    rng = np.random.default_rng(22)
    starts = np.sort(rng.integers(-20, L - 50, 24))
    regions = [(int(s), int(s) + int(rng.integers(5, 400))) for s in starts]
    regions += [(0, L), (1400, 1700), (1400, 1700), (L - 60, L + 40),
                (100, 104)]
    motifs = [_motif(h, s, k, flat) for s, k, flat in MOTIF_SET]
    return graph, regions, motifs


def _by_width(motifs):
    out = {}
    for m in motifs:
        out.setdefault(m.width, []).append(m)
    return out


def _port_frames(kw, monkeypatch, cache_dir=None, reload=False,
                 widths=(8, 12, 19)):
    graph, regions, motifs = _e2e_inputs(PORT)
    kinds, frames = set(), {}
    real = port_rs._assemble_columns

    def spy(res, *args):
        kinds.update(src[1][0] for src, _o, _c in res.hits)
        return real(res, *args)

    monkeypatch.setattr(port_rs, "_assemble_columns", spy)
    for k, ms in _by_width(motifs).items():
        if k not in widths:
            continue
        path = None if cache_dir is None else str(cache_dir / f"k{k}.npz")
        for _ in range(2 if reload else 1):
            rr = port_rs.build_region_runs(graph, "c", regions, k)
            frames.update(port_rs.compute_results_runs(
                ms, rr, CPU, cache_path=path, **kw))
    return frames, kinds, graph


def _ref_frames(kw, cache_dir=None, widths=(8, 12, 19)):
    graph, regions, motifs = _e2e_inputs(REF)
    frames = {}
    for k, ms in _by_width(motifs).items():
        if k not in widths:
            continue
        path = None if cache_dir is None else str(cache_dir / f"k{k}.npz")
        rr = ref_rs.build_region_runs(graph, "c", regions, k)
        frames.update(ref_rs.compute_results_runs(ms, rr, cache_path=path,
                                                  **kw))
    return frames


def _same_frames(got, want):
    assert list(got) == list(want)
    for mid in want:
        pd.testing.assert_frame_equal(got[mid], want[mid], check_exact=True)


E2E = {
    "pvalue": dict(threshold=0.02, recomb=True),
    "no_qvalue": dict(threshold=0.02, recomb=True, no_qvalue=True),
    "qvalue": dict(threshold=0.6, recomb=False, qval_t=True),
}


@pytest.mark.parametrize("case", list(E2E))
def test_compute_results_runs_matches_reference(case, monkeypatch):
    """A many-region BED (overlapping and repeated regions, both ends of
    the chromosome, one shorter than every width) over a graph with
    indels and an over-dense pocket: backbone, cluster and
    dense-anchored hits; motifs of three widths, the flat ones with no
    hit."""
    kw = E2E[case]
    got, kinds, _ = _port_frames(kw, monkeypatch)
    assert -1 in kinds and any(c >= 0 for c in kinds)
    assert any(c <= -3 for c in kinds)
    want = _ref_frames(kw)
    _same_frames(got, want)
    sizes = {mid: len(df) for mid, df in got.items()}
    assert sizes["M2_8"] == sizes["M5_12"] == 0
    assert sum(n > 0 for n in sizes.values()) >= 3
    if case == "no_qvalue":
        assert all("q-value" not in df for df in got.values())
    else:
        assert all("q-value" in df for df in got.values())


def test_compute_results_runs_cache_reload(tmp_path, monkeypatch):
    """``--cache-dir``: the first pass writes the checkpoint, the second
    reloads it and rebuilds the fallback (-2) refs eagerly; both equal
    the reference's checkpointed pass."""
    kw = E2E["pvalue"]
    for side in ("port", "ref"):
        (tmp_path / side).mkdir()
    got, kinds, _ = _port_frames(kw, monkeypatch, tmp_path / "port",
                                 reload=True, widths=(12,))
    assert -2 in kinds and -1 in kinds
    assert [p.name for p in (tmp_path / "port").iterdir()] == ["k12.npz"]
    want = _ref_frames(kw, tmp_path / "ref", widths=(12,))
    _same_frames(got, want)


def test_compute_results_runs_without_native(monkeypatch):
    """``GRAFIMO_TPU_NO_NATIVE=1``: the Python batcher fills every
    region's run cache eagerly, so backbone hits read the cached run."""
    monkeypatch.setenv("GRAFIMO_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_LIB_ERR",
                        RuntimeError("native disabled"))
    calls = []
    real = assemble.backbone_hits
    monkeypatch.setattr(port_rs, "backbone_hits",
                        lambda *a: calls.append(a) or real(*a))
    kw = E2E["pvalue"]
    got, kinds, _ = _port_frames(kw, monkeypatch)
    assert -1 in kinds and not calls
    _same_frames(got, _ref_frames(kw))
