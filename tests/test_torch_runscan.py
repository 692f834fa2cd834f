"""The port's run-scan engine (``grafimo_tpu_torch/runscan.py``) on the
CPU against the reference's: the copied host half array for array,
``scan_batches`` histograms and hits, and ``compute_results_runs``
DataFrames.  Tolerance 0: integers, and float64 values computed by the
same numpy code from the same integers.  Each side gets graphs and motifs
built by its own package's loaders from the same files and numpy arrays."""

import importlib
import types

import numpy as np
import pandas as pd
import pytest
import torch

import grafimo_tpu.ops.qvalue as ref_qvalue
import grafimo_tpu.runscan as ref_rs
import grafimo_tpu_torch.ops.qvalue as port_qvalue
import grafimo_tpu_torch.runscan as port_rs
from grafimo_tpu.utils.constants import UNIF

torch.set_num_threads(1)

CPU = torch.device("cpu")
BATCH_FIELDS = ("packed", "nbits", "vbits", "gstart", "patches", "splice")


def _host(pkg):
    """The host layers of ``pkg``: the reference's, or the port's copies."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        build_graph=mod("graph.sitegraph").build_graph,
        read_fasta=mod("io.fasta").read_fasta,
        VcfRecord=mod("io.vcf").VcfRecord,
        iter_vcf_records=mod("io.vcf").iter_vcf_records,
        load_bg=mod("models.background").load_bg,
        Motif=mod("models.motif").Motif,
        load_motifs=mod("models.parse").load_motifs,
        prepare_counts_motif=mod("models.parse")._prepare_counts_motif,
        process_motif=mod("models.process").process_motif,
        PvalueLookup=mod("models.pvalue").PvalueLookup,
    )


REF, PORT = _host("grafimo_tpu"), _host("grafimo_tpu_torch")


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the reference shards over conftest's 8 CPU devices otherwise;
    # sharding never changes its values, only its run time
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")


def _toy_graph(input_dir, h=PORT):
    seqs = h.read_fasta(str(input_dir / "test.fa"))
    records = list(h.iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    return h.build_graph("x", seqs["x"], records)


def _random_graph(seed, length=900, h=PORT):
    """SNPs, deletions and insertions over a random sequence with a few
    N bases, three diploid samples."""
    rng = np.random.default_rng(seed)
    seq = list(rng.choice(list("ACGT"), length))
    for p in rng.choice(np.arange(5, length - 5), 6, replace=False):
        seq[p] = "N"
    seq = "".join(seq)
    records, pos = [], 12
    while pos < length - 30:
        gt = [int(x) for x in rng.integers(0, 2, 6)]
        kind = rng.random()
        span = seq[pos - 1 : pos + 6]
        if "N" not in span:
            if kind < 0.15:  # deletion of 1..4 bases
                ln = int(rng.integers(1, 5))
                records.append(h.VcfRecord("r", pos, seq[pos - 1 : pos + ln],
                                           [seq[pos - 1]], gt))
            elif kind < 0.3:  # insertion of 1..4 bases
                ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 5))))
                records.append(h.VcfRecord("r", pos, seq[pos - 1],
                                           [seq[pos - 1] + ins], gt))
            else:
                alt = rng.choice([c for c in "ACGT" if c != seq[pos - 1]])
                records.append(h.VcfRecord("r", pos, seq[pos - 1], [alt], gt))
        pos += int(rng.integers(7, 16))
    return h.build_graph("r", seq, records)


def _motif(seed, k, h=PORT):
    counts = np.random.default_rng(seed).integers(1, 50, (4, k)).astype(
        np.float64
    )
    return h.process_motif(
        h.prepare_counts_motif(
            h.Motif(motif_id="P", motif_name="P", counts=counts, width=k),
            h.load_bg(UNIF, False),
            0.1,
        )
    )


def _scan_inputs(motifs, threshold):
    mats, mins = [], []
    for mt in motifs:
        mats += [mt.score_matrix, port_rs.reverse_complement_pwm(mt.score_matrix)]
        mins += [mt.min_score] * 2
    lookups = [PORT.PvalueLookup(mt.pval_table) for mt in motifs]
    cuts = np.array(
        [lk.score_cutoff(threshold) for lk in lookups for _ in (0, 1)],
        np.int32,
    )
    k = motifs[0].width
    return (port_rs.pwms_to_conv_kernel(mats), np.array(mins, np.int32),
            cuts, k, 1000 * k + 1)


def _assert_batches_equal(got, want, graphs):
    """``graphs``: the (port, reference) graph the batches were cut from."""
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.R == y.R
        assert (x.graph, y.graph) in ((None, None), graphs)
        for f in BATCH_FIELDS:
            a, b = getattr(x, f), getattr(y, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert [(c.source, c.chunk_off) for c in x.chunks] == [
            (c.source, c.chunk_off) for c in y.chunks
        ]


def _both_batches(graphs, display, regions, k, resident):
    # one batcher thread: with several, the native engine's threads claim
    # regions from a shared counter (graphite.cpp:799-812), so the row
    # order of a multi-region call follows scheduling and two calls can
    # differ row for row; scan results do not depend on row order
    got = port_rs.batch_runs(
        port_rs.build_region_runs(graphs[0], display, regions, k), k,
        resident=resident, threads=1,
    )
    want = ref_rs.batch_runs(
        ref_rs.build_region_runs(graphs[1], display, regions, k), k,
        resident=resident, threads=1,
    )
    return got, want


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("which", ["toy", "random"])
def test_batch_runs_matches_reference(input_dir, which, resident):
    if which == "toy":
        graphs = (_toy_graph(input_dir), _toy_graph(input_dir, REF))
        display, regions, k = "x", [(0, 50)], 19
    else:
        graphs = (_random_graph(3), _random_graph(3, h=REF))
        display, regions, k = "r", [(0, 400), (350, graphs[0].length)], 11
    got, want = _both_batches(graphs, display, regions, k, resident)
    kinds = {(b.gstart is None, b.patches is None, b.splice is None)
             for b in got}
    assert len(kinds) >= (3 if which == "random" and resident else 1)
    _assert_batches_equal(got, want, graphs)
    assert port_rs.batch_wire_stats(got, k) == ref_rs.batch_wire_stats(
        want, k
    )
    assert port_rs._format_wire_stats(
        port_rs.batch_wire_stats(got, k)
    ) == ref_rs._format_wire_stats(ref_rs.batch_wire_stats(want, k))


def test_resident_genome_matches_reference():
    # separate graph objects: both functions cache on the graph
    got = port_rs._resident_genome(_random_graph(4))
    want = ref_rs._resident_genome(_random_graph(4, h=REF))
    assert want[1] is not None  # the graph has N bases
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_qvalues_from_histogram_matches_reference(input_dir):
    lookups = [
        h.PvalueLookup(h.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF,
                                     0.1, False)[0].pval_table)
        for h in (PORT, REF)
    ]
    rng = np.random.default_rng(6)
    hist = np.zeros(19001, np.int64)
    hist[rng.integers(0, 19001, 300)] = rng.integers(1, 1000, 300)
    got = port_qvalue.qvalues_from_histogram(hist, lookups[0].pvalues)
    assert got == ref_qvalue.qvalues_from_histogram(hist, lookups[1].pvalues)
    p = rng.random(50)
    np.testing.assert_array_equal(
        port_qvalue.fdr_bh(p), ref_qvalue.fdr_bh(p)
    )


def _mix_batches(mod, graph, rng, k):
    """One batch of each of the five kinds, with N bases (in the graph),
    invalid offsets, empty and full patch slots and negative splice
    shifts; built with ``mod``'s own DeviceBatch/RunChunk classes."""
    L = graph.length
    key = f"{graph.chrom}:0-{L}"

    def chunks(n, c_idx):
        return [mod.RunChunk((key, (c_idx, i)), 0) for i in range(n)]

    def vbits(b, r):
        v = rng.random((b, r - k + 1)) < 0.9
        v[0] = True
        return mod.pack_bits(v)

    out = []
    b, r = 6, 64
    codes = rng.integers(0, 4, (b, r)).astype(np.uint8)
    out.append(mod.DeviceBatch(
        R=r, packed=mod.pack_run_seqs(codes),
        nbits=mod.pack_bits(rng.random((b, r)) < 0.03), vbits=vbits(b, r),
        chunks=chunks(b, 7),
    ))
    r = 128
    stride = r - k + 1
    out.append(mod.DeviceBatch(  # strided: uniform row starts
        R=r, packed=None, nbits=None, vbits=vbits(5, r), chunks=chunks(5, -1),
        gstart=(40 + stride * np.arange(5)).astype(np.int32), graph=graph,
    ))
    gstart = rng.integers(20, L - r - 20, 7).astype(np.int32)
    out.append(mod.DeviceBatch(  # gathered: arbitrary row starts
        R=r, packed=None, nbits=None, vbits=vbits(7, r), chunks=chunks(7, -1),
        gstart=gstart, graph=graph,
    ))
    patches = np.full((7, 16), -1, np.int16)
    for i in range(1, 7):
        n = 16 if i == 1 else int(rng.integers(1, 16))
        patches[i, :n] = rng.choice(r, n, replace=False) * 4 + rng.integers(
            0, 4, n
        )
    out.append(mod.DeviceBatch(
        R=r, packed=None, nbits=None, vbits=vbits(7, r), chunks=chunks(7, 3),
        gstart=gstart, graph=graph, patches=patches,
    ))
    splice = np.full((7, 4), 0x7FFF, np.int16)
    splice[1:, 0] = rng.integers(10, r - 10, 6)
    splice[1:, 1] = rng.integers(-9, 10, 6)
    splice[1, 1] = -9
    out.append(mod.DeviceBatch(
        R=r, packed=None, nbits=None, vbits=vbits(7, r), chunks=chunks(7, 4),
        gstart=gstart, graph=graph, patches=patches, splice=splice,
    ))
    return out


def _mix_graph(h=PORT):
    rng = np.random.default_rng(8)
    seq = list(rng.choice(list("ACGT"), 1500))
    for p in rng.choice(1500, 12, replace=False):
        seq[p] = "N"
    return h.build_graph("m", "".join(seq), [])


@pytest.mark.parametrize("case", ["toy", "random", "random_tiny_cap", "mix"])
def test_scan_batches_matches_reference(input_dir, monkeypatch, case):
    if case == "toy":
        graphs, k = (_toy_graph(input_dir), _toy_graph(input_dir, REF)), 19
        motifs = PORT.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                                  False)
        got_b, want_b = _both_batches(graphs, "x", [(0, 50)], k, True)
    elif case == "mix":
        k = 11
        motifs = [_motif(5, k)]
        got_b = _mix_batches(port_rs, _mix_graph(), np.random.default_rng(9),
                             k)
        want_b = _mix_batches(ref_rs, _mix_graph(REF),
                              np.random.default_rng(9), k)
    else:
        graphs, k = (_random_graph(5), _random_graph(5, h=REF)), 11
        motifs = [_motif(5, k), _motif(6, k)]
        got_b, want_b = _both_batches(graphs, "r", [(0, graphs[0].length)], k,
                                      True)
    if case == "random_tiny_cap":
        # slicing must not change results (the reference pins this at 64)
        monkeypatch.setattr(ref_rs, "MAX_BASES_PER_DISPATCH", 64)
        monkeypatch.setattr(port_rs, "MAX_BASES_PER_DISPATCH", 64)
    args = _scan_inputs(motifs, 0.05)
    got = port_rs.scan_batches(got_b, *args, CPU)
    want = ref_rs.scan_batches(want_b, *args)
    assert got.hists.dtype == np.int64
    np.testing.assert_array_equal(got.hists, want.hists)
    np.testing.assert_array_equal(got.n_windows_per_col,
                                  want.n_windows_per_col)
    assert got.hists.sum() > 0 and len(got.hits) > 0
    assert sorted(got.hits) == sorted(want.hits)


def _toy_cases():
    # the cases of tests/test_runscan.py:47, :60, :75 and :121
    runs = [
        dict(threshold=1.0, recomb=True),
        dict(threshold=1.0, recomb=True, no_reverse=True),
        dict(threshold=1.0, recomb=True, no_qvalue=True),
        dict(threshold=0.05, recomb=True),
        dict(threshold=0.95, recomb=True, qval_t=True),
        dict(threshold=0.96, recomb=False, qval_t=True),
    ]
    return [("toy", kw) for kw in runs] + [
        ("multi_motif", dict(threshold=1.0, recomb=True)),
        ("n_bases", dict(threshold=1.0, recomb=True)),
        ("qvalue_threshold", dict(threshold=0.95, qval_t=True, recomb=True)),
    ]


def _case_inputs(input_dir, case, h):
    """(motifs, graph, display, regions) of a compute_results case, built
    by ``h``'s loaders."""
    motifs = h.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)
    if case == "multi_motif":
        m2 = h.load_motifs(str(input_dir / "MA0139.1.jaspar"), UNIF, 0.1,
                           False)[0]
        m2.motif_id = "MA0139.1-jaspar"
        motifs.append(m2)
    if case == "n_bases":
        seq = "ACGT" * 20 + "N" + "ACGT" * 20
        return motifs, h.build_graph("n", seq, []), "n", [(0, len(seq))]
    return motifs, _toy_graph(input_dir, h), "x", [(0, 50)]


@pytest.mark.parametrize("case,kwargs", _toy_cases())
def test_compute_results_runs_matches_reference(input_dir, case, kwargs):
    motifs, graph, display, regions = _case_inputs(input_dir, case, PORT)
    got = port_rs.compute_results_runs(
        motifs, port_rs.build_region_runs(graph, display, regions, 19), CPU,
        **kwargs,
    )
    motifs, graph, display, regions = _case_inputs(input_dir, case, REF)
    want = ref_rs.compute_results_runs(
        motifs, ref_rs.build_region_runs(graph, display, regions, 19),
        **kwargs,
    )
    assert list(got) == list(want)
    for mid in want:
        pd.testing.assert_frame_equal(got[mid], want[mid], check_exact=True)


def test_score_fault_raises_mismatch(input_dir, monkeypatch):
    """A host/device score disagreement raises after one scan: the
    reference's rescan-once retry is not ported."""
    ctcf = PORT.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                            False)[0]
    real_score, real_scan = port_rs._score_windows_host, port_rs.scan_batches
    scans = []

    def counted_scan(*args, **kwargs):
        scans.append(1)
        return real_scan(*args, **kwargs)

    monkeypatch.setattr(port_rs, "scan_batches", counted_scan)
    monkeypatch.setattr(port_rs, "_score_windows_host",
                        lambda *args: real_score(*args) + 1)
    rr = port_rs.build_region_runs(_toy_graph(input_dir), "x", [(0, 50)], 19)
    with pytest.raises(port_rs._DeviceHostMismatch, match="absent"):
        port_rs.compute_results_runs([ctcf], rr, CPU, threshold=1.0,
                                     recomb=True)
    assert scans == [1]


# ------------------------------------------------ compaction and its reads


# (SCAN_SMALLK, SCAN_TOPK, SCAN_FLUSH_SLICES) of tests/test_runscan.py:107
# and the reads each takes on the toy region's 12 one-row slices at -t 1:
# every tier, over 12, 6 and 4 flush blocks
FETCH_TIERS = [
    ((2, 4, 1), {"flush": 12, "indices": 0, "bits": 11, "hist": 1}),
    ((4, 64, 2), {"flush": 6, "indices": 11, "bits": 0, "hist": 1}),
    ((1, 2, 3), {"flush": 4, "indices": 1, "bits": 11, "hist": 1}),
]


@pytest.mark.parametrize("tiers,reads", FETCH_TIERS)
def test_runscan_fetch_tiers(input_dir, monkeypatch, tiers, reads):
    """The port's counterpart of ``tests/test_runscan.py:99``: every hit
    tier (indices in the flush read, the block's own indices, the packed
    bits) across several flush blocks gives the reference's frames, and
    the host reads once per flush block and dense block, never per
    slice."""
    from grafimo_tpu.graph.extract import extract_region
    from grafimo_tpu.scan import compute_results

    ref_ctcf = REF.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                               False)[0]
    ref_graph = _toy_graph(input_dir, REF)
    want = compute_results(
        ref_ctcf, [extract_region(ref_graph, 0, 50, 19, chrom_display="x")],
        threshold=1.0, recomb=True,
    )
    want_runs = ref_rs.compute_results_runs(
        [ref_ctcf], ref_rs.build_region_runs(ref_graph, "x", [(0, 50)], 19),
        threshold=1.0, recomb=True,
    )[ref_ctcf.motif_id]
    for name, value in zip(("SCAN_SMALLK", "SCAN_TOPK", "SCAN_FLUSH_SLICES"),
                           tiers):
        monkeypatch.setattr(port_rs, name, value)
    monkeypatch.setattr(port_rs, "MAX_BASES_PER_DISPATCH", 64)
    ctcf = PORT.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                            False)[0]
    rr = port_rs.build_region_runs(_toy_graph(input_dir), "x", [(0, 50)], 19)
    port_rs.reset_reads()
    got = port_rs.compute_results_runs([ctcf], rr, CPU, threshold=1.0,
                                       recomb=True)[ctcf.motif_id]
    assert port_rs.READS == reads
    pd.testing.assert_frame_equal(got, want_runs, check_exact=True)

    def canon(df):
        return df.sort_values(
            ["p-value", "start", "stop", "strand", "matched_sequence"]
        ).reset_index(drop=True)

    pd.testing.assert_frame_equal(canon(got), canon(want), check_exact=True)


def test_scan_batches_devices_compress_and_compact(monkeypatch):
    """``scan_batches`` over ``[cpu] * 3`` with small tiers, compressed
    histograms and compacted hits == the reference's single-device scan;
    one flush read per flush block (the three listings share one
    device), never one per slice."""
    monkeypatch.setattr(port_rs, "SCAN_SMALLK", 2)
    monkeypatch.setattr(port_rs, "SCAN_TOPK", 8)
    monkeypatch.setattr(port_rs, "SCAN_FLUSH_SLICES", 2)
    monkeypatch.setattr(port_rs, "MAX_BASES_PER_DISPATCH", 256)
    k = 11
    motifs = [_motif(5, k), _motif(6, k)]
    args = _scan_inputs(motifs, 0.05)
    got_b = _mix_batches(port_rs, _mix_graph(), np.random.default_rng(9), k)
    want_b = _mix_batches(ref_rs, _mix_graph(REF), np.random.default_rng(9), k)
    port_rs.reset_reads()
    got = port_rs.scan_batches(got_b, *args, [CPU] * 3)
    want = ref_rs.scan_batches(want_b, *args)
    np.testing.assert_array_equal(got.hists, want.hists)
    assert sorted(got.hits) == sorted(want.hits) and len(got.hits) > 0
    n_slices = sum(-(-len(b.chunks) // (3 * max(1, 256 // b.R)))
                   for b in got_b)
    assert port_rs.READS["flush"] == -(-n_slices // 2)
    assert port_rs.READS["hist"] == 1
    assert port_rs.READS["indices"] + port_rs.READS["bits"] > 0


def _mixed_base_batch(mod, rng, k, b, r):
    """A packed batch with N bases and invalid offsets, and a PWM whose
    columns sit on different bases (``tests/test_hist_compress.py:36``)."""
    m = 6
    noff = r - k + 1
    batch = mod.DeviceBatch(
        R=r, packed=mod.pack_run_seqs(rng.integers(0, 4, (b, r))),
        nbits=mod.pack_bits(rng.random((b, r)) < 0.02),
        vbits=mod.pack_bits(rng.random((b, noff)) < 0.9),
        chunks=[mod.RunChunk(("c:0-1", (0, i)), 0) for i in range(b)],
    )
    pwm = np.stack([rng.integers(0, 400, (k, 4)) + 100 * c for c in range(m)],
                   axis=-1).astype(np.float32)
    mins = pwm.reshape(-1, m).min(axis=0).astype(np.int32)
    cuts = (pwm.max(axis=1).sum(axis=0) - 300).astype(np.int32)
    return batch, pwm, mins, cuts


def test_scan_batches_compressed_equals_full_histogram():
    """The counterpart of ``tests/test_hist_compress.py``: the port always
    counts each column over its reachable scores alone (bin 0 the N
    value); expanded, the histogram is the reference's full one, N
    windows and invalid offsets included, and so are the hits."""
    k, b, r = 11, 16, 96
    got_batch, pwm, mins, cuts = _mixed_base_batch(
        port_rs, np.random.default_rng(3), k, b, r)
    want_batch, *_ = _mixed_base_batch(ref_rs, np.random.default_rng(3), k,
                                       b, r)
    hist_size = 1000 * k + 1
    got = port_rs.scan_batches([got_batch], pwm, mins, cuts, k, hist_size,
                               CPU)
    want = ref_rs.scan_batches([want_batch], pwm, mins, cuts, k, hist_size)
    np.testing.assert_array_equal(got.hists, want.hists)
    assert sorted(got.hits) == sorted(want.hits) and len(got.hits) > 0
    for col in range(pwm.shape[-1]):  # N windows counted at min_score
        assert got.hists[int(mins[col]), col] > 0


@pytest.mark.parametrize("seed", [7, 8])
def test_end_to_end_compressed_equals_reference(monkeypatch, seed):
    """``tests/test_hist_compress.py:79``'s graphs and motifs: the port's
    reports (compression always on) equal the reference's with its
    compression forced and off."""
    def setup(h):
        rng = np.random.default_rng(seed)
        seq = "".join(rng.choice(list("ACGT"), 700))
        seq = seq[:100] + "NNNN" + seq[104:400] + "NN" + seq[402:]
        records = []
        for pos0 in sorted(rng.choice(np.arange(5, 690), 8, replace=False)):
            pos0 = int(pos0)
            if seq[pos0] == "N":
                continue
            alt = rng.choice([c for c in "ACGT" if c != seq[pos0]])
            records.append(h.VcfRecord(
                chrom="h", pos=pos0 + 1, ref=seq[pos0], alts=[alt],
                gt=[int(rng.integers(0, 2)) for _ in range(4)]))
        graph = h.build_graph("h", seq, records)
        motifs = []
        for mid in ("HC01", "HC02"):
            counts = rng.integers(1, 50, (4, 9)).astype(np.float64)
            motifs.append(h.process_motif(h.prepare_counts_motif(
                h.Motif(motif_id=mid, motif_name=mid, counts=counts, width=9),
                h.load_bg(UNIF, False), 0.1)))
        return graph, motifs

    graph, motifs = setup(PORT)
    got = port_rs.compute_results_runs(
        motifs, port_rs.build_region_runs(graph, "h", [(0, graph.length)], 9),
        CPU, threshold=0.5, recomb=True)
    graph, motifs = setup(REF)
    for mode in ("force", "off"):
        monkeypatch.setenv("GRAFIMO_HIST_COMPRESS", mode)
        want = ref_rs.compute_results_runs(
            motifs, ref_rs.build_region_runs(graph, "h", [(0, graph.length)],
                                             9),
            threshold=0.5, recomb=True)
        assert list(got) == list(want)
        for mid in want:
            assert len(got[mid]) > 0
            pd.testing.assert_frame_equal(got[mid], want[mid],
                                          check_exact=True)
