"""The port's per-window engine on the CPU against the reference's: the
copied host modules (``ops/encode.py``, ``ops/pack.py``, ``windows.py``,
``graph/extract.py``) array for array, and ``scan.compute_results``
DataFrames on the chr22 fixture windows, exactly, and against the golden
``scoring_results.tsv``.  Each side gets graphs and motifs built by its own
package's loaders from the same files and numpy arrays."""

import numpy as np
import pandas as pd
import pytest
import torch

import grafimo_tpu.graph.extract as ref_extract
import grafimo_tpu.ops.encode as ref_encode
import grafimo_tpu.ops.pack as ref_pack
import grafimo_tpu.scan as ref_scan
import grafimo_tpu.windows as ref_windows
import grafimo_tpu_torch.graph.extract as port_extract
import grafimo_tpu_torch.ops.encode as port_encode
import grafimo_tpu_torch.ops.pack as port_pack
import grafimo_tpu_torch.scan as port_scan
import grafimo_tpu_torch.windows as port_windows
import grafimo_tpu.graph.sitegraph as ref_sitegraph
import grafimo_tpu.io.fasta as ref_fasta
import grafimo_tpu.io.vcf as ref_vcf
import grafimo_tpu.models.parse as ref_parse
import grafimo_tpu_torch.graph.sitegraph as port_sitegraph
import grafimo_tpu_torch.io.fasta as port_fasta
import grafimo_tpu_torch.io.vcf as port_vcf
import grafimo_tpu_torch.models.parse as port_parse
from grafimo_tpu.utils.constants import N_CODE, PAD_CODE, UNIF
from grafimo_tpu_torch.ops import hist, scan_packed

torch.set_num_threads(1)

CPU = torch.device("cpu")
BATCH_FIELDS = ("width", "seqnames", "seqs", "chroms", "starts", "stops",
                "strands", "freqs", "refs", "paths")


@pytest.fixture(scope="module")
def ctcf(input_dir):
    """CTCF through the port's loader."""
    return port_parse.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                                  False)[0]


@pytest.fixture(scope="module")
def ref_ctcf(input_dir):
    return ref_parse.load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1,
                                 False)[0]


def _toy_graph(input_dir, fasta, vcf, sitegraph):
    seqs = fasta.read_fasta(str(input_dir / "test.fa"))
    records = list(vcf.iter_vcf_records(str(input_dir / "test.vcf.gz"), "x"))
    return sitegraph.build_graph("x", seqs["x"], records)


@pytest.fixture(scope="module")
def toy_graphs(input_dir):
    """The toy graph, built by the port's loaders and by the reference's."""
    return (_toy_graph(input_dir, port_fasta, port_vcf, port_sitegraph),
            _toy_graph(input_dir, ref_fasta, ref_vcf, ref_sitegraph))


def _same_batch(got, want):
    assert type(got).__module__ == "grafimo_tpu_torch.windows"
    for name in BATCH_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name
    np.testing.assert_array_equal(got.codes, want.codes)


# ---------------------------------------------------------------- copies


def test_encode_copy_matches_reference():
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGTNacgtRY"), 13)) for _ in range(40)]
    got = port_encode.seqs_to_codes(seqs, 13)
    want = ref_encode.seqs_to_codes(seqs, 13)
    np.testing.assert_array_equal(got, want)
    assert port_encode.seqs_to_codes([], 7).shape == (0, 7)
    assert port_encode.codes_to_seqs(got) == ref_encode.codes_to_seqs(want)
    np.testing.assert_array_equal(port_encode.revcomp_codes(got),
                                  ref_encode.revcomp_codes(want))
    with pytest.raises(ValueError, match="length mismatch"):
        port_encode.seqs_to_codes(["ACG", "AC"], 3)


@pytest.mark.parametrize("k", [1, 4, 8, 19, 30])
def test_pack_copy_matches_reference(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (50, k)).astype(np.uint8)
    codes[3, 0] = N_CODE
    codes[7, k - 1] = PAD_CODE
    codes[9, :] = N_CODE
    got, want = port_pack.pack_codes(codes), ref_pack.pack_codes(codes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert port_pack.packed_width(k) == ref_pack.packed_width(k)
    np.testing.assert_array_equal(port_pack.unpack_codes(got[0], k),
                                  ref_pack.unpack_codes(want[0], k))
    assert (port_pack.FLAG_CLEAN, port_pack.FLAG_N, port_pack.FLAG_PAD) == (
        ref_pack.FLAG_CLEAN, ref_pack.FLAG_N, ref_pack.FLAG_PAD)


def test_windows_copy_matches_reference(input_dir):
    fn = str(input_dir / "width_19" / "scoring_test_input.tsv")
    got = port_windows.read_windows_tsv(fn, 19)
    want = ref_windows.read_windows_tsv(fn, 19)
    assert len(got) == len(want) > 0
    _same_batch(got, want)
    got_dir = list(port_windows.iter_windows_tsv_dir(str(input_dir), 19))
    want_dir = list(ref_windows.iter_windows_tsv_dir(str(input_dir), 19))
    assert len(got_dir) == len(want_dir) == 1
    _same_batch(got_dir[0], want_dir[0])
    mask = np.arange(len(got)) % 3 == 1
    _same_batch(got.select(mask), want.select(mask))
    _same_batch(port_windows.concat_batches([got, got.select(mask)], 19),
                ref_windows.concat_batches([want, want.select(mask)], 19))
    _same_batch(port_windows.concat_batches([], 19),
                ref_windows.concat_batches([], 19))


@pytest.mark.parametrize(
    "width,region,both",
    [(19, (0, 45), True), (5, (3, 30), True), (19, (0, 45), False),
     (8, (10, 20), False)],
)
def test_extract_copy_matches_reference(toy_graphs, tmp_path, width, region,
                                        both):
    got = port_extract.extract_region(toy_graphs[0], *region, width,
                                      chrom_display="x", both_strands=both)
    want = ref_extract.extract_region(toy_graphs[1], *region, width,
                                      chrom_display="x", both_strands=both)
    assert len(got) == len(want) > 0
    _same_batch(got, want)
    port_extract.write_windows_tsv(got, str(tmp_path / "port.tsv"))
    ref_extract.write_windows_tsv(want, str(tmp_path / "ref.tsv"))
    assert (tmp_path / "port.tsv").read_bytes() == (
        tmp_path / "ref.tsv").read_bytes()
    assert port_extract.revcomp("ACGTN") == ref_extract.revcomp("ACGTN")


def _dense_graph(seed, length=700, vcf=port_vcf, sitegraph=port_sitegraph):
    """A variant every 2-8 bp: SNPs, multi-allelic SNPs, deletions of up
    to 12 bases and insertions, over a random sequence, four diploid
    samples."""
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), length))
    records, pos = [], 3
    while pos < length - 20:
        gt = [int(x) for x in rng.integers(0, 3, 8)]
        kind = rng.random()
        if kind < 0.15:
            ln = int(rng.integers(1, 13))
            records.append(vcf.VcfRecord("d", pos, seq[pos - 1 : pos + ln],
                                         [seq[pos - 1]],
                                         [min(g, 1) for g in gt]))
            pos += ln
        elif kind < 0.3:
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 6))))
            records.append(vcf.VcfRecord("d", pos, seq[pos - 1],
                                         [seq[pos - 1] + ins],
                                         [min(g, 1) for g in gt]))
        else:
            alts = [c for c in "ACGT" if c != seq[pos - 1]][:2]
            records.append(vcf.VcfRecord("d", pos, seq[pos - 1], alts, gt))
        pos += int(rng.integers(2, 9))
    return sitegraph.build_graph("d", seq, records)


@pytest.mark.parametrize("k", [5, 19])
def test_extract_region_cut_matches_reference(k):
    """The port starts the enumerator at the region's first element
    instead of the chromosome's; every region start, inside deletions
    and insertions included, gives the reference's window stream."""
    graph = _dense_graph(k)
    ref_graph = _dense_graph(k, vcf=ref_vcf, sitegraph=ref_sitegraph)
    cut = 0
    for start in range(0, len(graph.seq) - 30, 3):
        got = port_extract.extract_region(graph, start, start + 30, k,
                                          chrom_display="d")
        want = ref_extract.extract_region(ref_graph, start, start + 30, k,
                                          chrom_display="d")
        _same_batch(got, want)
        cut += port_extract._region_view(graph, start) is not graph
    assert cut > 100


# ---------------------------------------------------- compute_results


@pytest.mark.parametrize(
    "kwargs",
    [
        {"threshold": 0.05},
        {"threshold": 1.0, "recomb": True},
        {"threshold": 1.0, "recomb": True, "no_reverse": True},
        {"threshold": 0.9, "recomb": True, "qval_t": True},
        {"threshold": 0.05, "recomb": True, "no_qvalue": True},
    ],
    ids=["default", "all_rows", "no_reverse", "qval_t", "no_qvalue"],
)
def test_compute_results_matches_reference(ctcf, ref_ctcf, input_dir, kwargs):
    want_stats, got_stats = ref_scan.ScanStats(), port_scan.ScanStats()
    want = ref_scan.compute_results(
        ref_ctcf, ref_windows.iter_windows_tsv_dir(str(input_dir), 19),
        stats=want_stats, **kwargs,
    )
    hist.reset_counts()
    scan_packed.reset_counts()
    got = port_scan.compute_results(
        ctcf, port_windows.iter_windows_tsv_dir(str(input_dir), 19), CPU,
        stats=got_stats, **kwargs,
    )
    assert len(want) > 0
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (got_stats.seqs_scanned, got_stats.nucs_scanned) == (
        want_stats.seqs_scanned, want_stats.nucs_scanned)
    # on the CPU the fused score-and-count took its plain version, and no
    # separate histogram ran
    assert scan_packed.COUNTS["plain"] >= 1
    assert scan_packed.COUNTS["kernel"] == scan_packed.COUNTS["fused"] == 0
    assert hist.COUNTS == {"kernel": 0, "plain": 0}


def test_compute_results_chunks_like_one_pass(ctcf, input_dir, monkeypatch):
    """A batch cut into several chunks gives the frame of one pass."""
    batches = list(port_windows.iter_windows_tsv_dir(str(input_dir), 19))
    whole = port_scan.compute_results(ctcf, batches, CPU, threshold=1.0,
                                      recomb=True)
    monkeypatch.setattr(port_scan, "CHUNK", 97)
    scan_packed.reset_counts()
    chunked = port_scan.compute_results(ctcf, batches, CPU, threshold=1.0,
                                        recomb=True)
    assert scan_packed.COUNTS["plain"] == -(-len(batches[0]) // 97)
    pd.testing.assert_frame_equal(chunked, whole, check_exact=True)


def test_compute_results_without_windows_raises(ctcf):
    with pytest.raises(ValueError, match="no result retrieved"):
        port_scan.compute_results(ctcf, [port_windows.WindowBatch.empty(19)],
                                  CPU)


def _sorted(df: pd.DataFrame) -> pd.DataFrame:
    return df.sort_values(
        ["p-value", "start", "stop"], ascending=True
    ).reset_index(drop=True)


def test_scoring_golden_parity(ctcf, input_dir, expected_dir, tmp_path):
    """``tests/test_scoring_parity.py:33`` on the port: the fixture
    windows in test mode round-trip-equal the golden report."""
    results = port_scan.compute_results(
        ctcf, port_windows.iter_windows_tsv_dir(str(input_dir), 19), CPU,
        threshold=1.0, no_qvalue=False, qval_t=False, no_reverse=False,
        recomb=True,
    )
    out = tmp_path / "scoring_test.tsv"
    results.to_csv(out, sep="\t")
    got = _sorted(pd.read_csv(out, sep="\t", index_col=0))
    expected = _sorted(
        pd.read_csv(expected_dir / "scoring_results.tsv", sep="\t", index_col=0)
    )
    pd.testing.assert_frame_equal(got, expected, check_exact=True)
