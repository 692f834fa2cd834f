"""The port's many-motif configurations (BASELINE configs 3-5) on the CPU
against the JAX package: the counterparts of ``tests/test_scale_configs.py``
(a many-column histogram, 100 PWMs in one pass, a 50-motif mixed-width
ladder, a 24-graph genome directory), each run through both packages on
the same numpy-seeded inputs; the ladder's input generators against
``tools/bench_jaspar_ladder.py``; the fused route's plan at hundreds of
columns; and the slice rule.  Tolerance 0 throughout: scores and
histograms are integers, and p- and q-values come from the same numpy
code on the same integers."""

import ast
import importlib.util
import pathlib
import types

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import grafimo_tpu.cli as ref_cli
import grafimo_tpu.runscan as ref_rs
import grafimo_tpu_torch.cli as port_cli
import grafimo_tpu_torch.runscan as port_rs
from grafimo_tpu.ops.score_runs import _exact_hist
from grafimo_tpu.utils.constants import UNIF
from grafimo_tpu_torch.ops import score_runs as sr
from grafimo_tpu_torch.ops.compact import compact_hits
from grafimo_tpu_torch.ops.hist import exact_hist
from grafimo_tpu_torch.utils import synth
from test_torch_runscan import PORT, REF

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the reference shards over conftest's 8 CPU devices otherwise
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_jaspar_ladder", REPO / "tools" / "bench_jaspar_ladder.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _motif(h, rng, k, mid):
    """``tests/test_scale_configs.py``'s motif: seeded counts."""
    counts = rng.integers(1, 50, (4, k)).astype(np.float64)
    return h.process_motif(h.prepare_counts_motif(
        h.Motif(motif_id=mid, motif_name=mid, counts=counts, width=k),
        h.load_bg(UNIF, False), 0.1))


def _graph(h, rng, chrom, length=240, n_snp=4):
    """``tests/test_scale_configs.py``'s graph: SNPs over 4 haplotypes."""
    seq = "".join(rng.choice(list("ACGT"), length))
    records = []
    for pos0 in sorted(rng.choice(np.arange(5, length - 5), n_snp,
                                  replace=False)):
        pos0 = int(pos0)
        alt = rng.choice([c for c in "ACGT" if c != seq[pos0]])
        gt = [int(rng.integers(0, 2)) for _ in range(4)]
        records.append(h.VcfRecord(chrom=chrom, pos=pos0 + 1, ref=seq[pos0],
                                   alts=[alt], gt=gt))
    return h.build_graph(chrom, seq, records)


def _both(seed, make):
    """``make(h, rng)`` for each package from the same seed."""
    return (make(PORT, np.random.default_rng(seed)),
            make(REF, np.random.default_rng(seed)))


def _runs(rs, graph, chrom, stop, motifs, threshold, **kwargs):
    rr = rs.build_region_runs(graph, chrom, [(0, stop)], motifs[0].width)
    if rs is port_rs:
        return port_rs.compute_results_runs(motifs, rr, CPU,
                                            threshold=threshold, **kwargs)
    return ref_rs.compute_results_runs(motifs, rr, threshold=threshold,
                                       **kwargs)


def _same_frames(got, want):
    assert list(got) == list(want)
    for mid in want:
        pd.testing.assert_frame_equal(got[mid], want[mid], check_exact=True)


# ------------------------------------------------------------ the four configs


def test_exact_hist_many_columns():
    """12 columns in one histogram: the port's ``exact_hist`` equals the
    reference's ``_exact_hist`` (its ``lax.map`` path past 8 columns) and
    a per-column ``bincount``, with and without the remap."""
    rng = np.random.default_rng(0)
    hist_size = 801
    scores = rng.integers(-1, hist_size, (64, 30, 12)).astype(np.int32)
    want = np.asarray(_exact_hist(jnp.asarray(scores), hist_size))
    np.testing.assert_array_equal(want, np.stack(
        [np.bincount(scores[:, :, c][scores[:, :, c] >= 0],
                     minlength=hist_size) for c in range(12)], axis=1))
    got = exact_hist(torch.from_numpy(scores), hist_size)
    np.testing.assert_array_equal(got.numpy(), want)
    bases = rng.integers(0, 50, 12).astype(np.int32)
    remapped = exact_hist(torch.from_numpy(scores), hist_size,
                          torch.from_numpy(bases))
    # the reference's remap (ops/score_runs.py:517): bin 0 below the base
    shifted = np.where(scores < 0, -1, np.maximum(scores - bases + 1, 0))
    np.testing.assert_array_equal(remapped.numpy(), np.asarray(
        _exact_hist(jnp.asarray(shifted.astype(np.int32)), hist_size)))


def test_hundred_pwm_single_pass():
    """Config 5's shape: 100 same-width PWMs (200 device columns) in one
    pass; every motif's frame equals the reference's, and sampled motifs
    equal their single-motif scans."""
    def make(h, rng):
        motifs = [_motif(h, rng, 8, f"J{i:03d}") for i in range(100)]
        return motifs, _graph(h, rng, "j", length=400, n_snp=6)

    (motifs, graph), (ref_motifs, ref_graph) = _both(42, make)
    got = _runs(port_rs, graph, "j", graph.length, motifs, 0.05, recomb=True)
    _same_frames(got, _runs(ref_rs, ref_graph, "j", ref_graph.length,
                            ref_motifs, 0.05, recomb=True))
    assert sum(len(df) for df in got.values()) > 0
    for mi in (0, 37, 99):
        alone = _runs(port_rs, graph, "j", graph.length, [motifs[mi]], 0.05,
                      recomb=True)
        _same_frames(alone, {motifs[mi].motif_id: got[motifs[mi].motif_id]})


def test_fifty_motif_mixed_width_ladder():
    """Config 5's ladder: 50 PWMs over JASPAR CORE's width histogram (the
    port's ``WIDTH_PMF``), one pass a width over one pangenome graph;
    every frame equals the reference's, and sampled motifs equal their
    single-motif scans."""
    widths = list(synth.WIDTH_PMF)
    probs = np.array([synth.WIDTH_PMF[w] for w in widths])
    probs = probs / probs.sum()

    def make(h, rng):
        ks = rng.choice(widths, size=50, p=probs)
        motifs = [_motif(h, rng, int(k), f"L{i:02d}")
                  for i, k in enumerate(ks)]
        return motifs, _graph(h, rng, "m", length=900, n_snp=14)

    (motifs, graph), (ref_motifs, ref_graph) = _both(21, make)
    got, want = {}, {}
    for k in sorted({mo.width for mo in motifs}):
        got.update(_runs(port_rs, graph, "m", 900,
                         [mo for mo in motifs if mo.width == k], 0.02,
                         recomb=True))
        want.update(_runs(ref_rs, ref_graph, "m", 900,
                          [mo for mo in ref_motifs if mo.width == k], 0.02,
                          recomb=True))
    assert len({mo.width for mo in motifs}) > 5
    _same_frames(got, want)
    assert sum(len(df) for df in got.values()) > 0
    for mi in (0, 17, 43):
        mo = motifs[mi]
        alone = _runs(port_rs, graph, "m", 900, [mo], 0.02, recomb=True)
        _same_frames(alone, {mo.motif_id: got[mo.motif_id]})


def test_whole_genome_24_graph_directory(tmp_path, capsys):
    """Config 4: 24 per-chromosome graphs and two widths through
    ``findmotif -d``; the port's TSV, GFF3 and HTML reports equal the
    reference's byte for byte, with q-values over the hit set merged
    across every graph."""
    rng = np.random.default_rng(7)
    gdir = tmp_path / "graphs"
    gdir.mkdir()
    bed = []
    for c in [str(i) for i in range(1, 23)] + ["X", "Y"]:
        g = _graph(REF, rng, c)
        g.save(str(gdir / f"{c}.gvt.npz"))
        bed.append(f"chr{c}\t0\t{g.length}\n")
    (tmp_path / "all.bed").write_text("".join(bed))
    lines = ["MEME version 4", "", "ALPHABET= ACGT", ""]
    for mid, w in [("W9", 9), ("W13", 13)]:
        lines += [f"MOTIF {mid}", "letter-probability matrix: alength= 4 "
                  f"w= {w} nsites= 100 E= 0"]
        lines += [" ".join(f"{x:.6f}" for x in rng.dirichlet([1.0] * 4))
                  for _ in range(w)]
        lines.append("")
    (tmp_path / "two.meme").write_text("\n".join(lines))
    argv = ["findmotif", "-d", str(gdir), "-b", str(tmp_path / "all.bed"),
            "-m", str(tmp_path / "two.meme"), "-t", "0.5", "--recomb", "-o"]
    assert ref_cli.main(argv + [str(tmp_path / "ref")]) == 0
    assert port_cli.main(argv + [str(tmp_path / "port"), "--device",
                                 "cpu"]) == 0
    assert capsys.readouterr().out.count("Scanned sequences:") == 4
    for mid in ("W9", "W13"):
        for ext in ("tsv", "gff", "html"):
            name = f"grafimo_out_{mid}.{ext}"
            assert ((tmp_path / "port" / name).read_bytes()
                    == (tmp_path / "ref" / name).read_bytes())
        df = pd.read_csv(tmp_path / "port" / f"grafimo_out_{mid}.tsv",
                         sep="\t", index_col=0)
        assert len({s.split(":")[0] for s in df["sequence_name"]}) >= 12
        assert (df["q-value"] <= 1.0).all()
        assert (df["q-value"] >= df["p-value"] - 1e-12).all()


# ------------------------------------------------------- the ladder's inputs


def test_synth_meme_writes_the_tool_bytes(tmp_path):
    """``synth.synth_meme`` writes ``tools/bench_jaspar_ladder.py``'s MEME
    file byte for byte from one seed, and the same width histogram."""
    tool = _tool()
    assert synth.WIDTH_PMF == tool.WIDTH_PMF
    got = synth.synth_meme(str(tmp_path / "port.meme"), 120,
                           np.random.default_rng(0))
    want = tool.synth_meme(str(tmp_path / "tool.meme"), 120,
                           np.random.default_rng(0))
    assert got == want and len(got) > 10
    assert ((tmp_path / "port.meme").read_bytes()
            == (tmp_path / "tool.meme").read_bytes())


def _tool_pangenome(rng, L, H):
    """The tool's pangenome: the statements of its ``main`` from the
    chromosome through the records, run with the reference's records."""
    tree = ast.parse((REPO / "tools" / "bench_jaspar_ladder.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = [getattr(s.targets[0], "id", None)
             if isinstance(s, ast.Assign) else None for s in main.body]
    body = main.body[names.index("seq") : names.index("records") + 1]
    scope = dict(np=np, rng=rng, L=L, H=H, VcfRecord=REF.VcfRecord)
    exec(compile(ast.Module(body=body, type_ignores=[]), "tool", "exec"),
         scope)
    return scope["seq"], scope["records"]


def test_ladder_pangenome_is_the_tools():
    """``synth.ladder_pangenome`` draws the tool's chromosome and records
    from the same generator state, and both packages build the same
    graph of them."""
    seq, records = synth.ladder_pangenome(np.random.default_rng(3), 30_000,
                                          64)
    ref_seq, ref_records = _tool_pangenome(np.random.default_rng(3), 30_000,
                                           64)
    assert seq == ref_seq and len(records) == len(ref_records) > 900
    for a, b in zip(records, ref_records):
        assert (a.chrom, a.pos, a.ref, a.alts) == (b.chrom, b.pos, b.ref,
                                                   b.alts)
        np.testing.assert_array_equal(a.gt, b.gt)
    g, rg = PORT.build_graph("c", seq, records), REF.build_graph(
        "c", ref_seq, ref_records)
    assert g.seq == rg.seq and len(g.sites) == len(rg.sites)
    np.testing.assert_array_equal(g.node_ref_start, rg.node_ref_start)


# ------------------------------------------- the fused route at many columns


@pytest.fixture(scope="module")
def ladder_meme(tmp_path_factory):
    """``synth_meme``'s 800-PWM ladder, seed 0, as ``tools/
    bench_jaspar_ladder.py`` writes it."""
    path = tmp_path_factory.mktemp("ladder") / "ladder.meme"
    synth.synth_meme(str(path), 800, np.random.default_rng(0))
    return str(path)


def _width(h, meme, k):
    """The ladder's motifs of width ``k``, loaded by ``h``'s package."""
    return [mo for mo in h.load_motifs(meme, UNIF, 0.1, False)
            if mo.width == k]


def _block_inputs(motifs, m, threshold=1e-3):
    mats, mins, cuts = [], [], []
    for i in range(m // 2):
        mo = motifs[i % len(motifs)]
        cut = PORT.PvalueLookup(mo.pval_table).score_cutoff(threshold)
        mats += [mo.score_matrix, sr.reverse_complement_pwm(mo.score_matrix)]
        mins += [mo.min_score] * 2
        cuts += [cut] * 2
    kernel = sr.pwms_to_conv_kernel(mats)
    bases, _, comp = port_rs.hist_layout(kernel)
    return (sr.pwm_lut_from_kernel(kernel, CPU),
            torch.tensor(mins, dtype=torch.int32),
            torch.tensor(cuts, dtype=torch.int32),
            torch.from_numpy(bases.astype(np.int32)), comp)


@pytest.mark.parametrize("k,m", [(11, 100), (11, 224), (6, 400)])
def test_fused_plan_at_hundreds_of_columns(ladder_meme, k, m):
    """The ladder's widths at 100, 224 and 400 columns: the plan takes the
    fused route in column groups whose bins, pair tables and rows fit an
    H100 block (``fused_smem`` of ``csrc/scan_runs.cu``); ``scan_block``
    (its plain version here) equals ``scan_block_reference`` and the
    three launches' plain versions on patched rows."""
    from test_torch_scan_runs import _patches
    from test_torch_score_runs import _genome

    lut, mins, cuts, bases, comp = _block_inputs(
        _width(PORT, ladder_meme, k), m)
    r = 256
    plan = sr.fused_plan(m, k, r, comp)
    assert plan["route"] == "fused" and plan["groups"] > 1
    group = -(-m // plan["groups"])
    noff, chunks = r - k + 1, -(-(r - k + 1) // 32)
    rpg = min(max(32 // -(-chunks // 4), 1), 64)
    npairs = ((k + 1) // 2 + 3) // 4 * 4
    rows_ints = 4 * rpg * ((r + 15) // 16 + 3 + (r + 31) // 32 + 2
                           + chunks + 6)
    smem = 4 * ((group * comp + 3) // 4 * 4 + group * (npairs * 16 + 3)
                + rows_ints)
    assert smem <= sr.H100_SMEM_BLOCK
    assert sr.fused_plan(m, k, r, comp + (sr.H100_SMEM_BLOCK - smem) // 4
                         // group + 1)["groups"] > plan["groups"]

    rng = np.random.default_rng([k, m])
    _, _, g4, gn = _genome(rng, 20_000, 0.01)
    g4, gn = sr.genome_planes_to_device(g4, gn, CPU)
    b = 6
    gstart = torch.from_numpy(rng.integers(16, 20_000 - r - 16, b).astype(
        np.int32))
    patches = torch.from_numpy(_patches(rng, b, r, 4))
    rows = sr.patched_rows(g4, gn, gstart, patches, r)
    v = rng.random((b, noff)) < 0.9
    v[-1] = False
    vb = torch.from_numpy(sr.pack_bits(v))

    def buffers():
        return (torch.zeros(1, dtype=torch.int32),
                torch.full((64,), -1, dtype=torch.int32),
                torch.full((8192,), -1, dtype=torch.int32))

    got, ref, three = buffers(), buffers(), buffers()
    h, bits = sr.scan_block(rows, vb, lut, mins, k, cuts, comp, bases, *got)
    h_ref, bits_ref = sr.scan_block_reference(rows, vb, lut, mins, k, cuts,
                                              comp, bases, *ref)
    h3, s3 = sr.scan_runs_resident_patched(g4, gn, gstart, patches, vb, lut,
                                           mins, r, k, comp, bases)
    bits3 = compact_hits(s3, cuts, *three)
    assert s3.shape == (b, noff, m)
    for hh, bb, buf in ((h_ref, bits_ref, ref), (h3, bits3, three)):
        assert torch.equal(h, hh) and torch.equal(bits, bb)
        for x, y in zip(got, buf):
            assert torch.equal(x, y)
    assert int(h.sum()) == int((s3 >= 0).sum()) > 0 and int(got[0]) > 0


# ------------------------------------------------------------ the slice rule


GUARD = port_rs.FLAT_INDEX_LIMIT


@pytest.mark.parametrize("m", [2, 224, 1600])
def test_slice_rows_bounds(m):
    """The fused route's block: under the dispatch cap and the flat hit
    index, and the largest that is; a route that writes the score plane
    keeps the plane bound (``cap / (m // 4)`` bases)."""
    cap = port_rs.MAX_BASES_PER_DISPATCH
    for k in (6, 11, 30):
        for r in port_rs.BUCKETS:
            rows = port_rs.slice_rows(r, k, m, cap, plane=False)
            windows = (r - k + 1) * m
            assert rows * windows < GUARD and rows * r <= cap
            assert (rows + 1) * windows >= GUARD or (rows + 1) * r > cap
            assert port_rs.slice_rows(r, k, m, cap, plane=True) == max(
                1, cap // max(1, m // 4) // r)
    # the main path (CTCF, M = 2) keeps its blocks; many columns grow
    assert port_rs.slice_rows(2048, 19, 2, cap, False) == 8192
    if m > 8:
        assert (port_rs.slice_rows(2048, 11, m, cap, False)
                > port_rs.slice_rows(2048, 11, m, cap, True))


def _rows_batch(r, n):
    return types.SimpleNamespace(R=r, gstart=np.zeros(n, np.int32),
                                 packed=None)


@pytest.mark.parametrize("m", [2, 224, 1600])
def test_plan_slices_flush_budget(monkeypatch, m):
    """``plan_slices`` on the fused route: every row once, in order; each
    slice the rule's rows for all devices; a flush after every
    ``SCAN_FLUSH_SLICES`` slices and the last, and before the kept hit
    bits would pass ``SCAN_FLUSH_BYTES``."""
    monkeypatch.setattr(port_rs, "_writes_plane", lambda *a: False)
    monkeypatch.setattr(port_rs, "SCAN_FLUSH_BYTES", 1 << 27)
    monkeypatch.setattr(port_rs, "SCAN_FLUSH_SLICES", 8)
    k, devs = 11, [CPU, CPU]
    batches = [_rows_batch(2048, 40_000), _rows_batch(64, 300_000)]
    plan = port_rs.plan_slices(batches, k, m, 5000, devs)
    for bi, batch in enumerate(batches):
        cut = [(lo, hi) for b, lo, hi, _ in plan if b == bi]
        per = 2 * port_rs.slice_rows(batch.R, k, m,
                                     port_rs.MAX_BASES_PER_DISPATCH_CPU,
                                     False)
        assert cut[0][0] == 0 and cut[-1][1] == batch.gstart.shape[0]
        assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
        assert all(hi - lo == per for lo, hi in cut[:-1])
    assert plan[-1][3]
    kept = since = 0
    for bi, lo, hi, flush in plan:
        kept += (hi - lo) * ((batches[bi].R - k + 8) // 8) * m
        since += 1
        assert since <= 8 and (kept <= 1 << 27 or since == 1)
        if flush:
            kept = since = 0


def _ladder_graphs(seed):
    """A 3 kbp ladder pangenome over 16 haplotypes: the port's generator
    for the port, the tool's own statements for the reference."""
    seq, records = synth.ladder_pangenome(np.random.default_rng(seed), 3000,
                                          16)
    ref_seq, ref_records = _tool_pangenome(np.random.default_rng(seed), 3000,
                                           16)
    return (PORT.build_graph("c", seq, records),
            REF.build_graph("c", ref_seq, ref_records))


@pytest.mark.parametrize("cap,plane,flush_bytes", [
    (1 << 19, True, 1 << 30),     # the CPU's own rule
    (1 << 19, False, 1 << 30),    # the fused route's rule
    (4096, False, 1 << 13),       # small blocks, a flush every few
    (256, True, 1 << 30),         # the plane bound at a tiny cap
])
def test_reports_do_not_depend_on_the_slicing(ladder_meme, monkeypatch,
                                              cap, plane, flush_bytes):
    """40 ladder PWMs of one width over a small ladder pangenome: the
    port's frames equal the reference's whatever the slices and flushes,
    and the flush reads are the plan's."""
    motifs = _width(PORT, ladder_meme, 11)[:40]
    graph, ref_graph = _ladder_graphs(4)
    want = _runs(ref_rs, ref_graph, "c", 3000,
                 _width(REF, ladder_meme, 11)[:40], 5e-3)
    monkeypatch.setattr(port_rs, "MAX_BASES_PER_DISPATCH", cap)
    monkeypatch.setattr(port_rs, "_writes_plane", lambda *a: plane)
    monkeypatch.setattr(port_rs, "SCAN_FLUSH_BYTES", flush_bytes)
    port_rs.reset_reads()
    got = _runs(port_rs, graph, "c", 3000, motifs, 5e-3)
    _same_frames(got, want)
    assert sum(len(df) for df in got.values()) > 0
    batches = port_rs.batch_runs(
        port_rs.build_region_runs(graph, "c", [(0, 3000)], 11), 11)
    kernel = sr.pwms_to_conv_kernel(
        [m for mo in motifs for m in (mo.score_matrix,
                                      sr.reverse_complement_pwm(
                                          mo.score_matrix))])
    plan = port_rs.plan_slices(batches, 11, 80,
                               port_rs.hist_layout(kernel)[2], [CPU])
    assert port_rs.READS["flush"] == sum(f for *_, f in plan) > 0
