"""``tools/bench_torch_chrom_scale.py`` at a small size: its inputs are
the JAX tool's (``tools/bench_chrom_scale.py``) byte for byte, drawn in
that tool's order, and the port's reports on them are the JAX
package's, byte for byte, for the whole-chromosome, ENCODE-shaped and
genome-directory legs (BASELINE configs 2, 1 and 4).  The port runs
through the tool's own CLI runner (a fresh interpreter with JAX and the
reference blocked) on the CPU; the JAX package in this process on the
jax CPU backend."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from grafimo_tpu.cli import main as ref_main

REPO = pathlib.Path(__file__).resolve().parent.parent
# 0.8 Mbp is the shortest chromosome whose three 200 kb pockets do not
# overlap: below it the overlaps draw a variant at nearly every base
# (5x density thrice), where the pinned C++ batcher (both packages')
# ran past 100 s on 0.3 Mbp
MBP, HAPLOTYPES, ENCODE, N_DIR, DIR_MBP, SEED = 0.8, 64, 200, 3, 0.05, 0


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_tool():
    return _module("bench_torch_chrom_scale")


def _jax_tool_inputs(wd: pathlib.Path):
    """The JAX tool's inputs at this size, in the order its ``main``
    draws and writes them (``tools/bench_chrom_scale.py:221-345``; its
    haplotype count is fixed, so its generators are called here)."""
    tool = _module("bench_chrom_scale")
    rng = np.random.default_rng(SEED)
    L = int(MBP * 1e6)
    seq, pos, _ = tool.synth_chrom(rng, L, HAPLOTYPES)
    variants, _ = tool.make_variants(rng, seq, pos, HAPLOTYPES)
    tool.write_fasta(str(wd / "ref.fa"), "21", seq)
    tool.write_vcf(str(wd / "synth.vcf.gz"), "21", seq, variants, HAPLOTYPES)
    r3 = np.random.default_rng(7)
    starts = np.sort(r3.integers(0, L - 300, ENCODE))
    with open(wd / "encode_like.bed", "w") as f:
        for s0 in starts:
            f.write(f"chr21\t{int(s0)}\t{int(s0) + 270}\n")
    names = []
    for i in range(N_DIR):
        Ld = int(DIR_MBP * 1e6)
        sq, ps, _ = tool.synth_chrom(rng, Ld, HAPLOTYPES, pockets=0)
        vs, _ = tool.make_variants(rng, sq, ps, HAPLOTYPES)
        nm = f"d{i+1}"
        tool.write_fasta(str(wd / f"{nm}.fa"), nm, sq)
        tool.write_vcf(str(wd / f"{nm}.vcf.gz"), nm, sq, vs, HAPLOTYPES)
        names.append((nm, Ld))
    with open(wd / "dir.bed", "w") as f:
        for nm, Ld in names:
            f.write(f"chr{nm}\t0\t{Ld}\n")


INPUTS = ["ref.fa", "synth.vcf.gz", "encode_like.bed", "dir.bed"] + [
    f"d{i}.{ext}" for i in range(1, N_DIR + 1) for ext in ("fa", "vcf.gz")]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, port_tool):
    port = tmp_path_factory.mktemp("port")
    drawn = port_tool.write_inputs(str(port), MBP, ENCODE, N_DIR, DIR_MBP,
                                   SEED, reuse=False, haplotypes=HAPLOTYPES)
    ref = tmp_path_factory.mktemp("jax_tool")
    _jax_tool_inputs(ref)
    return port, ref, drawn


def test_inputs_are_the_jax_tools(inputs):
    """FASTA, BGZF VCF, ENCODE-shaped BED and the directory's inputs,
    byte for byte."""
    port, ref, drawn = inputs
    for name in INPUTS:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    assert drawn["n_indels"] > 0 and len(drawn["pockets"]) == 3
    assert drawn["dir"] == [(f"d{i}", 50_000) for i in range(1, N_DIR + 1)]
    assert len((port / "encode_like.bed").read_text().splitlines()) == ENCODE


def test_reuse_skips_the_main_draws(tmp_path, port_tool):
    """With ``--reuse`` and the chromosome's graph present, the main
    chromosome is neither drawn nor written, and the directory's
    chromosomes come from the seed's first draws, as in the JAX tool."""
    (tmp_path / "graphs").mkdir()
    (tmp_path / "graphs" / "21.gvt.npz").write_bytes(b"")
    drawn = port_tool.write_inputs(str(tmp_path), MBP, 0, 1, DIR_MBP, SEED,
                                   reuse=True, haplotypes=HAPLOTYPES)
    assert drawn["reused"] and not (tmp_path / "ref.fa").exists()
    from grafimo_tpu_torch.utils import synth

    rng = np.random.default_rng(SEED)
    seq, _, _ = synth.synth_chrom(rng, int(DIR_MBP * 1e6), HAPLOTYPES,
                                  pockets=0)
    assert (tmp_path / "d1.fa").read_bytes().split(b"\n", 1)[1].replace(
        b"\n", b"") == synth.BASES[seq].tobytes()


@pytest.fixture(scope="module")
def graphs(inputs, port_tool):
    """Each package's graph directory of the same inputs: the port's
    through the tool's ``buildvg`` runs, the JAX package's through its
    CLI."""
    port, ref, drawn = inputs
    out = {}
    for name, root in (("port", port), ("ref", ref)):
        gdir = root / "graphs"
        builds = [("ref.fa", "synth.vcf.gz", True)] + [
            (f"{nm}.fa", f"{nm}.vcf.gz", False) for nm, _ in drawn["dir"]]
        for fa, vcf, reindex in builds:
            if name == "port":
                port_tool.buildvg(str(root / fa), str(root / vcf), str(gdir),
                                  reindex)
            else:
                assert ref_main(["buildvg", "-l", str(root / fa),
                                 "-v", str(root / vcf), "-o", str(gdir)]
                                + (["--reindex"] if reindex else [])) == 0
        out[name] = gdir
    return out


@pytest.mark.parametrize("leg", ["whole", "encode_like", "dir"])
def test_reports_are_the_jax_packages(inputs, graphs, port_tool, tmp_path,
                                      monkeypatch, leg):
    """The tool's ``findmotif`` of each leg on the CPU: TSV and GFF3 equal
    to the JAX package's on the same inputs, and the tool's checks held
    (one flush read a flush block, no kernel launch on the CPU)."""
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    port, ref, drawn = inputs
    beds = {}
    for name, root in (("port", port), ("ref", ref)):
        bed = root / f"{leg}.bed"
        if leg == "whole":
            bed.write_text(f"chr21\t0\t{drawn['length']}\n")
        beds[name] = bed
    got = port_tool.findmotif(str(graphs["port"]), str(beds["port"]),
                              str(tmp_path / "port"), "cpu")
    assert ref_main(["findmotif", "-d", str(graphs["ref"]),
                     "-b", str(beds["ref"]), "-m", port_tool.MOTIF,
                     "-o", str(tmp_path / "ref"), "--verbose"]) == 0
    for name in ("grafimo_out.tsv", "grafimo_out.gff"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "ref" / name).read_bytes(), name
    assert got["hits"] > 0 and got["windows_per_strand"] > 0
    assert got["scanned_sequences"] >= 2 * got["windows_per_strand"]
    assert got["reads"]["flush"] == got["flush_blocks"] >= 1
    assert got["launches"]["scan_runs_fused"] == 0
    assert got["launches"]["plain"] > 0
    assert "device_peak_gib" not in got
    assert all(got[p] >= 0 for p in port_tool.PHASES)
    if leg == "dir":
        assert len({ln.split("\t")[3].split(":")[0] for ln in (
            tmp_path / "port" / "grafimo_out.tsv").read_text().splitlines()[
            1:]}) == N_DIR


def test_tool_refuses_without_a_card(port_tool, monkeypatch, capsys):
    """Without a CUDA device the tool exits 1 before drawing anything, and
    its ``main`` leaves this process's modules as they were: JAX and the
    reference, which the later tests of a worker import lazily, stay
    importable."""
    import torch

    import grafimo_tpu
    import jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["bench_torch_chrom_scale.py"])
    assert port_tool.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert sys.modules["jax"] is jax
    assert sys.modules["grafimo_tpu"] is grafimo_tpu
