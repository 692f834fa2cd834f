"""The comparison that decides ``correct``, at a size a test run holds:
the plain reference agrees with the port's report on the CPU, and a run
with the port broken underneath, or the reference in float32 put in its
place, comes out not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import control, run, spec

TINY = {"length_bp": 200_000, "haplotypes": 64}


def tiny_cell(tmp_path, workload="ctcf_peaks", regions=60, threshold=None):
    """``workload``'s files with its scale cut to a test's size."""
    cell = spec.cell(workload)
    with open(cell["config_path"]) as f:
        config = json.load(f)
    with open(cell["traffic_path"]) as f:
        traffic = json.load(f)
    config.update(TINY)
    if threshold is not None:
        config["threshold"] = threshold
    traffic["regions"] = regions
    cell["config_path"] = str(tmp_path / "config.json")
    cell["traffic_path"] = str(tmp_path / "traffic.json")
    with open(cell["config_path"], "w") as f:
        json.dump(config, f)
    with open(cell["traffic_path"], "w") as f:
        json.dump(traffic, f)
    return cell


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)


def test_reference_agrees_with_the_port_on_the_cpu(tmp_path):
    cell = tiny_cell(tmp_path, threshold=0.01)
    result = run.run(cell, 2**31 + 17, 0.5, trace=True, device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {"graph_load_s", "batching_s", "scan_s"} <= set(
        result["metrics"])


def _drop_half_the_regions():
    import grafimo_tpu_torch.runscan as rs

    real = rs.batch_runs
    rs.batch_runs = lambda regions, *a, **kw: real(regions[::2], *a, **kw)


def _alter_a_hit():
    import grafimo_tpu_torch.runscan as rs

    real = rs._hit_fields

    def altered(*args):
        begins, ends, seq_bytes, is_ref, freqs = real(*args)
        begins = np.array(begins, copy=True)
        begins[0] += 1
        return begins, ends, seq_bytes, is_ref, freqs

    rs._hit_fields = altered


def _alter_the_histogram():
    import grafimo_tpu_torch.runscan as rs

    real = rs.scan_batches

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        res.hists = res.hists.copy()
        res.hists[0, 0] += 1
        return res

    rs.scan_batches = altered


@pytest.mark.parametrize("fault", [_drop_half_the_regions, _alter_a_hit,
                                   _alter_the_histogram])
def test_a_broken_port_is_not_correct(tmp_path, fault):
    import grafimo_tpu_torch.runscan as rs

    saved = {n: getattr(rs, n) for n in ("batch_runs", "_hit_fields",
                                         "scan_batches")}
    cell = tiny_cell(tmp_path, threshold=0.01)
    try:
        result = run.run(cell, 5, 0.1, trace=False, device="cpu",
                         fault=fault)
    finally:
        for name, value in saved.items():
            setattr(rs, name, value)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("seed", [3, 4, 2**32 + 1])
def test_the_float32_control_is_not_correct(tmp_path, seed):
    cell = tiny_cell(tmp_path, regions=200)
    out = control.control(cell, seed, str(tmp_path / "work"))
    assert not out["passes"], out
    assert out["numbers"]["pvalue_rel_err"] > 1e-7


def test_the_float64_reference_passes_itself(tmp_path):
    cell = tiny_cell(tmp_path, regions=200)
    out = control.control(cell, 3, str(tmp_path / "work"), np.float64)
    assert out["passes"], out


def _modules_after(code: str) -> set:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-c", "import sys\nbefore = set(sys.modules)\n"
         + code + "\nprint('\\n'.join(set(sys.modules) - before))"],
        cwd=root, capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_the_reference_loads_nothing_of_the_port():
    top = _modules_after("import benchmark.reference, benchmark.compare")
    assert not top & {"jax", "jaxlib", "flax", "grafimo_tpu",
                      "grafimo_tpu_torch", "torch"}


def test_the_harness_and_the_port_load_no_jax():
    top = _modules_after(
        "from benchmark import spec, run, inputs, control, trace\n"
        "import grafimo_tpu_torch.cli, grafimo_tpu_torch.workflows\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    spec.cell(w['name'])")
    assert "grafimo_tpu_torch" in top
    assert not top & run.FORBIDDEN


def test_planted_sites_carry_hits(tmp_path):
    """A peak with a planted site holds a reference hit far more often
    than one without: at p < 1e-4 a 270 bp region of random bases holds
    about 0.05."""
    from benchmark import inputs, reference

    cell = tiny_cell(tmp_path, regions=200)
    with open(cell["config_path"]) as f:
        config = json.load(f)
    with open(cell["traffic_path"]) as f:
        traffic = json.load(f)
    hits = {}
    for share in (0.0, 1.0):
        work = tmp_path / f"share{share}"
        out = inputs.make(config, dict(traffic, planted_share=share), 7,
                          str(work), graph=False)
        assert out["planted"] == (200 if share else 0)
        with open(work / "motifs.meme") as f:
            want = reference.report(str(work / "truth.npz"), f.read(),
                                    config["chrom"], config["threshold"])
        hits[share] = sum(len(r["start"]) for r in want["rows"].values())
    assert hits[0.0] < 40 and hits[1.0] > 150, hits
