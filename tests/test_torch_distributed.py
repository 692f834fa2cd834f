"""The port's multi-process scan on the CPU: a 2-process ``findmotif``
(``torch.distributed``, gloo over localhost) writes a report
byte-identical to the one-process port run and to the JAX package's
one-process report, with only rank 0 writing and printing the counters;
a rank whose region shard is empty still takes part (modelled on
``tests/test_distributed.py:72``).  Also the collectives of
``parallel/cluster.py`` on their own.

Each process is a fresh interpreter in which importing ``jax`` or
``grafimo_tpu`` fails, on one thread (the suite runs under xdist)."""

import json
import os
import socket
import subprocess
import sys

import pytest

from grafimo_tpu.cli import main as ref_main
from grafimo_tpu_torch.cli import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = "import sys\nsys.modules['jax'] = sys.modules['grafimo_tpu'] = None\n"
CLI = BLOCK + (
    "from grafimo_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)
COLLECTIVES = BLOCK + """\
import json
import numpy as np
from grafimo_tpu_torch.parallel import cluster
if sys.argv[1] == "auto":  # torchrun's variables, set by the parent
    rank, n = cluster.initialize_cluster("auto")
else:
    rank, n = cluster.initialize_cluster(sys.argv[1], 2, int(sys.argv[2]))
hist = np.full((3, 2), 2**60 + rank, dtype=np.int64)
summed = cluster.allreduce_hist(hist)
assert (hist == 2**60 + rank).all()  # the caller's array is left alone
print(json.dumps({
    "rank": rank, "size": n, "report_host": cluster.is_report_host(),
    "hist": summed.tolist(), "dtype": str(summed.dtype),
    "objects": cluster.allgather_object({"rank": rank, "rows": [rank] * rank}),
    "bytes": [b.hex() for b in cluster.allgather_bytes(bytes([rank]) * 3)],
}))
cluster.shutdown_cluster()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two(prog, args_of, timeout=240, env_of=lambda rank: {}, rc=0):
    """Start ``prog`` as ranks 0 and 1 (``args_of(rank)``, extra
    environment ``env_of(rank)``), wait for both within ``timeout``
    seconds; returns their output, or fails with it unless both exit with
    ``rc``."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, "-c", prog, *args_of(rank)],
                         cwd=REPO, env=dict(env, **env_of(rank)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for rank in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == rc, (
            f"rank {rank} exited with {p.returncode}:\n{text[-3000:]}")
    return outputs


@pytest.mark.parametrize("rendezvous", ["host:port", "auto"])
def test_collectives_two_processes(rendezvous):
    """int64 sums exact past 2**53, gathers in rank order; the group
    joined at ``--coordinator host:port`` or, as under torchrun, from
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``."""
    port = _free_port()
    if rendezvous == "auto":
        outs = _run_two(COLLECTIVES, lambda r: ["auto"], env_of=lambda r: {
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "WORLD_SIZE": "2", "RANK": str(r)})
    else:
        outs = _run_two(COLLECTIVES,
                        lambda r: [f"localhost:{port}", str(r)])
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for rank, g in enumerate(got):
        assert (g["rank"], g["size"], g["report_host"]) == (rank, 2, rank == 0)
        assert g["hist"] == [[2**61 + 1] * 2] * 3 and g["dtype"] == "int64"
        assert g["objects"] == [{"rank": 0, "rows": []},
                                {"rank": 1, "rows": [1]}]
        assert g["bytes"] == ["000000", "010101"]


@pytest.fixture(scope="module")
def graphs(tmp_path_factory, input_dir):
    tmp = tmp_path_factory.mktemp("dist")
    out = {}
    for name, main in (("port", port_main), ("ref", ref_main)):
        out[name] = tmp / f"g_{name}"
        assert main([
            "buildvg", "-l", str(input_dir / "test.fa"),
            "-v", str(input_dir / "test.vcf.gz"), "-o", str(out[name]),
        ]) == 0
    return tmp, out


def _find_args(input_dir, graph_dir, bed, outdir, extra=()):
    return [
        "findmotif", "-d", str(graph_dir), "-b", str(bed),
        "-m", str(input_dir / "MA0139.1.meme"), "-t", "0.9", "--recomb",
        "-o", str(outdir), *extra,
    ]


@pytest.mark.parametrize("regions", [
    "chrx\t0\t20\nchrx\t15\t38\nchrx\t28\t50\n",  # test_distributed.py:55
    "chrx\t0\t45\n",  # one region: rank 1 scans nothing
])
def test_two_process_run_bit_identical(graphs, input_dir, regions,
                                       monkeypatch):
    tmp, g = graphs
    case = tmp / f"case{len(regions.splitlines())}"
    case.mkdir()
    bed = case / "regions.bed"
    bed.write_text(regions)
    # one process of each package, in this interpreter
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    assert port_main([*_find_args(input_dir, g["port"], bed, case / "one"),
                      "--device", "cpu"]) == 0
    assert ref_main(_find_args(input_dir, g["ref"], bed, case / "ref")) == 0
    port = _free_port()
    outputs = _run_two(CLI, lambda rank: _find_args(
        input_dir, g["port"], bed, case / f"rank{rank}",
        ["--device", "cpu", "--verbose", "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(rank)]))
    report = (case / "rank0" / "grafimo_out.tsv").read_bytes()
    assert report == (case / "one" / "grafimo_out.tsv").read_bytes()
    assert report == (case / "ref" / "grafimo_out.tsv").read_bytes()
    assert len(report.splitlines()) > 1
    assert not (case / "rank1").exists()
    assert "Scanned sequences:" in outputs[0]
    assert "Scanned sequences:" not in outputs[1]
    n_regions = len(regions.splitlines())
    for rank, text in enumerate(outputs):
        mine = len(range(rank, n_regions, 2))
        assert f"process {rank}/2: scanning {mine}/{n_regions} regions" in text
        assert f"cluster: rank {rank}/2, histogram all-reduce" in text


@pytest.mark.parametrize("rendezvous", ["host:port", "auto"])
def test_window_engine_refuses_several_processes(graphs, input_dir,
                                                 rendezvous):
    """``--engine windows`` over more than one process fails on every
    rank as soon as the group is joined, naming ROADMAP C6 (the reference
    writes a partial report there), before any device work or output."""
    tmp, g = graphs
    case = tmp / f"windows_{rendezvous.replace(':', '_')}"
    case.mkdir()
    bed = case / "regions.bed"
    bed.write_text("chrx\t0\t20\nchrx\t15\t38\n")
    port = _free_port()
    auto = rendezvous == "auto"
    flags = [["--coordinator", "auto"] if auto else
             ["--coordinator", f"localhost:{port}", "--num-processes", "2",
              "--process-id", str(r)] for r in range(2)]
    envs = [{"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
             "WORLD_SIZE": "2", "RANK": str(r)} if auto else {}
            for r in range(2)]
    outputs = _run_two(CLI, lambda rank: _find_args(
        input_dir, g["port"], bed, case / f"rank{rank}",
        ["--device", "cpu", "--engine", "windows", *flags[rank]]),
        env_of=envs.__getitem__, rc=1)
    for rank, text in enumerate(outputs):
        assert "ROADMAP C6" in text
        assert "Scanned sequences:" not in text
        assert not (case / f"rank{rank}").exists()
