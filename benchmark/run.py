#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up (``setup_s``, from the interpreter's start): the port imported
and its kernels bound; the cell's inputs drawn from the seed and built
into a graph by the port's ``buildvg``, in a child process
(``benchmark/inputs.py``); one warm-up call.  The window: whole
``findmotif`` calls through the port's CLI entry, in this process, one
at a time, until ``S`` seconds have passed (the call then in flight
finishes and counts).  Each call reads the graph, batches, scans on the
card and writes its reports into a directory of its own, as a user's
``findmotif -g GRAPH -b BED -m MEME -t T -o DIR --device cuda`` does.
Then the plain reference (``benchmark/reference.py``) judges every report
(``benchmark/compare.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (calls), ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer ones, read from
host spans and the ``torch.profiler`` trace), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which also end standard error.  Exits 2 without a
CUDA card, and 3 if JAX or the JAX package was loaded.
"""

import argparse
import contextlib
import gc
import importlib
import io
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "grafimo_tpu"}


def process_start() -> float:
    """The wall-clock time this interpreter started."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class PeakRss:
    """This process's peak resident memory from ``start`` to ``stop``,
    read by ``benchmark/rss.py`` in a process of its own every
    ``interval`` seconds."""

    def __init__(self, interval: float = 0.002):
        self.interval = interval
        self.proc = None

    def start(self) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "rss.py"), str(os.getpid()),
             repr(self.interval)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if self.proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the memory sampler did not start")

    def stop(self) -> int:
        self.proc.stdin.close()
        peak = int(self.proc.stdout.read().split()[-1])
        self.proc.wait()
        self.proc = None
        return peak

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class Spans:
    """The per-layer metrics' spans: each ``WRAPS`` function rebound where
    its caller looks it up, timed by the host clock and, when traced,
    opened as a ``torch.profiler.record_function`` under the metric's
    name."""

    def __init__(self, per_layer, traced: bool):
        self.host = {}
        self.traced = traced
        self._undo = []
        for metric, module in per_layer:
            if module.WRAPS:
                self.wrap(metric["name"], module.WRAPS)

    def wrap(self, name: str, target: str) -> None:
        import torch

        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        real = getattr(mod, attr)
        self.host[name] = 0.0

        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                if self.traced:
                    with torch.profiler.record_function(name):
                        return real(*args, **kwargs)
                return real(*args, **kwargs)
            finally:
                self.host[name] += time.perf_counter() - t0

        setattr(mod, attr, spanned)
        self._undo.append((mod, attr, real))

    def close(self) -> None:
        for mod, attr, real in reversed(self._undo):
            setattr(mod, attr, real)


def findmotif(inputs: dict, threshold: float, outdir: str, device: str):
    """One call of the port's CLI entry: its exit code and what it
    printed."""
    from grafimo_tpu_torch.cli import main

    argv = ["findmotif", "-g", inputs["graph"],
            "-b", os.path.join(inputs["dir"], "regions.bed"),
            "-m", os.path.join(inputs["dir"], "motifs.meme"),
            "-t", repr(threshold), "-o", outdir, "--device", device]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def make_inputs(config_path, traffic_path, seed, workdir):
    """Start the child that draws the inputs and builds the graph; its
    standard error goes to ``inputs.log`` in ``workdir``."""
    with open(os.path.join(workdir, "inputs.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.join(HERE, "inputs.py"), config_path,
             traffic_path, str(seed), workdir],
            stdout=subprocess.PIPE, stderr=log, text=True)


def judge(inputs: dict, config: dict, calls) -> tuple:
    """The reference's report of the inputs, the compared numbers of the
    calls' reports, and the work of one call."""
    from benchmark import compare, reference

    with open(os.path.join(inputs["dir"], "motifs.meme")) as f:
        meme = f.read()
    want = reference.report(os.path.join(inputs["dir"], "truth.npz"), meme,
                            config["chrom"], config["threshold"])
    want["work"]["rows"] = sum(len(r["start"]) for r in want["rows"].values())
    return compare.judge(calls, want["rows"],
                         want["work"]["windows_per_strand"]), want["work"]


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", started: float = None, fault=None) -> dict:
    """One run of ``cell`` (``spec.cell``'s dict); returns the result
    line.  ``fault``, for the harness's own tests, is called once the
    port is imported, to break it underneath."""
    import torch

    from benchmark import compare, trace as tr

    started = started or time.time()
    with open(cell["config_path"]) as f:
        config = json.load(f)
    workdir = tempfile.mkdtemp(prefix=f"grafimo_bench_{seed}_")
    child = None
    sampler = PeakRss()
    try:
        child = make_inputs(cell["config_path"], cell["traffic_path"], seed,
                            workdir)
        import grafimo_tpu_torch.cli  # noqa: F401
        from grafimo_tpu_torch import kernels, native

        native._lib()
        if device == "cuda":
            kernels.load()
            torch.zeros(1, device="cuda")
        split = {"port_bound_s": time.time() - started}
        out, _ = child.communicate()
        if child.returncode != 0:
            with open(os.path.join(workdir, "inputs.log")) as f:
                raise RuntimeError(f"inputs failed:\n{f.read()[-6000:]}")
        inputs = json.loads(out.strip().splitlines()[-1])
        inputs["dir"] = workdir
        split["inputs_ready_s"] = time.time() - started
        if fault is not None:
            fault()
        rc, text, err = findmotif(inputs, config["threshold"],
                                  os.path.join(workdir, "warmup"), device)
        if rc != 0:
            sys.stderr.write(f"warm-up call exited {rc}: {err[-2000:]}\n")
        setup_s = time.time() - started
        split["warm_up_s"] = setup_s - split["inputs_ready_s"]
        split.update({k: v for k, v in inputs.items()
                      if k.endswith("_s") or k in ("variants", "indels",
                                                   "planted")})
        sys.stderr.write(f"setup split: {json.dumps(split)}\n")

        spans = Spans(cell["per_layer"], trace)
        calls, failed = [], 0
        profiler = contextlib.nullcontext()
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        durations = []
        sampler.start()
        with profiler as prof:
            t0 = time.perf_counter()
            while True:
                outdir = os.path.join(workdir, f"call{len(calls) + failed}")
                with (torch.profiler.record_function(tr.CALL_SPAN)
                      if trace else contextlib.nullcontext()):
                    rc, text, err = findmotif(inputs, config["threshold"],
                                              outdir, device)
                durations.append(time.perf_counter() - t0)
                if rc == 0:
                    calls.append((outdir, text))
                else:
                    failed += 1
                    sys.stderr.write(f"call exited {rc}: {err[-2000:]}\n")
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        rss = sampler.stop()
        spans.close()
        sys.stderr.write(
            f"peak rss: window {rss / 2**30:.4f} GiB, process "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.4f}"
            f" GiB\n")
        mem_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                    else 0)
        events = None
        if trace:
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            events = tr.load_events(path)
            os.remove(path)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        t_judge = time.perf_counter()
        numbers, work = judge(inputs, config, calls)
        sys.stderr.write(
            f"window: calls ended at {json.dumps(durations)} s; "
            f"comparison {time.perf_counter() - t_judge:.1f} s; "
            f"reference rows {work['rows']}\n")
        limits = config["limits"]
        n = len(calls) + failed
        result = {
            "correct": failed == 0 and bool(calls)
            and compare.verdict(numbers, limits),
            "attempted": n, "failed": failed, "metrics": {},
            "device": {
                "platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": 1, "memory_peak_bytes": mem_peak},
        }
        if not trace:
            values = {"findmotif_s": window_s / n,
                      "peak_rss_gib": rss / 2**30, "setup_s": setup_s}
            for m in cell["end_to_end"]:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        else:
            record = tr.Record(len(calls), spans.host, events, work)
            for m, module in cell["per_layer"]:
                value = module.read(record)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
            summary = tr.device_summary(
                events, [m["name"] for m, _ in cell["per_layer"]])
            result["device"]["busy_s"] = summary.get("busy_s", 0.0)
            result["device"]["window_s"] = summary.get("window_s", window_s)
            if summary:
                result["breakdown"] = summary["breakdown"]
            for key, value in record.notes.items():
                sys.stderr.write(f"{key}: {value}\n")
        result["checks"] = {name: {"value": numbers[name],
                                   "limit": limits[name]}
                            for name in numbers}
        return result
    finally:
        sampler.kill()
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    cache = os.path.join(HERE, "_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    import torch

    from benchmark import spec

    cell = spec.cell(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"benchmark: needs {chips} CUDA card(s); torch "
                         f"sees {torch.cuda.device_count()}\n")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 started=started)
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"benchmark: loaded {found}\n")
        return 3
    for name, check in result["checks"].items():
        sys.stderr.write(f"{name}: {check['value']!r} "
                         f"(limit {check['limit']!r})\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
