"""The port stands alone: no module of ``grafimo_tpu_torch`` (nor
``chip_smoke.py``) imports ``grafimo_tpu`` or ``jax``, every port module
imports with both blocked, and each host module the port copied from the
reference is pinned to its original.

A copy may differ from its original only by the package name in its
import lines (``from grafimo_tpu.x`` -> ``from grafimo_tpu_torch.x``)
and, in the two copies that open the port's phase spans
(``grafimo_tpu_torch/spans.py``), by those spans: there the syntax trees
are compared with each ``with span(...)`` block taken as its body and
the import of ``span`` dropped.

Where the port owns a faster implementation of a copied function, the
port owns that module: the function is rewritten in place under its own
name, its tests hold it to the reference's by behaviour, and every other
top-level function, class and constant of the module stays pinned to the
reference's one by one (``PARTIAL``), spans stripped as above.
Two places that look as if they needed more need nothing: the native
loader's ``RunPayload`` import (``build_region_runs_native``) becomes the
port's ``grafimo_tpu_torch.runscan`` by that rename, and its build
directory is ``_build/`` beside the copy's own sources, so the port's
library builds into ``grafimo_tpu_torch/native/_build/``.  A fix to a
copied module or function lands in both copies, or the pin fails.
"""

import ast
import importlib
import importlib.util
import inspect
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest

import grafimo_tpu.cli as ref_cli
import grafimo_tpu.native as ref_native
import grafimo_tpu.parallel.cluster as ref_cluster
import grafimo_tpu.parallel.pipeline as ref_pipeline
import grafimo_tpu_torch.cli as port_cli
import grafimo_tpu_torch.native as port_native
import grafimo_tpu_torch.parallel.cluster as port_cluster
import grafimo_tpu_torch.parallel.pipeline as port_pipeline

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = REPO / "grafimo_tpu_torch"

# the reference's jax-free host modules, copied at the same relative path
COPIES = [
    "errors.py", "config.py",
    "utils/__init__.py", "utils/constants.py", "utils/misc.py",
    "utils/sniff.py", "utils/fetch.py",
    "io/__init__.py", "io/bed.py", "io/fasta.py", "io/vcf.py",
    "models/__init__.py", "models/background.py", "models/motif.py",
    "models/parse.py", "models/process.py", "models/pvalue.py",
    "report/__init__.py", "report/results.py", "report/writer.py",
    "graph/enumerate.py", "graph/haplo.py",
    "graph/sitegraph.py", "graph/xg.py", "graph/gfa.py",
    "graph/vgproto.py", "graph/gbwt.py",
    "native/graphite.cpp", "native/vcfio.cpp",
]

# copies that open spans
INSTRUMENTED = ("graph/sitegraph.py", "report/writer.py")

# port-owned modules that began as copies, with the functions the port
# rewrote: the per-graph arrays of the run decomposition and the C++
# engine's flat graph view, each built in whole-graph passes
PARTIAL = {
    "graph/runs.py": ("cluster_sites", "_ref_node_array",
                      "build_single_run"),
    "native/__init__.py": ("_flatten_graph",),
}

_IMPORT_LINE = re.compile(r"^(\s*(?:from|import)\s+)grafimo_tpu(?=[.\s])",
                          re.M)


def _renamed(text: str) -> str:
    """The reference's text with its package renamed in import lines."""
    return _IMPORT_LINE.sub(r"\1grafimo_tpu_torch", text)


class _Unspanned(ast.NodeTransformer):
    """A module's tree without the port's spans: a ``with span(...)``
    block becomes its body and ``from grafimo_tpu_torch.spans import``
    goes."""

    def visit_With(self, node):
        self.generic_visit(node)
        if all(isinstance(i.context_expr, ast.Call)
               and isinstance(i.context_expr.func, ast.Name)
               and i.context_expr.func.id == "span" for i in node.items):
            return node.body
        return node

    def visit_ImportFrom(self, node):
        return None if node.module == "grafimo_tpu_torch.spans" else node


def _unspanned(text: str) -> str:
    """``text``'s syntax tree without spans."""
    return ast.dump(_Unspanned().visit(ast.parse(text)))


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "grafimo_tpu")


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT_DIR.rglob("*.py"))
    + ["chip_smoke.py", "tools/bench_torch_chrom_scale.py",
       "tools/check_strided_tail.py"],
)
def test_no_reference_or_jax_import(path):
    """An AST walk finds no import of ``grafimo_tpu`` or ``jax``,
    module-level or inside a function; in ``chip_smoke.py`` and the
    chromosome-scale tool the programs they hand to their subprocesses
    are held to the same."""
    text = (REPO / path).read_text()
    tree = ast.parse(text, filename=path)
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            try:
                inner = ast.parse(node.value)
            except SyntaxError:
                continue
            bad += [n for n in _imported_names(inner) if _forbidden(n)]
    assert not bad, bad
    assert "spec_from_file_location" not in text  # no file loaded by path


def test_every_module_imports_with_reference_and_jax_blocked():
    prog = (
        "import sys\n"
        "sys.modules['grafimo_tpu'] = sys.modules['jax'] = None\n"
        "import importlib, pkgutil, grafimo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    grafimo_tpu_torch.__path__, 'grafimo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "leaked = [m for m in sys.modules\n"
        "          if m.split('.')[0] in ('grafimo_tpu', 'jax')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
        "print(' '.join(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", prog], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = proc.stdout.split()
    assert len(names) >= len(COPIES)
    assert {"grafimo_tpu_torch.parallel.pipeline",
            "grafimo_tpu_torch.parallel.cluster"} <= set(names)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_pinned_to_reference(rel):
    want = (REPO / "grafimo_tpu" / rel).read_text()
    got = (PORT_DIR / rel).read_text()
    if rel.endswith(".py"):
        want = _renamed(want)
    if rel in INSTRUMENTED:
        got, want = _unspanned(got), _unspanned(want)
    assert got == want, f"{rel} drifted from grafimo_tpu/{rel}"


def _definitions(text: str) -> dict:
    """``text``'s top-level functions, classes and constants (assignments
    to one name), each as the dump of its spanless syntax tree."""
    out = {}
    for node in _Unspanned().visit(ast.parse(text)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)):
            out[node.targets[0].id] = ast.dump(node)
    return out


def _reference_definitions(rel: str) -> dict:
    return _definitions(_renamed((REPO / "grafimo_tpu" / rel).read_text()))


@pytest.mark.parametrize("rel,name", [
    (rel, name) for rel, rewritten in PARTIAL.items()
    for name in sorted(set(_reference_definitions(rel)) - set(rewritten))
])
def test_kept_definition_pinned_to_reference(rel, name):
    """A function, class or constant of a port-owned module that the port
    did not rewrite is the reference's, import lines renamed and spans
    stripped."""
    got = _definitions((PORT_DIR / rel).read_text())
    assert name in got, f"{rel}: {name} is gone"
    assert got[name] == _reference_definitions(rel)[name], \
        f"{rel}: {name} drifted from grafimo_tpu/{rel}"


def test_rewritten_loaders_match_reference(tmp_path):
    """A saved graph loads through the port's ``SiteGraph.load``, whose
    member reads open spans, as through the reference's."""
    port, ref = _host("grafimo_tpu_torch"), _host("grafimo_tpu")
    path = str(tmp_path / "s.gvt.npz")
    _seeded_graph(port).save(path)
    got, want = port.SiteGraph.load(path), ref.SiteGraph.load(path)
    assert got.haplo is not None and want.haplo is not None
    for name in ("n_hap", "words", "site_allele_rows", "alt_bits"):
        _same(getattr(got.haplo, name), getattr(want.haplo, name), name)
    got.haplo = want.haplo = None
    _same(got, want, "graph")
    assert len(got.sites) > 10 and got.elements


@pytest.mark.parametrize("name", ["get_parser", "args_to_workflow"])
def test_cli_copy_pinned_to_reference(name):
    """The reference's parser and workflow mapping, moved into the port's
    CLI (the parser as ``_reference_parser``, under the port's flag)."""
    port_name = "_reference_parser" if name == "get_parser" else name
    want = ast.parse(inspect.getsource(getattr(ref_cli, name))).body[0]
    got = ast.parse(inspect.getsource(getattr(port_cli, port_name))).body[0]
    got.name = want.name
    assert ast.dump(got) == ast.dump(want)
    assert port_cli.__version__ == ref_cli.__version__


@pytest.mark.parametrize("mods,name", [
    ((ref_cluster, port_cluster), "shard_regions"),
    ((ref_pipeline, port_pipeline), "pad_batch"),
])
def test_parallel_copy_pinned_to_reference(mods, name):
    """The functions ``parallel/`` copies as they are: the round-robin
    region shard and the batch padding."""
    want, got = (ast.dump(ast.parse(inspect.getsource(getattr(m, name))))
                 for m in mods)
    assert got == want


def test_port_parser_adds_only_device():
    ref_actions = {a.dest for a in ref_cli.get_parser()._actions}
    port_actions = {a.dest for a in port_cli.get_parser()._actions}
    assert port_actions - ref_actions == {"device"}
    assert ref_actions <= port_actions


# ------------------------------------------------------------ native copy


def _host(pkg):
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        build_graph=mod("graph.sitegraph").build_graph,
        SiteGraph=mod("graph.sitegraph").SiteGraph,
        VcfRecord=mod("io.vcf").VcfRecord,
        native=mod("native"),
    )


def _seeded_graph(h, seed=11, length=2500, gap=(2, 9)):
    """SNPs, deletions and insertions every ``gap`` bases over a random
    sequence with a few N bases, four diploid samples, built by ``h``'s
    own loaders."""
    rng = np.random.default_rng(seed)
    seq = list(rng.choice(list("ACGT"), length))
    for p in rng.choice(np.arange(5, length - 5), 8, replace=False):
        seq[p] = "N"
    seq = "".join(seq)
    records, pos = [], 6
    while pos < length - 30:
        gt = [int(x) for x in rng.integers(0, 2, 8)]
        kind = rng.random()
        if "N" not in seq[pos - 1 : pos + 8]:
            if kind < 0.12:
                ln = int(rng.integers(1, 6))
                records.append(h.VcfRecord("s", pos, seq[pos - 1 : pos + ln],
                                           [seq[pos - 1]], gt))
                pos += ln
            elif kind < 0.24:
                ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 5))))
                records.append(h.VcfRecord("s", pos, seq[pos - 1],
                                           [seq[pos - 1] + ins], gt))
            else:
                alt = rng.choice([c for c in "ACGT" if c != seq[pos - 1]])
                records.append(h.VcfRecord("s", pos, seq[pos - 1], [alt], gt))
        pos += int(rng.integers(*gap))
    return h.build_graph("s", seq, records)


def _same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for key in want:
            _same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif hasattr(want, "__dataclass_fields__"):
        for name in want.__dataclass_fields__:
            _same(getattr(got, name), getattr(want, name), f"{where}.{name}")
    else:
        assert got == want, where


@pytest.mark.parametrize("call", ["batch_regions", "region_runs",
                                  "tail_sums"])
def test_native_copy_matches_reference(call):
    """The port's build of the C++ engine gives the reference's rows on a
    seeded graph, each side on its own package's graph object."""
    port, ref = _host("grafimo_tpu_torch"), _host("grafimo_tpu")
    assert str(port_native._lib()._name).startswith(
        str(PORT_DIR / "native" / "_build"))
    assert str(ref_native._lib()._name).startswith(
        str(REPO / "grafimo_tpu" / "native" / "_build"))
    if call == "tail_sums":
        rng = np.random.default_rng(2)
        arr = rng.random(500)
        starts = np.sort(rng.integers(0, 500, 40)).astype(np.int64)
        _same(port_native.seq_tail_sums(arr, starts),
              ref_native.seq_tail_sums(arr, starts))
        return
    k = 11
    if call == "region_runs":
        # sparse enough that no cluster passes the native combination cap
        g_port, g_ref = (_seeded_graph(h, gap=(24, 40)) for h in (port, ref))
        regions = [(0, 1200), (1100, g_port.length)]
        for lo, hi in regions:
            got = port_native.build_region_runs_native(g_port, lo, hi, k)
            want = ref_native.build_region_runs_native(g_ref, lo, hi, k)
            assert len(got) > 1
            assert type(got[0]).__module__ == "grafimo_tpu_torch.runscan"
            _same(got, want, "runs")
        return
    g_port, g_ref = _seeded_graph(port), _seeded_graph(ref)
    regions = [(0, 1200), (1100, g_port.length)]
    buckets = (64, 128, 256, 512)
    kwargs = dict(n_threads=1, bucket_slots=[16] * len(buckets), dense=True)
    got = port_native.batch_regions_native(g_port, regions, k, buckets,
                                           **kwargs)
    want = ref_native.batch_regions_native(g_ref, regions, k, buckets,
                                           **kwargs)
    assert got[0]
    _same(got, want, "batches")


# ------------------------------------------------------------ synth copy


def test_synth_copy_writes_the_tool_bytes(tmp_path):
    """``grafimo_tpu_torch/utils/synth.py`` writes the FASTA and BGZF VCF
    of ``tools/bench_chrom_scale.py``, byte for byte, from one seed."""
    from grafimo_tpu_torch.utils import synth

    spec = importlib.util.spec_from_file_location(
        "bench_chrom_scale", REPO / "tools" / "bench_chrom_scale.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = {}
    for name, mod in (("port", synth), ("tool", tool)):
        rng = np.random.default_rng(7)
        seq, pos, pockets = mod.synth_chrom(rng, 300_000, 64)
        variants, n_indel = mod.make_variants(rng, seq, pos, 64)
        d = tmp_path / name
        d.mkdir()
        mod.write_fasta(str(d / "ref.fa"), "21", seq)
        mod.write_vcf(str(d / "synth.vcf.gz"), "21", seq, variants, 64)
        out[name] = (pockets, n_indel, (d / "ref.fa").read_bytes(),
                     (d / "synth.vcf.gz").read_bytes())
    assert out["port"][1] > 0
    assert out["port"] == out["tool"]
    assert os.path.getsize(tmp_path / "port" / "synth.vcf.gz") > 10_000
