"""The statistics layer's exact p-values on the CPU
(``grafimo_tpu_torch/pvalues.py``): the lane tail sums of
``csrc/tail_sums.cpp`` against a plain scalar loop kept here, the pinned
pure-Python fallback and both packages' builds of the scalar
``native/graphite.cpp:seq_tail_sums``; the dense-cache ``PvalueLookup``
against the pinned dict-cache one and the JAX package's.  Tolerance 0:
float64 bits throughout."""

import pathlib
import re

import numpy as np
import pytest

import grafimo_tpu.models.pvalue as ref_pvalue
import grafimo_tpu.native as ref_native
import grafimo_tpu_torch.native as port_native
from grafimo_tpu.utils.constants import UNIF
from grafimo_tpu_torch import pvalues, spans
from grafimo_tpu_torch.models import pvalue as pinned

from test_torch_runscan import PORT

REPO = pathlib.Path(__file__).resolve().parent.parent
MEME = REPO / "benchmark" / "data" / "jaspar_core_synth800.meme"
WIDTHS = (6, 11, 19, 28)


def jaspar_motifs(directory, widths=WIDTHS):
    """The first motif of each of ``widths`` in the 800-PWM MEME file,
    loaded by the port (Staden tables of ``1000 * width + 1`` bins)."""
    head, *blocks = re.split(r"(?m)^(?=MOTIF )", MEME.read_text())
    by_width = {}
    for block in blocks:
        by_width.setdefault(int(block.split("w=")[1].split()[0]), block)
    path = directory / "widths.meme"
    path.write_text(head + "".join(by_width[w] for w in widths))
    motifs = PORT.load_motifs(str(path), UNIF, 0.1, False)
    assert [m.width for m in motifs] == list(widths)
    return motifs


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(18)
    out = {f"w{m.width}": np.ascontiguousarray(m.pval_table)
           for m in jaspar_motifs(tmp_path_factory.mktemp("meme"))}
    out["random"] = rng.random(5000)
    zeros = rng.random(3000) * 1e-3
    for lo in rng.integers(0, 2900, 12):
        zeros[lo:lo + int(rng.integers(1, 90))] = 0.0
    zeros[[17, 1500, 2999]] = -0.0
    out["zeros"] = zeros
    return out


def _occupied(table, rng, draws=400):
    """The occupied bins of a histogram of ``draws`` scores drawn from
    the table itself (a Staden table is the background's score
    distribution)."""
    weights = np.abs(table)
    return np.unique(rng.choice(len(table), draws, p=weights / weights.sum()))


STARTS = ["occupied", "unsorted", "duplicates", "empty", "one", "negative",
          "past_end", "lanes-1", "lanes", "lanes+1", "2lanes+1"]


def _starts(kind, table, rng):
    n, g = len(table), pvalues.lanes()
    occupied = _occupied(table, rng)
    counts = {"lanes-1": g - 1, "lanes": g, "lanes+1": g + 1,
              "2lanes+1": 2 * g + 1}
    if kind == "occupied":
        return occupied
    if kind == "unsorted":
        return rng.permutation(occupied)
    if kind == "duplicates":
        return rng.choice(occupied, 3 * len(occupied))
    if kind == "empty":
        return np.zeros(0, np.int64)
    if kind == "one":
        return occupied[len(occupied) // 2 : len(occupied) // 2 + 1]
    if kind == "negative":
        return rng.permutation(np.concatenate([[-1, -7, -n - 3], occupied]))
    if kind == "past_end":
        return rng.permutation(np.concatenate([[n, n + 1, 10 * n, n - 1],
                                               occupied]))
    return rng.integers(0, n, counts[kind])


def _scalar_loop(table, starts):
    """``sum(table[s:])`` one start at a time, one float64 add at a
    time, left to right from +0.0."""
    values = table.tolist()
    out = []
    for s in starts.tolist():
        acc = 0.0
        for v in values[max(s, 0):]:
            acc += v
        out.append(acc)
    return np.array(out, dtype=np.float64)


def _fallback(table, starts, monkeypatch):
    """The pinned ``tail_sums``' pure-Python loop (the native import made
    to fail).  It indexes a negative start from the end, where the
    native loops clamp it to 0, so it is given the clamped starts."""
    def refuse(*args):
        raise RuntimeError("native refused")

    with monkeypatch.context() as m:
        m.setattr(port_native, "seq_tail_sums", refuse)
        return pinned.tail_sums(table, np.maximum(starts, 0))


def _bits(values):
    return np.asarray(values, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("starts_kind", STARTS)
@pytest.mark.parametrize("table_name",
                         [f"w{w}" for w in WIDTHS] + ["random", "zeros"])
def test_lane_tail_sums_bitwise(table_name, starts_kind, tables,
                                monkeypatch):
    table = tables[table_name]
    rng = np.random.default_rng([STARTS.index(starts_kind), len(table)])
    starts = np.asarray(_starts(starts_kind, table, rng), dtype=np.int64)
    got = pvalues.tail_sums(table, starts)
    assert got.dtype == np.float64 and got.shape == starts.shape
    want = _scalar_loop(table, starts)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(_fallback(table, starts, monkeypatch)))
    for native in (port_native, ref_native):
        np.testing.assert_array_equal(
            _bits(got), _bits(native.seq_tail_sums(table, starts)))
    if starts_kind == "past_end":
        assert (got[starts >= len(table)] == 0).all()
    if table_name == "zeros" and len(starts):
        # -0.0 is summed as the scalar loop sums it: never a -0.0 tail
        assert not np.signbit(got).any()


@pytest.mark.parametrize("m", ["one", "lanes", "lanes+1", "3lanes+5",
                               "no_native"])
def test_tail_sum_counters(m, tables, monkeypatch):
    """A call's ``pvalue.*`` counters follow the grouping: ``lanes()``
    starts a group in ascending order, a last group of one start summed
    by the scalar loop; with the native engine disabled every start goes
    to the pinned pure-Python loop."""
    g = pvalues.lanes()
    size = {"one": 1, "lanes": g, "lanes+1": g + 1, "3lanes+5": 3 * g + 5,
            "no_native": g + 3}[m]
    groups, serial = {"one": (0, 1), "lanes": (1, 0), "lanes+1": (1, 1),
                      "3lanes+5": (4, 0), "no_native": (0, g + 3)}[m]
    starts = np.random.default_rng(size).integers(0, 11001, size)
    table = tables["w11"]
    if m == "no_native":
        monkeypatch.setattr(pvalues, "_LIB", None)
        monkeypatch.setenv("GRAFIMO_TPU_NO_NATIVE", "1")
        want = _fallback(table, starts, monkeypatch)
        monkeypatch.setattr(port_native, "seq_tail_sums", None)
    with spans.call("tail_sums_s"):
        got = pvalues.tail_sums(table, starts)
    if m == "no_native":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    counts = spans.last_call()["counts"]
    assert counts["pvalue.tail_starts"] == size
    assert counts["pvalue.lane_groups"] == groups
    assert counts["pvalue.serial_starts"] == serial
    assert counts["pvalue.cache_hits"] == 0


@pytest.mark.parametrize("table_name", ["w11", "w28", "random"])
def test_dense_cache_lookup_matches_dict_cache(table_name, tables):
    """``pvalues``, ``pvalue`` and ``score_cutoff`` of the dense-cache
    lookup equal the pinned dict-cache lookup's and the JAX package's,
    bit for bit, over repeated and overlapping calls, scores out of the
    table's range included; a repeated call is served from the cache."""
    table = tables[table_name]
    n = len(table)
    rng = np.random.default_rng(n)
    first = _occupied(table, rng, 3000)
    overlap = rng.permutation(np.concatenate(
        [first[::2], _occupied(table, rng), first[:50], [-2, n, n + 5]]))
    new = pvalues.PvalueLookup(table)
    olds = (pinned.PvalueLookup(table), ref_pvalue.PvalueLookup(table))
    for scores in (first, overlap, first, first[::-3], overlap[:1]):
        with spans.call("lookup_s"):
            got = new.pvalues(scores)
        counts = spans.last_call()["counts"]
        uniq = np.unique(np.clip(scores, 0, n))
        assert counts["pvalue.cache_hits"] + counts["pvalue.tail_starts"] \
            == len(uniq)
        for old in olds:
            np.testing.assert_array_equal(_bits(got),
                                          _bits(old.pvalues(scores)))
    # the second call of ``first`` found every score cached
    with spans.call("lookup_s"):
        new.pvalues(first)
    assert spans.last_call()["counts"]["pvalue.cache_hits"] == len(first)
    assert spans.last_call()["counts"]["pvalue.tail_starts"] == 0
    for score in (0, -4, 1, n // 2, n - 1, n, n + 9):
        assert _bits(new.pvalue(score)) == _bits(olds[0].pvalue(score))
    for threshold in (1e-4, 1e-6):
        fresh = pvalues.PvalueLookup(table)
        want = olds[0].score_cutoff(threshold)
        assert fresh.score_cutoff(threshold) == want
        assert new.score_cutoff(threshold) == want
        assert want == olds[1].score_cutoff(threshold)
