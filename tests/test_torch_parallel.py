"""The port's multi-device scans on the CPU against the JAX package's,
bit for bit: the ``parallel/pipeline.py`` grid functions against their
``shard_map`` counterparts on conftest's 8 virtual CPU devices, and
``runscan.scan_batches`` over ``[cpu] * n`` against the reference's
8-device mesh dispatch and its single-device path (the cases of
``tests/test_parallel.py:23, 41, 61, 81, 125, 237, 334``).

The port's device lists repeat one CPU device: a list splits every slice
into blocks all the same, which is how the split is held without a
second device.  Tolerance 0 throughout: histograms and hit sets are
integers.  The reference returns hit bits, compared after
``unpack_hitbits``; the port returns ``(row, offset, column)`` rows."""

import functools

import numpy as np
import pytest
import torch

import grafimo_tpu.ops.score_jax as ref_jax
import grafimo_tpu.ops.score_runs as ref_sr
import grafimo_tpu.parallel.pipeline as ref_pp
import grafimo_tpu.runscan as ref_rs
import grafimo_tpu_torch.ops.score_runs as port_sr
import grafimo_tpu_torch.ops.score_windows as port_sw
import grafimo_tpu_torch.parallel.pipeline as port_pp
import grafimo_tpu_torch.runscan as port_rs
from grafimo_tpu_torch.device import split_rows
from grafimo_tpu_torch.models.parse import load_motifs
from grafimo_tpu_torch.models.pvalue import PvalueLookup
from grafimo_tpu_torch.ops.compact import hit_mask
from grafimo_tpu_torch.ops.encode import revcomp_codes
from grafimo_tpu_torch.utils.constants import UNIF
from tests.conftest import DATA

torch.set_num_threads(1)

CPU = torch.device("cpu")
# port grids over [cpu] * n: n -> (n_data, n_motif)
GRIDS = {1: (1, 1), 3: (3, 1), 8: (4, 2)}
NS = sorted(GRIDS)


@functools.lru_cache(maxsize=None)
def _ctcf():
    return load_motifs(str(DATA / "input" / "MA0139.1.meme"), UNIF, 0.1,
                       False)[0]


def _mats():
    ctcf = _ctcf()
    return [ctcf.score_matrix,
            port_sr.reverse_complement_pwm(ctcf.score_matrix)]


def _grid(n):
    return port_pp.make_mesh(*GRIDS[n], devices=[CPU] * n)


def _hit_rows(hitbits, noff):
    return np.stack(
        np.nonzero(ref_sr.unpack_hitbits(np.asarray(hitbits), noff)), axis=1)


def test_make_mesh_and_split_rows():
    grid = port_pp.make_mesh(4, 2, devices=[CPU] * 8)
    assert len(grid) == 4 and all(len(row) == 2 for row in grid)
    assert port_pp.make_mesh(devices=[CPU] * 3) == ((CPU,),) * 3
    with pytest.raises(ValueError, match="needs 8 devices"):
        port_pp.make_mesh(4, 2, devices=[CPU] * 7)
    assert split_rows(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert split_rows(2, 3) == [(0, 1), (1, 2), (2, 2)]


# ---------------------------------------------------------- window step


@functools.lru_cache(maxsize=None)
def _step_inputs():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (1024, 19)).astype(np.uint8)
    pwm = port_sw.pwms_to_flat(_mats())
    mins = np.array([_ctcf().min_score] * 2, dtype=np.int32)
    cutoffs = np.array([1000, 1000], dtype=np.int32)
    hs = port_sw.hist_size_for_width(19)
    mesh = ref_pp.make_mesh(n_data=4, n_motif=2)
    want = ref_pp.sharded_scan_step(mesh, hs)(codes, pwm, mins, cutoffs)
    return codes, pwm, mins, cutoffs, hs, [np.asarray(x) for x in want]


@pytest.mark.parametrize("n", NS)
def test_sharded_scan_step_matches_reference(n):
    codes, pwm, mins, cutoffs, hs, (w_scores, w_hist, w_hits) = (
        _step_inputs())
    scores, hist, hits = port_pp.sharded_scan_step(_grid(n), hs)(
        codes, pwm, mins, cutoffs)
    np.testing.assert_array_equal(scores.numpy(), w_scores)
    np.testing.assert_array_equal(hist.numpy(), w_hist)
    np.testing.assert_array_equal(hits.numpy(), w_hits)
    # the port's single-device core gives the same
    one_s, one_h = port_sw.score_hist_core(
        codes, port_sw.pwm_lut_from_flat(pwm, CPU), mins, hs)
    np.testing.assert_array_equal(scores.numpy(), one_s.numpy())
    np.testing.assert_array_equal(hist.numpy(), one_h.numpy())
    np.testing.assert_array_equal(
        hits.numpy(), (one_s.numpy() >= 1000).sum(axis=0))


@functools.lru_cache(maxsize=None)
def _padded_inputs():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (1001, 19)).astype(np.uint8)  # not % 8
    pwm = port_sw.pwms_to_flat([_ctcf().score_matrix])
    mins = np.array([_ctcf().min_score], dtype=np.int32)
    hs = port_sw.hist_size_for_width(19)
    padded, n_valid = port_pp.pad_batch(codes, 8)
    run = ref_pp.sharded_scan_step(ref_pp.make_mesh(n_data=8, n_motif=1), hs)
    want = run(padded, pwm, mins, np.array([0], np.int32))
    return codes, padded, n_valid, pwm, mins, hs, [np.asarray(x) for x in want]


@pytest.mark.parametrize("n", NS)
def test_padding_excluded_from_histogram(n):
    codes, padded, n_valid, pwm, mins, hs, (w_scores, w_hist, w_hits) = (
        _padded_inputs())
    assert padded.shape[0] == 1008 and n_valid == 1001
    scores, hist, hits = port_pp.sharded_scan_step(
        port_pp.make_mesh(n, 1, devices=[CPU] * n), hs)(
        padded, pwm, mins, np.array([0], np.int32))
    assert int(hist.sum()) == 1001
    assert int(hits[0]) == 1001  # pads score -1, excluded
    np.testing.assert_array_equal(scores.numpy(), w_scores)
    np.testing.assert_array_equal(hist.numpy(), w_hist)
    np.testing.assert_array_equal(hits.numpy(), w_hits)
    # unpadded scores match the plain path
    ref_scores, _ = ref_jax.score_and_histogram(codes, pwm, mins, hs)
    np.testing.assert_array_equal(scores.numpy()[:1001, 0],
                                  np.asarray(ref_scores)[:, 0])


def test_rc_pwm_equals_scoring_revcomp():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (256, 19)).astype(np.uint8)
    ctcf = _ctcf()
    pwm_f = port_sw.pwms_to_flat([ctcf.score_matrix])
    pwm_rc = port_sw.pwms_to_flat(
        [port_sr.reverse_complement_pwm(ctcf.score_matrix)])
    mins = np.array([ctcf.min_score], dtype=np.int32)
    s_rc_pwm = port_sw.score_batch(
        codes, port_sw.pwm_lut_from_flat(pwm_rc, CPU), mins).numpy()
    s_direct = port_sw.score_batch(
        revcomp_codes(codes), port_sw.pwm_lut_from_flat(pwm_f, CPU),
        mins).numpy()
    np.testing.assert_array_equal(s_rc_pwm, s_direct)
    np.testing.assert_array_equal(
        s_rc_pwm, np.asarray(ref_jax.score_batch(codes, pwm_rc, mins)))


# ------------------------------------------------------- run-scan steps


def _runs_common(rng, b, noff):
    valid = rng.random((b, noff)) < 0.8
    kernel = port_sr.pwms_to_conv_kernel(_mats())
    mins = np.array([_ctcf().min_score] * 2, np.int32)
    return port_sr.pack_bits(valid), kernel, mins, mins + 4000


@functools.lru_cache(maxsize=None)
def _resident_inputs(with_n):
    rng = np.random.default_rng(3)
    k, r, b, length = 19, 64, 61, 4096  # b a multiple of no grid's rows
    genome = rng.integers(0, 4, length).astype(np.uint8)
    genome4 = port_sr.bytes_to_words(port_sr.pack_run_seqs(genome[None, :])[0])
    ngenome = port_sr.bytes_to_words(
        port_sr.pack_bits((rng.random(length) < 0.01)[None, :])[0])
    gstart = rng.integers(0, length - r, b).astype(np.int32)
    vbits, kernel, mins, cuts = _runs_common(rng, b, r - k + 1)
    hs = port_sr.hist_size_for_width(k)
    planes = (genome4, ngenome) if with_n else (genome4,)
    args = (*planes, gstart, vbits, kernel, mins, cuts)
    mesh = ref_pp.make_mesh(n_data=4, n_motif=2)
    # the reference needs B % 4 == 0: pad rows start at 0, all invalid
    padded = (np.concatenate([gstart, np.zeros(3, np.int32)]),
              np.concatenate([vbits, np.zeros((3, vbits.shape[1]), np.uint8)]))
    want = ref_pp.sharded_resident_scan(mesh, r, k, hs, with_n=with_n)(
        *planes, *padded, kernel, mins, cuts)
    return args, r, k, hs, [np.asarray(x) for x in want]


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("n", NS)
def test_sharded_resident_matches_reference(n, with_n):
    args, r, k, hs, (w_hist, w_hitbits, w_counts) = _resident_inputs(with_n)
    hist, hits, counts = port_pp.sharded_resident_scan(
        _grid(n), r, k, hs, with_n=with_n)(*args)
    np.testing.assert_array_equal(hist.numpy(), w_hist)
    np.testing.assert_array_equal(hits.numpy(),
                                  _hit_rows(w_hitbits, r - k + 1))
    np.testing.assert_array_equal(counts.numpy(), w_counts)
    assert len(hits) > 0
    # the port's single-device kind gives the same
    g4, gn = port_sr.genome_planes_to_device(
        args[0], args[1] if with_n else None, CPU)
    gstart, vbits, kernel, mins, cuts = args[-5:]
    one_h, one_scores = port_sr.scan_runs_resident(
        g4, gn, torch.from_numpy(gstart), torch.from_numpy(vbits),
        port_sr.pwm_lut_from_kernel(kernel, CPU), torch.from_numpy(mins),
        r, k, hs)
    np.testing.assert_array_equal(hist.numpy(), one_h.numpy())
    one_hit = hit_mask(one_scores, torch.from_numpy(cuts))
    np.testing.assert_array_equal(hits.numpy(), torch.nonzero(one_hit).numpy())


@functools.lru_cache(maxsize=None)
def _run_scan_inputs():
    rng = np.random.default_rng(4)
    k, r, b = 19, 64, 37
    codes = rng.integers(0, 4, (b, r)).astype(np.uint8)
    packed = port_sr.pack_run_seqs(codes)
    nbits = port_sr.pack_bits(rng.random((b, r)) < 0.02)
    vbits, kernel, mins, cuts = _runs_common(rng, b, r - k + 1)
    hs = port_sr.hist_size_for_width(k)
    args = (packed, nbits, vbits, kernel, mins, cuts)
    mesh = ref_pp.make_mesh(n_data=4, n_motif=2)
    padded = [np.concatenate([x, np.zeros((3, x.shape[1]), np.uint8)])
              for x in args[:3]]  # the reference needs B % 4 == 0
    want = ref_pp.sharded_run_scan(mesh, k, hs)(*padded, *args[3:])
    return args, k, r, hs, [np.asarray(x) for x in want]


@pytest.mark.parametrize("n", NS)
def test_sharded_run_scan_matches_reference(n):
    args, k, r, hs, (w_hist, w_hitbits, w_counts) = _run_scan_inputs()
    hist, hits, counts = port_pp.sharded_run_scan(_grid(n), k, hs)(*args)
    np.testing.assert_array_equal(hist.numpy(), w_hist)
    np.testing.assert_array_equal(hits.numpy(),
                                  _hit_rows(w_hitbits, r - k + 1))
    np.testing.assert_array_equal(counts.numpy(), w_counts)
    assert len(hits) > 0


# --------------------------------------------------- scan_batches split


def _scan_params(threshold):
    ctcf = _ctcf()
    k = ctcf.width
    kern = port_sr.pwms_to_conv_kernel(_mats())
    mins = np.array([ctcf.min_score] * 2, np.int32)
    cut = PvalueLookup(ctcf.pval_table).score_cutoff(threshold)
    return kern, mins, np.array([cut] * 2, np.int32), k, 1000 * k + 1


class _Shim:
    """A graph as the resident batches read it (``.seq``; the scans cache
    their genome planes on it)."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 4096))


def _packed_batch(mod):
    """``tests/test_parallel.py:125``'s batch: B = 37, R = 64."""
    k = _ctcf().width
    rng = np.random.default_rng(7)
    b, r = 37, 64
    codes = rng.integers(0, 4, (b, r)).astype(np.uint8)
    nmask = np.zeros((b, r), bool)
    nmask[3, 10] = True
    valid = rng.random((b, r - k + 1)) < 0.9
    return [mod.DeviceBatch(
        R=r, packed=mod.pack_run_seqs(codes), nbits=mod.pack_bits(nmask),
        vbits=mod.pack_bits(valid),
        chunks=[mod.RunChunk(("t", (-1, 0)), i) for i in range(b)],
    )]


def _kind_batches(mod, shim):
    """``tests/test_parallel.py:237``'s batches: backbone, patched,
    spliced and packed, B = 21."""
    k = _ctcf().width
    b, r = 21, 64
    noff = r - k + 1
    r2 = np.random.default_rng(5)
    out = []
    for kind in ("backbone", "patched", "spliced", "packed"):
        chunks = [mod.RunChunk(("t", (-1, 0)), i) for i in range(b)]
        common = dict(R=r, packed=None, nbits=None,
                      vbits=mod.pack_bits(r2.random((b, noff)) < 0.9),
                      chunks=chunks, graph=shim)
        gstart = r2.integers(8, 4096 - r - 64, b).astype(np.int32)
        if kind == "backbone":
            out.append(mod.DeviceBatch(gstart=gstart, **common))
        elif kind == "patched":
            pat = np.full((b, mod.PATCH_SLOTS), -1, np.int16)
            pat[:, 0] = (r2.integers(0, r, b) * 4
                         + r2.integers(0, 4, b)).astype(np.int16)
            out.append(mod.DeviceBatch(gstart=gstart, patches=pat, **common))
        elif kind == "spliced":
            splice = np.full((b, 4), 0x7FFF, np.int16)
            splice[:, 0] = r2.integers(k, r - k, b).astype(np.int16)
            splice[:, 1] = r2.integers(-6, 7, b).astype(np.int16)
            pat = np.full((b, mod.PATCH_SLOTS), -1, np.int16)
            pat[:, 0] = (splice[:, 0].astype(np.int64) * 4
                         + r2.integers(0, 4, b)).astype(np.int16)
            out.append(mod.DeviceBatch(gstart=gstart, splice=splice,
                                       patches=pat, **common))
        else:
            codes = r2.integers(0, 4, (b, r)).astype(np.uint8)
            nmask = np.zeros((b, r), bool)
            nmask[2, 5] = True
            out.append(mod.DeviceBatch(
                R=r, packed=mod.pack_run_seqs(codes),
                nbits=mod.pack_bits(nmask),
                vbits=mod.pack_bits(np.ones((b, noff), bool)), chunks=chunks,
            ))
    return out


STRIDED_ROWS = (16, 16, 21)


def _strided_batches(mod, shim):
    """``tests/test_parallel.py:334``'s uniformly strided backbone
    batches: B = 16 (masked and clean) and B = 21, which divides neither
    the reference's 8-device mesh nor the port's 3 or 8 blocks."""
    k = _ctcf().width
    r = 64
    stride = r - k + 1
    r2 = np.random.default_rng(9)
    out = []
    for b, masked in zip(STRIDED_ROWS, (True, False, False)):
        valid = (r2.random((b, stride)) < 0.9 if masked
                 else np.ones((b, stride), bool))
        out.append(mod.DeviceBatch(
            R=r, packed=None, nbits=None,
            gstart=(7 + stride * np.arange(b)).astype(np.int32),
            vbits=mod.pack_bits(valid),
            chunks=[mod.RunChunk(("t", (-1, 0)), i * stride)
                    for i in range(b)],
            graph=shim,
        ))
    return out


CASES = {
    "packed_b37": (_packed_batch, 1e-3),
    "all_kinds": (_kind_batches, 1e-2),
    "strided": (_strided_batches, 1e-2),
}


def _make(case, mod, seed):
    fn, _ = CASES[case]
    return fn(mod) if fn is _packed_batch else fn(mod, _Shim(seed))


@functools.lru_cache(maxsize=None)
def _reference_scans(case):
    """The reference's scan on its 8-device mesh and on one device."""
    import os

    params = _scan_params(CASES[case][1])
    mesh = ref_rs.scan_batches(_make(case, ref_rs, 11), *params)
    os.environ["GRAFIMO_TPU_SINGLE_DEVICE"] = "1"
    try:
        one = ref_rs.scan_batches(_make(case, ref_rs, 11), *params)
    finally:
        del os.environ["GRAFIMO_TPU_SINGLE_DEVICE"]
    return mesh, one


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("case", list(CASES))
def test_scan_batches_split_matches_reference(case, n, monkeypatch):
    """``scan_batches`` over ``[cpu] * n`` == the reference's mesh and
    single-device scans == the port's one-device scan.  Strided slices
    take the strided kind in every block, whether or not ``n`` divides
    their rows; no strided slice falls back to the gather."""
    calls = {"strided": 0, "gather": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(port_rs, "strided_rows", counted(
        "strided", port_rs.strided_rows))
    monkeypatch.setattr(port_rs, "resident_rows", counted(
        "gather", port_rs.resident_rows))
    params = _scan_params(CASES[case][1])
    got = port_rs.scan_batches(_make(case, port_rs, 11), *params, [CPU] * n)
    one = port_rs.scan_batches(_make(case, port_rs, 11), *params, CPU)
    mesh_ref, one_ref = _reference_scans(case)
    for want in (mesh_ref, one_ref, one):
        np.testing.assert_array_equal(got.hists, want.hists)
        np.testing.assert_array_equal(got.n_windows_per_col,
                                      want.n_windows_per_col)
        assert sorted(got.hits) == sorted(want.hits)
    assert len(got.hits) > 0
    if case == "strided":
        # every block of every slice, counted for both scans above
        assert calls == {
            "strided": sum(min(b, n) + 1 for b in STRIDED_ROWS),
            "gather": 0,
        }
