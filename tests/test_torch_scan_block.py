"""The run engine's slice-block entry (``grafimo_tpu_torch/ops/
score_runs.scan_block``: one launch of ``csrc/scan_runs.cu``'s fused
kernel on a card, the composition of the three plain versions here)
against the reference's jitted ``*_topk`` kernels on the JAX CPU backend:
the histogram bit for bit and the same hits (count, hit bits, indices;
tolerance 0, integers) for each of the five batch kinds, with and without
the masks and the histogram remap.  Also the pure route plan at the
shapes the run engine and the smoke give it, the entry's checks,
``scan_batches`` going through it, and, on a card only, the fused launch
against its plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grafimo_tpu.ops.score_runs as ref
import grafimo_tpu.runscan as ref_rs
import grafimo_tpu_torch.ops.score_runs as port
import grafimo_tpu_torch.runscan as port_rs
from test_torch_runscan import REF, _mix_batches, _mix_graph, _scan_inputs
from test_torch_runscan import _motif as _pwm_motif
from test_torch_scan_runs import KINDS, LENGTH, _motif, _patches, _splice
from test_torch_score_runs import TOPK, _genome, _t

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _kind(kind, rng, k, r, b, masks, device=CPU):
    """A seeded slice block of ``kind``: the reference's ``*_topk`` call
    (a function of ``acc, rc, hs, jb``) and the port's rows on
    ``device``."""
    _, _, g4, gn = _genome(rng, LENGTH, 0.01)
    if not masks:
        gn = None
    pg4, pgn = port.genome_planes_to_device(g4, gn, device)

    def put(x):
        return None if x is None else _t(x).to(device)

    if kind == "packed":
        packed = ref.pack_run_seqs(rng.integers(0, 4, (b, r)))
        nbits = ref.pack_bits(rng.random((b, r)) < 0.02) if masks else None
        return (lambda acc, vb, rc, hs, jb: ref.scan_runs_device_topk(
                    acc, packed, nbits, vb, *rc, k, hs, TOPK, hist_bases=jb),
                port.packed_rows(put(packed), put(nbits)))
    if kind == "strided":
        stride = r - k + 1
        lo = int(rng.integers(0, LENGTH - b * stride - r))
        return (lambda acc, vb, rc, hs, jb:
                ref.scan_runs_resident_strided_topk(
                    acc, g4, gn, jnp.int32(lo), vb, *rc, b, stride, r, k, hs,
                    TOPK, hist_bases=jb),
                port.strided_rows(pg4, pgn, lo, b, stride, r))
    gstart = rng.integers(16, LENGTH - r - 16, b).astype(np.int32)
    if kind == "gathered":
        return (lambda acc, vb, rc, hs, jb: ref.scan_runs_resident_topk(
                    acc, g4, gn, gstart, vb, *rc, r, k, hs, TOPK,
                    hist_bases=jb),
                port.resident_rows(pg4, pgn, put(gstart), r))
    patches = _patches(rng, b, r, 4 if r <= 64 else 16)
    if kind == "patched":
        return (lambda acc, vb, rc, hs, jb:
                ref.scan_runs_resident_patched_topk(
                    acc, g4, gn, gstart, patches, vb, *rc, r, k, hs, TOPK,
                    hist_bases=jb),
                port.patched_rows(pg4, pgn, put(gstart), put(patches), r))
    splice = _splice(rng, b, r)
    return (lambda acc, vb, rc, hs, jb: ref.scan_runs_resident_spliced_topk(
                acc, g4, gn, gstart, splice, patches, vb, *rc, r, k, hs, TOPK,
                hist_bases=jb),
            port.spliced_rows(pg4, pgn, put(gstart), put(splice),
                              put(patches), r))


def _buffers(device, cap_a, cap_b):
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.full((cap_a,), -1, dtype=torch.int32, device=device),
            torch.full((cap_b,), -1, dtype=torch.int32, device=device))


@pytest.mark.parametrize("masks", [True, False], ids=["masks", "clean"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_matches_reference(kind, masks):
    """The entry's plain version against the reference's kernel: the
    histogram bit for bit; the count, the hit bits and the indices (in
    both tiers, the second past the first's capacity) equal."""
    rng = np.random.default_rng([KINDS.index(kind), masks, 7])
    k, r, b, m = 19, 128, 8, 2
    call_ref, rows = _kind(kind, rng, k, r, b, masks)
    pwm, mins, cuts, bases, hs = _motif(rng, k, m, masks)
    noff = r - k + 1
    vb = None
    if masks:
        v = rng.random((b, noff)) < 0.9
        v[0], v[-1] = True, False  # an all-valid and an all-invalid row
        vb = ref.pack_bits(v)
    want = call_ref(jnp.zeros((hs, m), jnp.int32), vb, (pwm, mins, cuts), hs,
                    None if bases is None else jnp.asarray(bases))
    port.reset_counts()
    count, idx, more = _buffers(CPU, 4, 4096)
    hist, bits = port.scan_block(
        rows, _t(vb), port.pwm_lut_from_kernel(pwm, CPU), _t(mins), k,
        _t(cuts), hs, _t(bases), count, idx, more)
    assert port.COUNTS == {"kernel": 0, "fused": 0, "plain": 1}
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want[1]))
    flat = np.flatnonzero(ref.unpack_hitbits(np.asarray(want[1]), noff))
    assert int(count) == len(flat) > len(idx)  # both index tiers used
    np.testing.assert_array_equal(
        torch.cat([idx, more])[: len(flat)].numpy(), flat)


def test_scan_batches_goes_through_the_entry(monkeypatch):
    """``scan_batches`` over the five kinds calls ``scan_block`` once a
    block and equals the reference's scan."""
    monkeypatch.setenv("GRAFIMO_TPU_SINGLE_DEVICE", "1")
    calls = []

    def counted(rows, *args):
        calls.append(rows.source)
        return port.scan_block(rows, *args)

    monkeypatch.setattr(port_rs, "scan_block", counted)
    k = 11
    args = _scan_inputs([_pwm_motif(5, k)], 0.05)
    got = port_rs.scan_batches(
        _mix_batches(port_rs, _mix_graph(), np.random.default_rng(9), k),
        *args, CPU)
    want = ref_rs.scan_batches(
        _mix_batches(ref_rs, _mix_graph(REF), np.random.default_rng(9), k),
        *args)
    assert calls == [0, 2, 1, 1, 1]  # packed, strided, three gathered
    np.testing.assert_array_equal(got.hists, want.hists)
    assert sorted(got.hits) == sorted(want.hits) and got.hits


# (label, m, k, r, comp_size, route, groups)
PLANS = [
    # the main path: CTCF forward + reverse complement, compressed bins
    ("CTCF M=2", 2, 19, 2048, 7425, "fused", 1),
    # the grid functions' uncompressed bins, one column a shard
    ("uncompressed M=1", 1, 19, 2048, 19001, "fused", 1),
    ("M=16 column groups", 16, 19, 2048, 12000, "fused", 4),
    ("M=40 column groups", 40, 19, 2048, 12000, "fused", 10),
    ("short rows R=64 k=8", 16, 8, 64, 5000, "fused", 2),
    # a random k = 70 motif's compressed bins, two columns a block
    ("k=70 M=2, 27,852 bins", 2, 70, 2048, 27852, "fused", 2),
    # a column past one block: hist.cu's cluster, the three launches
    ("k=70, a column past one block", 2, 70, 2048, 60000, "three", 0),
]


@pytest.mark.parametrize("label,m,k,r,comp,route,groups", PLANS,
                         ids=[p[0] for p in PLANS])
def test_fused_plan_routes(label, m, k, r, comp, route, groups):
    """The plan is a function of the shape (and the card's shared memory
    a block, an H100's by default) alone."""
    plan = port.fused_plan(m, k, r, comp)
    assert plan == {"route": route, "groups": groups}
    assert port.fused_plan(m, k, r, comp, port.H100_SMEM_BLOCK) == plan


def test_fused_plan_boundary():
    """One bin past the most a block holds beside its pair tables (12
    pairs of 16 ints, a cutoff, a minimum and a base: 195 ints a column
    at k = 19) and its rows, a column takes the three launches, and two
    columns leave one group."""
    k, r, per_col = 19, 2048, 195
    fit = max(c for c in range(50000, 60000)
              if port.fused_plan(1, k, r, c)["route"] == "fused")
    assert port.fused_plan(1, k, r, fit + 1)["route"] == "three"
    pair = (fit + per_col) // 2 - per_col
    assert port.fused_plan(2, k, r, pair)["groups"] == 1
    assert port.fused_plan(2, k, r, pair + 1)["groups"] == 2


def _entry_args():
    rng = np.random.default_rng(13)
    _, rows = _kind("gathered", rng, 5, 64, 3, True)
    pwm, mins, cuts, bases, hs = _motif(rng, 5, 2, True)
    return [rows, None, port.pwm_lut_from_kernel(pwm, CPU), _t(mins), 5,
            _t(cuts), hs, _t(bases), *_buffers(CPU, 4, 4)]


@pytest.mark.parametrize("fault", ["dtype", "shape", "count", "device",
                                   "comp_size", "rows"])
def test_entry_checks_its_tensors(fault):
    args = _entry_args()
    match = {"dtype": "cutoffs must be int32",
             "shape": r"bases has shape \(1,\)",
             "count": r"count has shape \(2,\)",
             "device": "unsupported device",
             "comp_size": "comp_size must be >= 1",
             "rows": "gstart must be torch.int32"}[fault]
    if fault == "dtype":
        args[5] = args[5].to(torch.int64)
    elif fault == "shape":
        args[7] = args[7][:1]
    elif fault == "count":
        args[8] = torch.zeros(2, dtype=torch.int32)
    elif fault == "device":
        rows = args[0]
        rows.tensors = {n: None if t is None else t.to("meta")
                        for n, t in rows.tensors.items()}
        args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
    elif fault == "comp_size":
        args[6] = 0
    else:
        args[0].tensors["gstart"] = args[0].tensors["gstart"].long()
    with pytest.raises((TypeError, ValueError), match=match):
        port.scan_block(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_fused_launch_matches_plain_on_card(kind):
    """On a card: one fused launch against the plain version on the same
    CUDA tensors -- histogram, count and bits exact, indices equal once
    sorted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    k, r, b = 19, 256, 64
    _, rows = _kind(kind, rng, k, r, b, True, dev)
    pwm, mins, cuts, bases, hs = _motif(rng, k, 2, True)
    vb = _t(ref.pack_bits(rng.random((b, r - k + 1)) < 0.9)).to(dev)
    common = (vb, port.pwm_lut_from_kernel(pwm, dev), _t(mins).to(dev), k,
              _t(cuts).to(dev), hs, _t(bases).to(dev))
    port.reset_counts()
    got_bufs, want_bufs = _buffers(dev, 64, 4096), _buffers(dev, 64, 4096)
    hist, bits = port.scan_block(rows, *common, *got_bufs)
    assert port.COUNTS == {"kernel": 0, "fused": 1, "plain": 0}
    want_hist, want_bits = port.scan_block_reference(rows, *common,
                                                     *want_bufs)
    torch.cuda.synchronize()
    assert torch.equal(hist, want_hist) and torch.equal(bits, want_bits)
    n = int(got_bufs[0])
    assert n == int(want_bufs[0]) > 0
    assert torch.equal(torch.sort(torch.cat(got_bufs[1:])[:n]).values,
                       torch.cat(want_bufs[1:])[:n])
