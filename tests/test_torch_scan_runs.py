"""The run engine's scoring core (``grafimo_tpu_torch/ops/score_runs.py``'s
five dispatching ``scan_runs_*`` functions, ``csrc/scan_runs.cu`` on a
card, the plain version here) against the reference's jitted ``*_topk``
kernels on the JAX CPU backend: histograms and hit bits bit for bit
(tolerance 0, integers), over kind x k x R x M x masks, the descriptor edge
rows (empty and full patch slots, negative splice shifts, an unused pair
before a used one), the N-clear asymmetry of the patched and spliced
kinds, the launch counts and the wrapper's checks.  The kernel against its
plain version runs on a card only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grafimo_tpu.ops.score_runs as ref
import grafimo_tpu_torch.ops.score_runs as port
from test_torch_score_runs import TOPK, _compare, _genome, _motif_inputs, _t

torch.set_num_threads(1)

CPU = torch.device("cpu")
KINDS = ["packed", "gathered", "strided", "patched", "spliced"]
LENGTH = 16384  # genome bases


def _motif(rng, k, m, remap):
    """A random PWM with cutoffs 0.55 of the way up each column's range
    and, with ``remap``, the run engine's compressed bins."""
    return _motif_inputs(rng, k, m, "comp" if remap else "none", cut=0.55)


def _patches(rng, b, r, n_slots):
    """Row 0 empty, row 1 full, the others a random number of slots."""
    patches = np.full((b, n_slots), -1, np.int16)
    for i in range(1, b):
        n = n_slots if i == 1 else int(rng.integers(0, n_slots + 1))
        pos = rng.choice(r, n, replace=False)
        patches[i, :n] = pos * 4 + rng.integers(0, 4, n)
    return patches


def _splice(rng, b, r):
    """Row 0 unspliced; the others one or two pairs with shifts of either
    sign, some rows with an unused pair before a used one."""
    splice = np.full((b, 4), 0x7FFF, np.int16)
    for i in range(1, b):
        n = int(rng.integers(1, 3))
        bounds = np.sort(rng.choice(np.arange(2, r - 2), n, replace=False))
        shifts = rng.integers(-12, 13, n)
        slots = [1] if n == 1 and i % 2 else list(range(n))
        for s, bound, shift in zip(slots, bounds, shifts):
            splice[i, 2 * s : 2 * s + 2] = (bound, shift)
    return splice


def _run_both(kind, rng, k, r, m, b, masks, remap, n_frac=0.01):
    """The reference's ``*_topk`` kernel and the port's dispatching
    function on one seeded batch of ``kind``."""
    _, _, g4, gn = _genome(rng, LENGTH, n_frac)
    if not masks:
        gn = None
    pwm, mins, cuts, bases, hs = _motif(rng, k, m, remap)
    noff = r - k + 1
    vb = None
    if masks:
        v = rng.random((b, noff)) < 0.9
        v[0] = True  # an all-valid row
        v[-1] = False  # an all-invalid row
        vb = ref.pack_bits(v)
    acc = jnp.zeros((hs, m), jnp.int32)
    jb = None if bases is None else jnp.asarray(bases)
    lut = port.pwm_lut_from_kernel(pwm, CPU)
    pg4, pgn = port.genome_planes_to_device(g4, gn, CPU)
    rc = (pwm, mins, cuts)
    pc = (lut, _t(mins))
    if kind == "packed":
        packed = ref.pack_run_seqs(rng.integers(0, 4, (b, r)))
        nbits = ref.pack_bits(rng.random((b, r)) < 0.02) if masks else None
        want = ref.scan_runs_device_topk(acc, packed, nbits, vb, *rc, k, hs,
                                         TOPK, hist_bases=jb)
        got = port.scan_runs_device(_t(packed), _t(nbits), _t(vb), *pc, k,
                                    hs, hist_bases=_t(bases))
    elif kind == "strided":
        stride = noff
        lo = int(rng.integers(0, LENGTH - b * stride - r))
        want = ref.scan_runs_resident_strided_topk(
            acc, g4, gn, jnp.int32(lo), vb, *rc, b, stride, r, k, hs, TOPK,
            hist_bases=jb)
        got = port.scan_runs_resident_strided(
            pg4, pgn, lo, _t(vb), *pc, b, stride, r, k, hs,
            hist_bases=_t(bases))
    else:
        gstart = rng.integers(16, LENGTH - r - 16, b).astype(np.int32)
        if kind == "gathered":
            want = ref.scan_runs_resident_topk(
                acc, g4, gn, gstart, vb, *rc, r, k, hs, TOPK, hist_bases=jb)
            got = port.scan_runs_resident(
                pg4, pgn, _t(gstart), _t(vb), *pc, r, k, hs,
                hist_bases=_t(bases))
        else:
            patches = _patches(rng, b, r, 4 if r <= 64 else 16)
            if kind == "patched":
                want = ref.scan_runs_resident_patched_topk(
                    acc, g4, gn, gstart, patches, vb, *rc, r, k, hs, TOPK,
                    hist_bases=jb)
                got = port.scan_runs_resident_patched(
                    pg4, pgn, _t(gstart), _t(patches), _t(vb), *pc, r, k, hs,
                    hist_bases=_t(bases))
            else:
                splice = _splice(rng, b, r)
                want = ref.scan_runs_resident_spliced_topk(
                    acc, g4, gn, gstart, splice, patches, vb, *rc, r, k, hs,
                    TOPK, hist_bases=jb)
                got = port.scan_runs_resident_spliced(
                    pg4, pgn, _t(gstart), _t(splice), _t(patches), _t(vb),
                    *pc, r, k, hs, hist_bases=_t(bases))
    return want, got, cuts, noff


ROWS = {64: 12, 256: 6, 2048: 2}  # rows a batch, by R


@pytest.mark.parametrize("masks", [True, False], ids=["masks", "clean"])
@pytest.mark.parametrize("m", [1, 2, 16])
@pytest.mark.parametrize("r", [64, 256, 2048])
@pytest.mark.parametrize("k", [5, 19, 30])
@pytest.mark.parametrize("kind", KINDS)
def test_kind_matches_reference(kind, k, r, m, masks):
    rng = np.random.default_rng([KINDS.index(kind), k, r, m, masks])
    want, got, cuts, noff = _run_both(kind, rng, k, r, m, ROWS[r], masks,
                                      remap=masks)
    _compare(want, got, cuts, noff)


def _n_under_patch(kind):
    """A row whose patch sits on a genome N (offset 40 of the row), run
    through the patched or spliced kind of both packages; returns the
    port's scores and the reference's and the port's outputs."""
    rng = np.random.default_rng(7)
    codes, nmask, g4, gn = _genome(rng, LENGTH, 0.0)
    nmask[:] = False
    gstart, pos, r, k, m = 1000, 40, 64, 5, 2
    nmask[gstart + pos] = True
    gn = ref.bytes_to_words(np.concatenate(
        [ref.pack_bits(nmask[None, :])[0], np.zeros(1040, np.uint8)]))
    pwm, mins, cuts, _, hs = _motif(rng, k, m, False)
    cuts[:] = mins  # every scored window a hit
    patches = np.full((1, 4), -1, np.int16)
    patches[0, 2] = pos * 4 + 1
    gs = np.array([gstart], np.int32)
    acc = jnp.zeros((hs, m), jnp.int32)
    lut = port.pwm_lut_from_kernel(pwm, CPU)
    pg4, pgn = port.genome_planes_to_device(g4, gn, CPU)
    if kind == "patched":
        want = ref.scan_runs_resident_patched_topk(
            acc, g4, gn, gs, patches, None, pwm, mins, cuts, r, k, hs, TOPK)
        got = port.scan_runs_resident_patched(
            pg4, pgn, _t(gs), _t(patches), None, lut, _t(mins), r, k, hs)
    else:
        splice = np.full((1, 2), 0x7FFF, np.int16)
        want = ref.scan_runs_resident_spliced_topk(
            acc, g4, gn, gs, splice, patches, None, pwm, mins, cuts, r, k,
            hs, TOPK)
        got = port.scan_runs_resident_spliced(
            pg4, pgn, _t(gs), _t(splice), _t(patches), None, lut, _t(mins),
            r, k, hs)
    _compare(want, got, cuts, r - k + 1)
    row = codes[gstart : gstart + r].astype(np.int64)
    row[pos] = 1  # the patched base
    return got[1].numpy()[0], mins, pos, k, pwm, row


@pytest.mark.parametrize("kind", ["patched", "spliced"])
def test_patch_over_n_base(kind):
    """The patched kind keeps the genome's N under a patch, so the windows
    over it score ``min_score``; the spliced kind clears it, so they score
    the patched base (reference ``:912-917`` against ``:987-989``)."""
    scores, mins, pos, k, pwm, row = _n_under_patch(kind)
    for o in range(pos - k + 1, pos + 1):
        want = (mins if kind == "patched"
                else sum(pwm[j, row[o + j]] for j in range(k)))
        np.testing.assert_array_equal(scores[o], want)
    # the windows clear of the N are scored in both kinds
    o = pos + 1
    np.testing.assert_array_equal(
        scores[o], sum(pwm[j, row[o + j]] for j in range(k)))


def test_descriptor_edge_rows():
    """Empty and full patch slots, negative splice shifts, and an unused
    pair before a used one, against the reference; the unused pair changes
    nothing."""
    rng = np.random.default_rng(11)
    _, _, g4, gn = _genome(rng, LENGTH, 0.01)
    r, k, m, b = 256, 19, 2, 6
    pwm, mins, cuts, bases, hs = _motif(rng, k, m, True)
    gstart = np.full(b, 4000, np.int32)
    patches = np.full((b, 16), -1, np.int16)  # row 0: no patch
    patches[1] = np.arange(16) * 16 * 4 + 3  # row 1: every slot
    patches[2, :2] = (7 * 4 + 1, 7 * 4 + 2)  # row 2: a later slot wins
    splice = np.full((b, 4), 0x7FFF, np.int16)
    splice[3, :2] = (100, -9)  # negative shift
    splice[4, 2:] = (100, -9)  # an unused pair before the same used one
    splice[5, :] = (50, 20, 150, -30)  # a later pair overrides
    acc = jnp.zeros((hs, m), jnp.int32)
    want = ref.scan_runs_resident_spliced_topk(
        acc, g4, gn, gstart, splice, patches, None, pwm, mins, cuts, r, k,
        hs, TOPK, hist_bases=jnp.asarray(bases))
    pg4, pgn = port.genome_planes_to_device(g4, gn, CPU)
    got = port.scan_runs_resident_spliced(
        pg4, pgn, _t(gstart), _t(splice), _t(patches), None,
        port.pwm_lut_from_kernel(pwm, CPU), _t(mins), r, k, hs,
        hist_bases=_t(bases))
    _compare(want, got, cuts, r - k + 1)
    scores = got[1].numpy()
    np.testing.assert_array_equal(scores[3], scores[4])
    assert not np.array_equal(scores[0], scores[3])


def test_counts_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(12)
    port.reset_counts()
    for kind in KINDS:
        _run_both(kind, rng, 5, 64, 2, 4, True, True)
    assert port.COUNTS == {"kernel": 0, "fused": 0, "plain": len(KINDS)}
    port.reset_counts()
    assert port.COUNTS == {"kernel": 0, "fused": 0, "plain": 0}


def _gathered_args():
    rng = np.random.default_rng(13)
    _, _, g4, gn = _genome(rng, LENGTH, 0.01)
    pg4, pgn = port.genome_planes_to_device(g4, gn, CPU)
    pwm, mins, _, _, hs = _motif(rng, 5, 2, False)
    gstart = torch.tensor([100, 200, 300], dtype=torch.int32)
    return [pg4, pgn, gstart, None, port.pwm_lut_from_kernel(pwm, CPU),
            _t(mins), 64, 5, hs]


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "device"])
def test_wrapper_checks_its_tensors(fault):
    args = _gathered_args()
    match = {"dtype": "gstart must be torch.int32",
             "contiguity": "lut must be contiguous",
             "shape": r"min_scores must be \(2,\)",
             "device": "unsupported device"}[fault]
    if fault == "dtype":
        args[2] = args[2].to(torch.int64)
    elif fault == "contiguity":
        args[4] = args[4].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "shape":
        args[5] = args[5][:1]
    else:
        args = [t.to("meta") if isinstance(t, torch.Tensor) else t
                for t in args]
    with pytest.raises((TypeError, ValueError), match=match):
        port.scan_runs_resident(*args)


def test_strided_span_past_the_plane_raises():
    rng = np.random.default_rng(14)
    _, _, g4, gn = _genome(rng, LENGTH, 0.01)
    pg4, pgn = port.genome_planes_to_device(g4, gn, CPU)
    pwm, mins, _, _, hs = _motif(rng, 19, 2, False)
    lut = port.pwm_lut_from_kernel(pwm, CPU)
    r, b = 256, 8
    stride = r - 19 + 1
    last_ok = pg4.shape[0] * 16 - 16 - (b * stride + r)  # one word spare
    lo = last_ok - last_ok % 16
    port.scan_runs_resident_strided(pg4, None, lo, None, lut, _t(mins), b,
                                    stride, r, 19, hs)
    with pytest.raises(RuntimeError, match="exceeds the resident plane"):
        port.scan_runs_resident_strided(pg4, None, lo + 16, None, lut,
                                        _t(mins), b, stride, r, 19, hs)
    with pytest.raises(RuntimeError, match="exceeds the resident plane"):
        port.scan_runs_resident_strided(pg4, pgn, -1, None, lut, _t(mins), b,
                                        stride, r, 19, hs)
    with pytest.raises(ValueError, match="stride <= R"):
        port.scan_runs_resident_strided(pg4, None, 0, None, lut, _t(mins), b,
                                        stride // 3, r, 19, hs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(kind):
    """On a card: one launch of the kernel bit-identical to the plain
    version on the same CUDA tensors, for every kind with masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(15)
    _, _, g4, gn = _genome(rng, LENGTH, 0.01)
    dev = torch.device("cuda")
    pwm, mins, _, _, _ = _motif(rng, 19, 2, True)
    lut = port.pwm_lut_from_kernel(pwm, dev)
    mins = torch.from_numpy(mins).to(dev)
    pg4, pgn = port.genome_planes_to_device(g4, gn, dev)
    b, r = 64, 256
    noff = r - 19 + 1
    vb = torch.from_numpy(ref.pack_bits(rng.random((b, noff)) < 0.9)).to(dev)
    gstart = torch.from_numpy(
        rng.integers(16, LENGTH - r - 16, b).astype(np.int32)).to(dev)
    patches = torch.from_numpy(_patches(rng, b, r, 16)).to(dev)
    splice = torch.from_numpy(_splice(rng, b, r)).to(dev)
    packed = torch.from_numpy(
        ref.pack_run_seqs(rng.integers(0, 4, (b, r)))).to(dev)
    nbits = torch.from_numpy(ref.pack_bits(rng.random((b, r)) < 0.02)).to(dev)
    plain, kernel = {
        "packed": (port.scan_runs_device_reference,
                   port.scan_runs_device),
        "gathered": (port.scan_runs_resident_reference,
                     port.scan_runs_resident),
        "strided": (port.scan_runs_resident_strided_reference,
                    port.scan_runs_resident_strided),
        "patched": (port.scan_runs_resident_patched_reference,
                    port.scan_runs_resident_patched),
        "spliced": (port.scan_runs_resident_spliced_reference,
                    port.scan_runs_resident_spliced),
    }[kind]
    head = {
        "packed": (packed, nbits, vb),
        "gathered": (pg4, pgn, gstart, vb),
        "strided": (pg4, pgn, 1000, vb),
        "patched": (pg4, pgn, gstart, patches, vb),
        "spliced": (pg4, pgn, gstart, splice, patches, vb),
    }[kind]
    tail = {"packed": (19,), "strided": (b, noff, r, 19)}.get(kind, (r, 19))
    port.reset_counts()
    _, got = kernel(*head, lut, mins, *tail, 19 * 1000 + 1)
    want = plain(*head, lut, mins, *tail)
    torch.cuda.synchronize()
    assert port.COUNTS == {"kernel": 1, "fused": 0, "plain": 1}
    assert torch.equal(got, want)
