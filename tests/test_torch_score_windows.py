"""The port's window scoring (``grafimo_tpu_torch/ops/scan_packed.py``,
``ops/score_windows.py``) against the reference's: the fused Pallas
kernel in interpret mode, and the XLA ``score_and_histogram``,
``score_batch`` and ``score_and_histogram_packed`` on the same arrays.
Tolerance 0: scores and histogram counts are integers."""

import numpy as np
import pytest
import torch

import grafimo_tpu.ops.score_jax as ref
import grafimo_tpu_torch.ops.score_windows as port
from grafimo_tpu.models.parse import load_motifs
from grafimo_tpu.ops.pack import pack_codes
from grafimo_tpu.ops.pallas_scan import (
    TILE_B,
    pallas_score_packed,
    pwm_shift_major,
)
from grafimo_tpu.utils.constants import N_CODE, PAD_CODE, RANGE, UNIF
from grafimo_tpu_torch.ops import scan_packed as sp

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ctcf(input_dir):
    return load_motifs(str(input_dir / "MA0139.1.meme"), UNIF, 0.1, False)[0]


def _codes(rng, b, k, n_frac=0.02, pad_rows=3):
    """Random codes with scattered N bases, a few all-PAD rows and one
    row holding both an N and a PAD code."""
    codes = rng.integers(0, 4, (b, k)).astype(np.uint8)
    codes[rng.random((b, k)) < n_frac] = N_CODE
    codes[-pad_rows:, :] = PAD_CODE
    codes[1, 0], codes[1, k - 1] = N_CODE, PAD_CODE
    return codes


def _mats(rng, k, m, high=1001):
    return [rng.integers(0, high, (4, k)) for _ in range(m)]


def _mins(mats):
    return np.array([int(np.asarray(s).min(axis=0).sum()) for s in mats],
                    np.int32)


def _lut(mats):
    return port.pwm_lut_from_flat(port.pwms_to_flat(mats), CPU)


def _ref_sh(fn, *args):
    scores, hist = fn(*args)
    return np.asarray(scores), np.asarray(hist)


def test_score_packed_matches_pallas(ctcf):
    """The TPU kernel this port replaces, in interpret mode, on CTCF and
    its reverse complement with N and PAD rows (as
    ``tests/test_pallas_scan.py:27``)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (TILE_B * 2, 19)).astype(np.uint8)
    codes[5, 2] = N_CODE
    codes[-1, :] = PAD_CODE
    mats = [ctcf.score_matrix, ref.reverse_complement_pwm(ctcf.score_matrix)]
    mins = np.array([ctcf.min_score] * 2, dtype=np.int32)
    packed, flags = pack_codes(codes)
    want = np.asarray(
        pallas_score_packed(
            packed, flags, pwm_shift_major(mats, 19), mins, interpret=True
        )
    )
    sp.reset_counts()
    got = sp.score_packed(torch.from_numpy(packed), torch.from_numpy(flags),
                          _lut(mats), torch.from_numpy(mins))
    assert sp.COUNTS == {"kernel": 0, "plain": 1, "fused": 0}
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[-1] == -1).all() and (want[5] == ctcf.min_score).all()


@pytest.mark.parametrize("k", [8, 19, 30])
@pytest.mark.parametrize("m", [1, 2, 5])
def test_packed_matches_xla_packed(k, m):
    rng = np.random.default_rng(100 * k + m)
    codes = _codes(rng, 300, k)
    mats = _mats(rng, k, m)
    mins = _mins(mats)
    packed, flags = pack_codes(codes)
    hs = ref.hist_size_for_width(k)
    want_s, want_h = _ref_sh(
        ref.score_and_histogram_packed, packed, flags,
        ref.pwms_to_flat(mats), mins, k, hs,
    )
    lut = _lut(mats)
    got_plain = sp.score_packed_reference(
        torch.from_numpy(packed), torch.from_numpy(flags), lut,
        torch.from_numpy(mins),
    )
    np.testing.assert_array_equal(got_plain.numpy(), want_s)
    got_s, got_h = port.score_and_histogram_packed(packed, flags, lut, mins,
                                                   k, hs)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    # the same call with tensors already on the device
    got_s, got_h = port.score_and_histogram_packed(
        torch.from_numpy(packed), torch.from_numpy(flags), lut, mins, k, hs
    )
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_h.numpy(), want_h)


# (label, k, M, highest LUT entry); "clip": entries up to 1020, so
# scores pass RANGE * k and the reference clamps them into the last bin
CORE_CASES = [
    ("ctcf_width", 19, 1, 1001),
    ("two_columns", 19, 2, 1001),
    ("short", 5, 3, 1001),
    ("long", 30, 2, 1001),
    ("clip", 8, 2, 1021),
]


@pytest.mark.parametrize("label,k,m,high", CORE_CASES)
def test_score_and_histogram_matches_reference(label, k, m, high):
    rng = np.random.default_rng(sum(map(ord, label)))
    codes = _codes(rng, 257, k)
    mats = _mats(rng, k, m, high)
    if label == "clip":
        mats[0][:, :] = 1020  # every clean row of column 0 scores 1020*k
    mins = _mins(mats)
    hs = ref.hist_size_for_width(k)
    want_s, want_h = _ref_sh(
        ref.score_and_histogram, codes, ref.pwms_to_flat(mats), mins, hs
    )
    got_s, got_h = port.score_and_histogram(codes, _lut(mats), mins, hs)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    core_s, core_h = port.score_hist_core(codes, _lut(mats), mins, hs)
    assert torch.equal(core_s, got_s) and torch.equal(core_h, got_h)
    if label == "clip":
        assert want_s.max() > RANGE * k
        assert want_h[hs - 1, 0] == (want_s[:, 0] >= hs - 1).sum() > 0


@pytest.mark.parametrize("k,m", [(19, 1), (19, 2), (7, 4)])
def test_score_batch_matches_reference(k, m):
    rng = np.random.default_rng(k + m)
    codes = _codes(rng, 200, k)
    mats = _mats(rng, k, m)
    mins = _mins(mats)
    want = np.asarray(ref.score_batch(codes, ref.pwms_to_flat(mats), mins))
    got = port.score_batch(codes, _lut(mats), mins)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_rows_score_differently_by_entry_point(ctcf):
    """A PAD row scores ``min_score`` in ``score_batch`` but -1 (and
    drops from the histogram) in ``score_and_histogram``, as in the
    reference (``score_jax.py:70-71, 114-115``)."""
    codes = np.full((2, 19), PAD_CODE, np.uint8)
    codes[0] = 0
    lut = _lut([ctcf.score_matrix])
    mins = np.array([ctcf.min_score], np.int32)
    hs = ref.hist_size_for_width(19)
    batch = port.score_batch(codes, lut, mins)
    scores, hist = port.score_and_histogram(codes, lut, mins, hs)
    assert batch[1, 0] == ctcf.min_score and scores[1, 0] == -1
    assert batch[0, 0] == scores[0, 0] >= 0
    assert int(hist.sum()) == 1


# (label, k, M, highest LUT entry); "clip": column 0 at 1020 everywhere
FUSED_CASES = [
    ("ctcf_width", 19, 1, 1001),
    ("clip", 19, 2, 1021),
    ("short_clip", 8, 3, 1021),
]


def _fused_inputs(label, k, m, high):
    rng = np.random.default_rng(sum(map(ord, label)) + 7)
    mats = _mats(rng, k, m, high)
    if high > 1001:
        mats[0][:, :] = 1020  # every clean row of column 0 scores 1020*k
    # two calls of different sizes, each with N and PAD rows
    return mats, _mins(mats), [_codes(rng, b, k) for b in (TILE_B, 700)]


@pytest.mark.parametrize("label,k,m,high", FUSED_CASES)
def test_fused_plain_accumulates_like_reference(label, k, m, high):
    """The fused entry's plain version over two calls into one int64
    running histogram: scores equal to the TPU kernel in interpret mode,
    the histogram to the sum of the reference's two XLA histograms."""
    mats, mins, calls = _fused_inputs(label, k, m, high)
    hs = ref.hist_size_for_width(k)
    hist = torch.zeros((hs, m), dtype=torch.int64)
    want_hist = np.zeros((hs, m), np.int64)
    sp.reset_counts()
    for packed, flags in map(pack_codes, calls):
        got = sp.score_packed_hist(
            torch.from_numpy(packed), torch.from_numpy(flags), _lut(mats),
            torch.from_numpy(mins), hist,
        )
        pallas = np.asarray(pallas_score_packed(
            np.pad(packed, ((0, -len(packed) % TILE_B), (0, 0))),
            np.pad(flags, (0, -len(flags) % TILE_B), constant_values=2),
            pwm_shift_major(mats, k), mins, interpret=True,
        ))[: len(packed)]
        want_s, want_h = _ref_sh(
            ref.score_and_histogram_packed, packed, flags,
            ref.pwms_to_flat(mats), mins, k, hs,
        )
        np.testing.assert_array_equal(got.numpy(), pallas)
        np.testing.assert_array_equal(got.numpy(), want_s)
        want_hist += want_h
    assert sp.COUNTS == {"kernel": 0, "plain": 2, "fused": 0}
    assert hist.dtype == torch.int64
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    assert (got.numpy() == -1).any() and (flags == 1).any()
    if high > 1001:
        assert want_hist[hs - 1, 0] > 0 and want_s.max() > RANGE * k


@pytest.mark.parametrize("label,k,m,high", FUSED_CASES)
def test_score_and_accumulate_matches_reference(label, k, m, high):
    """The window engine's entry: codes in, scores out, the running
    histogram summed across calls as the reference's int32 histograms."""
    mats, mins, calls = _fused_inputs(label, k, m, high)
    hs = ref.hist_size_for_width(k)
    hist = torch.zeros((hs, m), dtype=torch.int64)
    want_hist = np.zeros((hs, m), np.int64)
    for codes in calls:
        want_s, want_h = _ref_sh(
            ref.score_and_histogram, codes, ref.pwms_to_flat(mats), mins, hs
        )
        got = port.score_and_accumulate(codes, _lut(mats), mins, hist)
        np.testing.assert_array_equal(got.numpy(), want_s)
        want_hist += want_h
    np.testing.assert_array_equal(hist.numpy(), want_hist)


def test_score_packed_hist_checks_its_inputs():
    lut = torch.zeros((19, 4, 2), dtype=torch.int32)
    packed = torch.zeros((6, 5), dtype=torch.uint8)
    flags = torch.zeros(6, dtype=torch.uint8)
    mins = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"hist must be \(hist_size, 2\)"):
        sp.score_packed_hist(packed, flags, lut, mins,
                             torch.zeros((9, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="hist on meta"):
        sp.score_packed_hist(packed, flags, lut, mins,
                             torch.zeros((9, 2), dtype=torch.int64,
                                         device="meta"))
    hist = torch.zeros((9, 2), dtype=torch.int64)
    sp.score_packed_hist(packed, flags, lut, mins, hist)
    assert hist[0].tolist() == [6, 6] and int(hist.sum()) == 12


def test_pwm_lut_from_flat_round_trip():
    rng = np.random.default_rng(5)
    mats = _mats(rng, 9, 3, high=1021)
    flat = port.pwms_to_flat(mats)
    lut = port.pwm_lut_from_flat(flat, CPU)
    assert lut.dtype == torch.int32 and tuple(lut.shape) == (9, 4, 3)
    for c, mat in enumerate(mats):
        np.testing.assert_array_equal(lut[:, :, c].numpy(), np.asarray(mat).T)
    # back to the flat layout, row 4*i + code
    np.testing.assert_array_equal(
        lut.numpy().reshape(36, 3).astype(np.float32), flat
    )
    with pytest.raises(ValueError, match=r"\(4k, M\)"):
        port.pwm_lut_from_flat(flat[:-1], CPU)
    bad = flat.copy()
    bad[3, 1] = 1021
    with pytest.raises(ValueError, match="outside"):
        port.pwm_lut_from_flat(bad, CPU)


def test_copied_helpers_match_reference():
    rng = np.random.default_rng(6)
    mats = _mats(rng, 11, 4)
    np.testing.assert_array_equal(port.pwm_to_flat(mats[0]),
                                  ref.pwm_to_flat(mats[0]))
    np.testing.assert_array_equal(port.pwms_to_flat(mats),
                                  ref.pwms_to_flat(mats))
    np.testing.assert_array_equal(port.reverse_complement_pwm(mats[1]),
                                  ref.reverse_complement_pwm(mats[1]))
    assert port.hist_size_for_width(11) == ref.hist_size_for_width(11)


def test_score_packed_checks_its_inputs():
    lut = torch.zeros((19, 4, 2), dtype=torch.int32)
    packed = torch.zeros((6, 5), dtype=torch.uint8)
    flags = torch.zeros(6, dtype=torch.uint8)
    mins = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"packed must be \(B, 5\)"):
        sp.score_packed(packed[:, :4], flags, lut, mins)
    with pytest.raises(ValueError, match="flags must be"):
        sp.score_packed(packed, flags[:5], lut, mins)
    with pytest.raises(ValueError, match="min_scores must be"):
        sp.score_packed(packed, flags, lut, mins[:1])
    with pytest.raises(ValueError, match="unsupported device"):
        sp.score_packed(packed.to("meta"), flags.to("meta"), lut.to("meta"),
                        mins.to("meta"))
    with pytest.raises(ValueError, match="on meta"):
        sp.score_packed(packed.to("meta"), flags, lut, mins)
    assert sp.score_packed(packed[:0], flags[:0], lut, mins).shape == (0, 2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,k,m,high",
    [(1 << 18, 19, 1, 1001), (4093, 19, 2, 1001), (4093, 30, 16, 1001),
     (4093, 8, 1, 1001), (4093, 19, 3, 1021), (5000, 60, 300, 1001)],
)
def test_kernel_matches_plain_on_card(b, k, m, high):
    """On a card: the CUDA kernel bit-identical to the plain version,
    with N and PAD rows, LUT entries up to 1020, and (k = 60, M = 300) a
    LUT past a block's shared memory."""
    dev = _card()
    rng = np.random.default_rng(b + k + m)
    packed, flags = pack_codes(_codes(rng, b, k))
    mats = _mats(rng, k, m, high)
    lut = port.pwm_lut_from_flat(port.pwms_to_flat(mats), dev)
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(flags).to(dev),
            lut, torch.from_numpy(_mins(mats)).to(dev))
    sp.reset_counts()
    got = sp.score_packed(*args)
    want = sp.score_packed_reference(*args)
    torch.cuda.synchronize()
    assert sp.COUNTS == {"kernel": 1, "plain": 1, "fused": 0}
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_score_and_histogram_on_card_matches_cpu(ctcf):
    dev = _card()
    rng = np.random.default_rng(9)
    codes = _codes(rng, 70001, 19)
    mats = [ctcf.score_matrix, ref.reverse_complement_pwm(ctcf.score_matrix)]
    mins = _mins(mats)
    hs = ref.hist_size_for_width(19)
    flat = port.pwms_to_flat(mats)
    got = port.score_and_histogram(codes, port.pwm_lut_from_flat(flat, dev),
                                   mins, hs)
    want = port.score_and_histogram(codes, port.pwm_lut_from_flat(flat, CPU),
                                    mins, hs)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
