"""The port's exact histogram (``grafimo_tpu_torch/ops/hist.py``) against
the reference's: numpy ``bincount``, the XLA ``_exact_hist`` path and
every Pallas histogram kernel in interpret mode; with ``bases``, against
the torch remap followed by the histogram and the reference's compressed
``_finish_scores`` histogram.  Tolerance 0: every quantity compared is an
integer count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grafimo_tpu.ops.pallas_hist import (
    _tile_n,
    hist_pallas,
    hist_pallas2,
    hist_pallas3,
    hist_pallas4,
)
from grafimo_tpu.ops.score_runs import _exact_hist, _finish_scores
from grafimo_tpu_torch.ops import hist as th

torch.set_num_threads(1)

HIST_SIZES = [301, 19001]  # small, and k = 19's 1000*k + 1


def _scores(seed, shape, hist_size, over=100, invalid=0.05):
    """int32 scores over [0, hist_size + over), ~5% of them -1."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, hist_size + over, shape).astype(np.int32)
    s[rng.random(shape) < invalid] = -1
    return s


def _numpy_hist(scores, hist_size):
    flat = scores.reshape(-1, scores.shape[-1])
    out = np.zeros((hist_size, flat.shape[1]), np.int32)
    for c in range(flat.shape[1]):
        v = flat[:, c]
        v = v[(v >= 0) & (v < hist_size)]
        out[:, c] = np.bincount(v, minlength=hist_size)
    return out


def _plain(scores, hist_size):
    return th.exact_hist_reference(torch.from_numpy(scores), hist_size).numpy()


@pytest.mark.parametrize("hist_size", HIST_SIZES)
@pytest.mark.parametrize("m", [1, 2, 5])
def test_plain_matches_numpy_bincount(m, hist_size):
    rng = np.random.default_rng(m)
    s = rng.integers(-50, hist_size + 1000, (9, 70, m)).astype(np.int32)
    s[0, :4, 0] = [0, hist_size - 1, hist_size, -1]
    got = _plain(s, hist_size)
    assert got.dtype == np.int32 and got.shape == (hist_size, m)
    np.testing.assert_array_equal(got, _numpy_hist(s, hist_size))


@pytest.mark.parametrize("hist_size", HIST_SIZES)
@pytest.mark.parametrize("m", [1, 2, 5])
def test_plain_matches_xla_exact_hist(m, hist_size):
    s = _scores(10 + m, (13, 61, m), hist_size)
    want = np.asarray(
        _exact_hist(jnp.asarray(s), hist_size, allow_pallas=False)
    )
    np.testing.assert_array_equal(_plain(s, hist_size), want)


@pytest.mark.parametrize(
    "m,hist_size", [(1, 19001), (2, 301), (5, 19001)]
)
def test_plain_matches_hist_pallas_lo128(m, hist_size):
    """The kernel this port replaces, at the main path's lo_w=128, over
    several grid tiles plus a padded one."""
    n = 2 * _tile_n(m) + 77
    s = _scores(20 + m, (1, n, m), hist_size)
    want = np.asarray(hist_pallas(s, hist_size, interpret=True, lo_w=128))
    np.testing.assert_array_equal(_plain(s, hist_size), want)


@pytest.mark.parametrize(
    "variant",
    ["v2_bf16", "v2_int8", "v3_bf16", "v3_f32", "v4"],
)
def test_plain_matches_pallas_variants(variant):
    """Kernels 2-4 share kernel 1's contract; the plain version (and with
    it the CUDA kernel it is checked against on the card) reproduces each
    one's interpret-mode output, multi-tile, over its own parameters."""
    hist_size = 7426 if variant == "v4" else 19001
    s = _scores(30, (11, 650, 2), hist_size, over=0)
    s[0, :4, 0] = [0, hist_size - 1, -1, 127]
    if variant.startswith("v2"):
        got = hist_pallas2(s, hist_size, interpret=True,
                           use_int8=variant == "v2_int8")
    elif variant.startswith("v3"):
        got = hist_pallas3(s, hist_size, interpret=True,
                           use_f32=variant == "v3_f32", tile=2048)
    else:
        got = hist_pallas4(s, hist_size, interpret=True, tile=2048)
    np.testing.assert_array_equal(_plain(s, hist_size), np.asarray(got))


def test_exact_hist_on_cpu_takes_the_plain_version():
    s = _scores(40, (4, 50, 2), 301)
    th.reset_counts()
    got = th.exact_hist(torch.from_numpy(s), 301)
    assert th.COUNTS == {"kernel": 0, "plain": 1}
    np.testing.assert_array_equal(got.numpy(), _numpy_hist(s, 301))


def _compressed_scores(seed, m):
    """A masked score plane as the run engine hands it over, with each
    column's base and compressed bin count: scores in [base, top], N-window
    values below the base, -1 invalid, and the top and base themselves."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(100, 3000, m).astype(np.int32)
    spans = rng.integers(50, 4000, m).astype(np.int32)
    tops = bases + spans - 1
    s = (bases + rng.integers(0, spans, (7, 90, m))).astype(np.int32)
    roll = rng.random(s.shape)
    s[roll < 0.05] = -1
    s = np.where(roll > 0.97, bases - rng.integers(1, 90, s.shape), s)
    s[0, :3] = [bases - 1, bases, tops]  # bin 0, bin 1, the top bin
    s[1, 0] = -1
    return s.astype(np.int32), bases, int(spans.max()) + 1


def _torch_remap(s, bases):
    """The run engine's remap as torch ops, before the histogram took it."""
    return torch.where(s < 0, -1, torch.clamp(s - bases + 1, min=0))


@pytest.mark.parametrize("m", [1, 2, 5])
def test_bases_remap_matches_torch_remap(m):
    s, bases, hs = _compressed_scores(60 + m, m)
    st, bt = torch.from_numpy(s), torch.from_numpy(bases)
    th.reset_counts()
    got = th.exact_hist(st, hs, bt)
    assert th.COUNTS == {"kernel": 0, "plain": 1}
    want = th.exact_hist(_torch_remap(st, bt).contiguous(), hs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    got = got.numpy()
    assert got[0].sum() > 0  # N-window values below the base: bin 0
    assert got[hs - 1].sum() > 0  # the top bin
    assert got.sum() == (s >= 0).sum()  # only the -1 entries dropped


@pytest.mark.parametrize("m", [1, 2, 5])
def test_bases_remap_matches_reference_finish_scores(m):
    """The compressed histogram of the reference's ``_finish_scores`` with
    ``hist_bases`` (no N plane, every offset valid: the scores pass to
    its remap as they are)."""
    s, bases, hs = _compressed_scores(70 + m, m)
    want, _ = _finish_scores(
        jnp.asarray(s), None, None, jnp.zeros(m, jnp.int32),
        jnp.zeros(m, jnp.int32), 1, hs, allow_pallas=False,
        hist_bases=jnp.asarray(bases))
    got = th.exact_hist(torch.from_numpy(s), hs, torch.from_numpy(bases))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bases_are_checked():
    s = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"bases must be \(3,\)"):
        th.exact_hist(s, 8, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="bases must be int32"):
        th.exact_hist(s, 8, torch.zeros(3, dtype=torch.int64))


def test_exact_hist_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        th.exact_hist(torch.zeros((4, 2), dtype=torch.int32, device="meta"), 8)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,hist_size", [(2, 19002), (16, 19002), (40, 19002), (2, 70002)]
)
def test_kernel_matches_plain_on_card(m, hist_size):
    """On a card: the CUDA kernel bit-identical to the plain version,
    bins in one block's shared memory, in column groups (M = 16, 40) and
    (70002 bins) split over a thread-block cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = _scores(50 + m, (64, 1000, m), hist_size)
    dev = torch.from_numpy(s).cuda()
    th.reset_counts()
    got = th.exact_hist(dev, hist_size)
    want = th.exact_hist_reference(dev, hist_size)
    torch.cuda.synchronize()
    assert th.COUNTS == {"kernel": 1, "plain": 1}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 16, 40])
def test_kernel_remap_matches_plain_on_card(m):
    """On a card: the kernel's remap on load bit-identical to the plain
    version's, in one block, and in column groups (M = 16, 40)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s, bases, hs = _compressed_scores(80 + m, m)
    dev, bdev = torch.from_numpy(s).cuda(), torch.from_numpy(bases).cuda()
    th.reset_counts()
    got = th.exact_hist(dev, hs, bdev)
    want = th.exact_hist_reference(dev, hs, bdev)
    torch.cuda.synchronize()
    assert th.COUNTS == {"kernel": 1, "plain": 1}
    assert torch.equal(got, want)
