"""The port's on-device hit compaction (``grafimo_tpu_torch/ops/compact.py``)
against the reference's: ``_finish_scores``' hit bits and
``_topk_package_tiered``'s count and indices on the same score planes --
sparse, empty, dense (rows past the reference's slot capacity) and over
the port's index capacity.  Tolerance 0: integer counts, indices and
bytes.  The CUDA kernel against its plain version runs on a card only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grafimo_tpu.ops.score_runs as ref
from grafimo_tpu_torch.ops import compact

torch.set_num_threads(1)

TOPK = 256


def _plane(seed, b, noff, m, p):
    """Scores whose hits are a ``p`` fraction of the windows: hit windows
    score at or above their column's cutoff, others below it or -1
    (invalid)."""
    rng = np.random.default_rng(seed)
    cuts = rng.integers(100, 5000, m).astype(np.int32)
    hit = rng.random((b, noff, m)) < p
    below = cuts - rng.integers(1, 100, (b, noff, m))
    above = cuts + rng.integers(0, 100, (b, noff, m))
    scores = np.where(hit, above, below)
    scores = np.where(rng.random((b, noff, m)) < 0.05, -1, scores)
    return scores.astype(np.int32), cuts


def _reference(scores, cuts):
    """The reference's hit bits and tiered compaction of ``scores``."""
    b, noff, m = scores.shape
    mins = np.zeros(m, np.int32)
    _hist, hitbits = ref._finish_scores(
        jnp.asarray(scores), None, None, jnp.asarray(mins),
        jnp.asarray(cuts), 1, 8,
    )
    acc = jnp.zeros((8, m), jnp.int32)
    _acc, _hb, n_hits, top = ref._topk_package_tiered(
        acc, acc, hitbits, noff, m, TOPK)
    return np.asarray(hitbits), int(n_hits), np.asarray(top)


def _port(scores, cuts, cap, more_cap=None):
    count = torch.full((1,), -7, dtype=torch.int32)
    idx = torch.full((cap,), -7, dtype=torch.int32)
    more = (None if more_cap is None
            else torch.full((more_cap,), -7, dtype=torch.int32))
    bits = compact.compact_hits(torch.from_numpy(scores),
                                torch.from_numpy(cuts), count, idx, more)
    return int(count), idx.numpy(), None if more is None else more.numpy(), \
        bits.numpy()


# (b, noff, m, hit fraction): the shapes of tests/test_runscan.py:253
CASES = [
    (8, 130, 1, 0.02),  # noff % 8 != 0
    (16, 64, 2, 0.05),  # two columns interleave in flat order
    (4, 200, 3, 0.01),
    (8, 96, 2, 0.0),  # empty
    (8, 40, 2, 0.6),  # dense: rows past the reference's 32 slots
    (3, 2030, 2, 1e-3),  # the run engine's Noff
]


@pytest.mark.parametrize("b,noff,m,p", CASES)
def test_plain_matches_reference_tiers(b, noff, m, p):
    scores, cuts = _plane(b * noff + m, b, noff, m, p)
    hitbits, n_ref, top_ref = _reference(scores, cuts)
    want = np.flatnonzero(ref.unpack_hitbits(hitbits, noff))
    count, idx, _, bits = _port(scores, cuts, cap=len(want) + 3)
    np.testing.assert_array_equal(bits, hitbits)
    assert count == len(want)
    np.testing.assert_array_equal(idx[:count], want)
    assert (idx[count:] == -7).all()  # nothing written past the hits
    if n_ref <= TOPK:  # the reference compacted this plane
        assert n_ref == count
        np.testing.assert_array_equal(top_ref[:count] - 1, want)
    else:  # the reference took its bitmask tier: a row past its slots
        assert count > ref._ROW_SLOTS


@pytest.mark.parametrize("cap,more_cap", [(0, None), (5, None), (3, 4),
                                          (3, 100), (0, 6)])
def test_capacity_splits_and_overflows(cap, more_cap):
    """Past ``idx`` the hits go on into ``more``; past both, the count
    stays exact and the bits hold every hit (the bitmask tier)."""
    scores, cuts = _plane(5, 6, 70, 2, 0.02)
    hitbits, _, _ = _reference(scores, cuts)
    want = np.flatnonzero(ref.unpack_hitbits(hitbits, 70))
    assert len(want) > 10
    count, idx, more, bits = _port(scores, cuts, cap, more_cap)
    assert count == len(want)
    np.testing.assert_array_equal(bits, hitbits)
    got = list(idx) + ([] if more is None else list(more))
    n = min(len(want), len(got))
    np.testing.assert_array_equal(got[:n], want[:n])
    assert all(v == -7 for v in got[n:])


def test_hit_mask_and_bits_match_reference():
    scores, cuts = _plane(9, 5, 53, 3, 0.3)
    hitbits, _, _ = _reference(scores, cuts)
    mask = compact.hit_mask(torch.from_numpy(scores), torch.from_numpy(cuts))
    np.testing.assert_array_equal(mask.numpy(),
                                  ref.unpack_hitbits(hitbits, 53))
    np.testing.assert_array_equal(compact.pack_hit_bits(mask).numpy(),
                                  hitbits)


def test_cpu_takes_the_plain_version():
    scores, cuts = _plane(3, 2, 30, 1, 0.1)
    compact.reset_counts()
    _port(scores, cuts, cap=4)
    assert compact.COUNTS == {"kernel": 0, "plain": 1}


def test_rejects_bad_arguments():
    s = torch.zeros((2, 8, 3), dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        compact.compact_hits(s.to("meta"), torch.zeros(3, dtype=torch.int32,
                                                       device="meta"),
                             one.to("meta"), one.to("meta"))
    with pytest.raises(ValueError, match="cutoffs must be"):
        compact.compact_hits(s, torch.zeros(2, dtype=torch.int32), one, one)
    with pytest.raises(ValueError, match=r"\(B, Noff, M\)"):
        compact.compact_hits(s[0], torch.zeros(3, dtype=torch.int32), one,
                             one)
    with pytest.raises(ValueError, match="on cpu, scores on meta"):
        compact.compact_hits(s.to("meta"), torch.zeros(3, dtype=torch.int32),
                             one, one)


@pytest.mark.cuda
@pytest.mark.parametrize("b,noff,m,p", CASES + [(2048, 2030, 2, 1e-4),
                                                (300, 2030, 2, 1.0)])
def test_kernel_matches_plain_on_card(b, noff, m, p):
    """On a card: counts exact, indices equal once sorted, bits equal,
    with the indices split over ``idx`` and ``more``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scores, cuts = _plane(b + noff, b, noff, m, p)
    s, c = torch.from_numpy(scores).cuda(), torch.from_numpy(cuts).cuda()
    out = {}
    for name, fn in (("kernel", compact.compact_hits),
                     ("plain", compact.compact_hits_reference)):
        count = torch.zeros(1, dtype=torch.int32, device="cuda")
        idx = torch.full((64,), -1, dtype=torch.int32, device="cuda")
        more = torch.full((4096,), -1, dtype=torch.int32, device="cuda")
        bits = fn(s, c, count, idx, more)
        torch.cuda.synchronize()
        n = int(count)
        got = torch.cat([idx, more])[: min(n, 64 + 4096)].cpu()
        out[name] = (n, got, bits.cpu())
    (nk, ik, bk), (np_, ip, bp) = out["kernel"], out["plain"]
    assert nk == np_
    assert torch.equal(bk, bp)
    if nk <= 64 + 4096:
        assert torch.equal(torch.sort(ik).values, ip)
