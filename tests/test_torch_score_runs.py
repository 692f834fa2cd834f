"""The port's five batch kinds (``grafimo_tpu_torch/ops/score_runs.py``)
against the reference's jitted kernels on the same arrays: identical
histograms, and the port's masked scores compacted by
``ops/compact.py`` into the reference's hit bits byte for byte (tolerance
0, integers).  Also pins the host helpers the port copies to their
originals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grafimo_tpu.ops.score_jax as ref_jax
import grafimo_tpu.ops.score_runs as ref
import grafimo_tpu_torch.ops.score_runs as port
from grafimo_tpu_torch.ops import compact

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOPK = 64  # the reference's compaction capacity; its exact hit bits are
# compared always


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _genome(rng, length, n_frac=0.01):
    """Random genome codes and N mask, and the word planes with the
    resident margin (R/2 + 16 bytes past the end)."""
    codes = rng.integers(0, 4, length).astype(np.uint8)
    nmask = rng.random(length) < n_frac
    margin = np.zeros(2048 // 2 + 16, np.uint8)
    g4 = ref.bytes_to_words(
        np.concatenate([ref.pack_run_seqs(codes[None, :])[0], margin])
    )
    gn = ref.bytes_to_words(
        np.concatenate([ref.pack_bits(nmask[None, :])[0], margin])
    )
    return codes, nmask, g4, gn


def _motif_inputs(rng, k, m, remap, cut=0.6):
    """A random PWM, its min scores, cutoffs ``cut`` of the way from each
    column's least to its greatest score, and the histogram's bases and
    size for ``remap``."""
    pwm = rng.integers(0, 1001, (k, 4, m)).astype(np.float32)
    lo = pwm.min(axis=1).sum(axis=0).astype(np.int64)
    hi = pwm.max(axis=1).sum(axis=0).astype(np.int64)
    mins = lo.astype(np.int32)
    cuts = (lo + (hi - lo) * cut).astype(np.int32)
    if remap == "none":
        bases, hs = None, 1000 * k + 1
    elif remap == "zero":  # what scan_batches runs: bins shifted by one
        bases, hs = np.zeros(m, np.int32), 1000 * k + 2
    else:  # per-column compression bases
        bases, hs = lo.astype(np.int32), int((hi - lo).max()) + 2
    return pwm, mins, cuts, bases, hs


def _valid(rng, b, noff):
    v = rng.random((b, noff)) < 0.9
    v[0] = True  # an all-valid row
    v[-1] = False  # an all-invalid row
    return ref.pack_bits(v)


def _compare(ref_out, port_out, cuts, noff):
    h_ref, hb_ref, nh_ref = np.asarray(ref_out[0]), ref_out[1], ref_out[2]
    h_port, scores = port_out
    np.testing.assert_array_equal(h_port.numpy(), h_ref)
    count = torch.zeros(1, dtype=torch.int32)
    idx = torch.zeros(scores.numel(), dtype=torch.int32)
    bits = compact.compact_hits(scores, _t(cuts), count, idx)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(hb_ref))
    want = np.flatnonzero(ref.unpack_hitbits(np.asarray(hb_ref), noff))
    assert int(count) == len(want) > 0  # the cutoffs give the case hits
    np.testing.assert_array_equal(idx[: len(want)].numpy(), want)
    if int(nh_ref) <= TOPK:  # the reference compacted: same indices
        assert int(nh_ref) == len(want)
        np.testing.assert_array_equal(
            np.asarray(ref_out[3])[: len(want)] - 1, want)


# (kind, k, R, M, B, masks, remap)
CASES = [
    ("packed", 5, 64, 2, 16, True, "zero"),
    ("packed", 19, 128, 4, 8, False, "none"),
    ("gathered", 19, 128, 2, 12, True, "zero"),
    ("gathered", 5, 64, 4, 16, False, "comp"),
    ("strided", 19, 128, 4, 10, True, "zero"),
    ("strided", 5, 64, 2, 16, False, "none"),
    ("patched", 5, 64, 2, 16, True, "zero"),
    ("patched", 19, 128, 4, 8, False, "comp"),
    ("spliced", 19, 128, 2, 12, True, "zero"),
    ("spliced", 5, 64, 4, 16, False, "none"),
]


@pytest.mark.parametrize("kind,k,R,M,B,masks,remap", CASES)
def test_batch_kind_matches_reference(kind, k, R, M, B, masks, remap):
    rng = np.random.default_rng(sum(map(ord, kind)) + 1000 * k + R)
    length = 4096
    codes, nmask, g4, gn = _genome(rng, length)
    if not masks:
        gn = None
    pwm, mins, cuts, bases, hs = _motif_inputs(rng, k, M, remap)
    noff = R - k + 1
    vb = _valid(rng, B, noff) if masks else None
    acc = jnp.zeros((hs, M), jnp.int32)
    lut = port.pwm_lut_from_kernel(pwm, CPU)
    pg4, pgn = port.genome_planes_to_device(g4, gn, CPU)
    jb = None if bases is None else jnp.asarray(bases)
    tb = _t(bases)
    common_ref = (pwm, mins, cuts)
    common_port = (lut, _t(mins))
    if kind == "packed":
        rows = rng.integers(0, 4, (B, R)).astype(np.uint8)
        nrows = rng.random((B, R)) < 0.02
        packed = ref.pack_run_seqs(rows)
        nbits = ref.pack_bits(nrows) if masks else None
        r_out = ref.scan_runs_device_topk(
            acc, packed, nbits, vb, *common_ref, k, hs, TOPK, hist_bases=jb
        )
        p_out = port.scan_runs_device(
            _t(packed), _t(nbits), _t(vb), *common_port, k, hs,
            hist_bases=tb,
        )
    elif kind == "strided":
        stride = R - k + 1
        lo = int(rng.integers(0, length - B * stride - R))
        r_out = ref.scan_runs_resident_strided_topk(
            acc, g4, gn, jnp.int32(lo), vb, *common_ref, B, stride, R, k,
            hs, TOPK, hist_bases=jb,
        )
        p_out = port.scan_runs_resident_strided(
            pg4, pgn, lo, _t(vb), *common_port, B, stride, R, k, hs,
            hist_bases=tb,
        )
    else:
        gstart = rng.integers(16, length - R - 16, B).astype(np.int32)
        if kind == "gathered":
            r_out = ref.scan_runs_resident_topk(
                acc, g4, gn, gstart, vb, *common_ref, R, k, hs, TOPK,
                hist_bases=jb,
            )
            p_out = port.scan_runs_resident(
                pg4, pgn, _t(gstart), _t(vb), *common_port, R, k, hs,
                hist_bases=tb,
            )
        else:
            n_slots = 4 if R <= 64 else 16
            patches = np.full((B, n_slots), -1, np.int16)
            for b in range(B):
                n = n_slots if b == 1 else int(rng.integers(0, n_slots))
                pos = rng.choice(R, n, replace=False)
                patches[b, :n] = pos * 4 + rng.integers(0, 4, n)
            if kind == "patched":
                r_out = ref.scan_runs_resident_patched_topk(
                    acc, g4, gn, gstart, patches, vb, *common_ref, R, k,
                    hs, TOPK, hist_bases=jb,
                )
                p_out = port.scan_runs_resident_patched(
                    pg4, pgn, _t(gstart), _t(patches), _t(vb),
                    *common_port, R, k, hs, hist_bases=tb,
                )
            else:
                splice = np.full((B, 4), 0x7FFF, np.int16)
                for b in range(1, B):
                    n_seg = int(rng.integers(1, 3))
                    bounds = np.sort(rng.choice(np.arange(4, R - 4), n_seg,
                                                replace=False))
                    splice[b, 0 : 2 * n_seg : 2] = bounds
                    splice[b, 1 : 2 * n_seg : 2] = rng.integers(-12, 13, n_seg)
                r_out = ref.scan_runs_resident_spliced_topk(
                    acc, g4, gn, gstart, splice, patches, vb, *common_ref,
                    R, k, hs, TOPK, hist_bases=jb,
                )
                p_out = port.scan_runs_resident_spliced(
                    pg4, pgn, _t(gstart), _t(splice), _t(patches), _t(vb),
                    *common_port, R, k, hs, hist_bases=tb,
                )
    _compare(r_out, p_out, cuts, noff)


def test_pwm_lut_from_kernel():
    rng = np.random.default_rng(1)
    kern = rng.integers(0, 1021, (7, 4, 3)).astype(np.float32)
    lut = port.pwm_lut_from_kernel(kern, CPU)
    assert lut.dtype == torch.int32 and tuple(lut.shape) == (7, 4, 3)
    np.testing.assert_array_equal(lut.numpy(), kern.astype(np.int32))
    bad = kern.copy()
    bad[2, 1, 0] = 3.5
    with pytest.raises(ValueError, match="non-integral"):
        port.pwm_lut_from_kernel(bad, CPU)
    bad[2, 1, 0] = 1021
    with pytest.raises(ValueError, match="outside"):
        port.pwm_lut_from_kernel(bad, CPU)
    with pytest.raises(ValueError, match=r"\(k, 4, M\)"):
        port.pwm_lut_from_kernel(kern[:, :3], CPU)


def test_genome_planes_keep_unsigned_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)
    g, n = port.genome_planes_to_device(words, None, CPU)
    assert n is None and g.dtype == torch.int64
    assert g.tolist() == [0, 1, 0x80000000, 0xFFFFFFFF]


def test_copied_host_helpers_match_reference():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, (6, 64)).astype(np.uint8)
    np.testing.assert_array_equal(
        port.pack_run_seqs(codes), ref.pack_run_seqs(codes)
    )
    bits = rng.random((6, 77)) < 0.5
    np.testing.assert_array_equal(port.pack_bits(bits), ref.pack_bits(bits))
    for n in (60, 61, 63):
        plane = rng.integers(0, 256, n).astype(np.uint8)
        np.testing.assert_array_equal(
            port.bytes_to_words(plane), ref.bytes_to_words(plane)
        )
    mats = [rng.integers(0, 1001, (4, 9)) for _ in range(3)]
    np.testing.assert_array_equal(
        port.pwms_to_conv_kernel(mats), ref.pwms_to_conv_kernel(mats)
    )
    hb = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        port.unpack_hitbits(hb, 53), ref.unpack_hitbits(hb, 53)
    )
    np.testing.assert_array_equal(
        port.reverse_complement_pwm(mats[0]),
        ref_jax.reverse_complement_pwm(mats[0]),
    )
    assert port.hist_size_for_width(19) == ref_jax.hist_size_for_width(19)


def test_strided_span_past_plane_raises():
    words = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="exceeds the resident plane"):
        port._decode_span(words, 100, 64, 2)


def test_compressed_hist_expands_to_full():
    """``tests/test_hist_compress.py:21`` on the port's packed kind: the
    histogram over per-column bases (columns on different bases, N
    windows, invalid offsets), expanded as ``runscan._absorb_comp``
    expands it, is the reference's full-range histogram."""
    rng = np.random.default_rng(3)
    k, m, b, r = 11, 6, 16, 96
    noff = r - k + 1
    packed = ref.pack_run_seqs(rng.integers(0, 4, (b, r)))
    nbits = ref.pack_bits(rng.random((b, r)) < 0.02)
    vbits_raw = rng.random((b, noff)) < 0.9
    vbits = ref.pack_bits(vbits_raw)
    pwm = np.stack([rng.integers(0, 400, (k, 4)) + 100 * c for c in range(m)],
                   axis=-1).astype(np.float32)
    bases = pwm.min(axis=1).sum(axis=0).astype(np.int64)
    tops = pwm.max(axis=1).sum(axis=0).astype(np.int64)
    comp_size = int((tops - bases).max()) + 2
    mins = pwm.reshape(-1, m).min(axis=0).astype(np.int32)
    cuts = np.full(m, 10**9, np.int32)
    hist_size = int(tops.max()) + 1
    full = np.asarray(ref.scan_runs_device_topk(
        jnp.zeros((hist_size, m), jnp.int32), packed, nbits, vbits, pwm,
        mins, cuts, k, hist_size, 64)[0])
    comp, _ = port.scan_runs_device(
        _t(packed), _t(nbits), _t(vbits), port.pwm_lut_from_kernel(pwm, CPU),
        _t(mins), k, comp_size, hist_bases=_t(bases.astype(np.int32)))
    comp = comp.numpy()
    expanded = np.zeros_like(full)
    for col in range(m):
        b0, sp = int(bases[col]), int(tops[col] - bases[col] + 1)
        expanded[int(mins[col]), col] += comp[0, col]
        expanded[b0 : b0 + sp, col] += comp[1 : 1 + sp, col]
        assert not comp[1 + sp :, col].any()
    np.testing.assert_array_equal(expanded, full)
    assert comp[0].sum() > 0  # N windows in bin 0
    assert expanded.sum() == vbits_raw.sum() * m
