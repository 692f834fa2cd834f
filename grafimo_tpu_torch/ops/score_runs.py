"""Run scanning: expand, score, count and compact every stride-1 window of
a run batch.

Counterpart of ``grafimo_tpu/ops/score_runs.py``.  A slice block of one
of the five batch kinds the run scan dispatches is described by
:class:`BatchRows` (``packed_rows``, ``resident_rows``, ``strided_rows``,
``patched_rows``, ``spliced_rows``), and :func:`scan_block` -- the run
engine's one entry -- takes it with the block's cutoffs, histogram bases
and size and the caller's index buffers, and returns

* ``hist (comp_size, M) int32`` -- the exact histogram of the block's
  masked window scores (windows covering an N score ``min_score``, invalid
  offsets -1), over the compressed bins of ``bases`` when given
  (:mod:`grafimo_tpu_torch.ops.hist`'s contract);
* ``bits (B, ceil(Noff/8), M) uint8`` -- the packed hit bits, with the hit
  count and indices written into the caller's buffers
  (:mod:`grafimo_tpu_torch.ops.compact`'s contract); the reference packs
  and compacts them in the same jitted kernel (``_finish_scores``,
  ``_topk_package_tiered``).

On a card that is one launch of ``csrc/scan_runs.cu``'s fused kernel,
which never writes the score plane, or, for the shapes
:func:`fused_plan` sends elsewhere, three: the scores
(``csrc/scan_runs.cu``), ``hist.cu`` and ``compact.cu``.  A failed build
or launch raises.  Its plain version, :func:`scan_block_reference`,
composes the three plain versions and runs only for CPU tensors.
``COUNTS`` records which ran.

The five ``scan_runs_*`` functions keep the scores: each returns
``(hist, scores (B, Noff, M) int32)`` from one launch of the unfused
kernel for CUDA tensors (their plain versions ``scan_runs_*_reference``
for CPU tensors) and :func:`~grafimo_tpu_torch.ops.hist.exact_hist`.

Scoring is integer throughout: ``acc += lut[j][codes[:, j:j+Noff]]`` for
``j < k`` in int32, the sum the reference's select formulation
(``:434-447``) computes.  No one-hot, no convolution, no float.

Genome word planes live on the device as int64 holding uint32 values
(:func:`genome_planes_to_device`): torch's uint32 support on CUDA is
thin and int32 right shifts are arithmetic, so every left shift is
masked back to 32 bits.

The module also carries copies of the jax-free host helpers of
``grafimo_tpu/ops/score_runs.py`` and ``grafimo_tpu/ops/score_jax.py``
(importing either imports jax); each copy cites its origin and
``tests/test_torch_score_runs.py`` pins it to the original.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from grafimo_tpu_torch import kernels, spans
from grafimo_tpu_torch.utils.constants import RANGE
from grafimo_tpu_torch.ops.compact import (
    compact_hits,
    compact_hits_reference,
)
from grafimo_tpu_torch.ops.hist import exact_hist, exact_hist_reference

# --------------------------------------------------------------------------
# host helpers, copied from the reference


def pack_run_seqs(codes: np.ndarray) -> np.ndarray:
    """Pack ``(B, R)`` base codes (0..3; other values masked separately)
    into ``(B, R/4)`` uint8.  R must be a multiple of 4.
    (``grafimo_tpu/ops/score_runs.py:30``)"""
    b, r = codes.shape
    assert r % 4 == 0
    quads = np.minimum(codes, 3).astype(np.uint8).reshape(b, r // 4, 4)
    return (
        quads[:, :, 0]
        | (quads[:, :, 1] << 2)
        | (quads[:, :, 2] << 4)
        | (quads[:, :, 3] << 6)
    ).astype(np.uint8)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack ``(B, L)`` booleans into ``(B, ceil(L/8))`` uint8
    (little-endian bit order).  (``grafimo_tpu/ops/score_runs.py:44``)"""
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def pwms_to_conv_kernel(score_matrices) -> np.ndarray:
    """Stack ``(4, k)`` integer score matrices into a ``(k, 4, M)`` f32
    kernel.  Entries must stay in [0, 1020] (scaled PWMs are in
    [0, RANGE=1000] by construction, models/process.py).
    (``grafimo_tpu/ops/score_runs.py:50``)"""
    mats = [np.asarray(m, dtype=np.float32).T for m in score_matrices]
    kernel = np.ascontiguousarray(np.stack(mats, axis=-1))
    assert kernel.min() >= 0 and kernel.max() <= 1020, (
        "PWM kernel outside [0, 1020]: exact bf16 split would break"
    )
    return kernel


def bytes_to_words(packed: np.ndarray) -> np.ndarray:
    """Reinterpret a packed byte plane as little-endian uint32 words (base
    ``16*w + j`` sits at bits ``2j`` of word ``w``).
    (``grafimo_tpu/ops/score_runs.py:87``)"""
    pad = (-packed.shape[0]) % 4
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, np.uint8)])
    return np.ascontiguousarray(packed).view(np.uint32)


def unpack_hitbits(hitbits: np.ndarray, noff: int) -> np.ndarray:
    """Host-side ``(B, ceil(Noff/8), M) -> (B, Noff, M)`` bool.
    (``grafimo_tpu/ops/score_runs.py:1056``)"""
    b, _, m = hitbits.shape
    bits = np.unpackbits(
        np.moveaxis(hitbits, 1, 2).reshape(b * m, -1),
        axis=1,
        bitorder="little",
    )[:, :noff]
    return np.moveaxis(bits.reshape(b, m, noff), 2, 1).astype(bool)


def reverse_complement_pwm(score_matrix: np.ndarray) -> np.ndarray:
    """PWM that scores the reverse-complement strand directly on forward
    window codes: ``S_rc[c, i] = S[3-c, k-1-i]``.
    (``grafimo_tpu/ops/score_jax.py:155``)"""
    return np.ascontiguousarray(np.asarray(score_matrix)[::-1, ::-1])


def hist_size_for_width(width: int) -> int:
    """(``grafimo_tpu/ops/score_jax.py:167``)"""
    return RANGE * width + 1


# --------------------------------------------------------------------------
# parameters carried across to the device

_WORD_MASK = 0xFFFFFFFF
_MAX_PWM_ENTRY = 1020  # the reference's kernel bound (pwms_to_conv_kernel)


def uploaded(t: torch.Tensor) -> torch.Tensor:
    """``t``, just made from host memory, with its bytes added to the
    call's ``h2d_bytes`` when it lives on a card (0 on the CPU, where
    ``torch.as_tensor`` shares the host buffer)."""
    spans.count("h2d_bytes", t.nbytes if t.device.type != "cpu" else 0)
    return t


def pwm_lut_from_kernel(pwm_kernel: np.ndarray, device) -> torch.Tensor:
    """The reference's ``(k, 4, M)`` f32 kernel (:func:`pwms_to_conv_kernel`)
    as the port's ``(k, 4, M)`` int32 lookup table on ``device``.  Raises
    on an entry that is not an integer in ``[0, 1020]``."""
    kern = np.asarray(pwm_kernel, dtype=np.float64)
    if kern.ndim != 3 or kern.shape[1] != 4:
        raise ValueError(f"PWM kernel must be (k, 4, M), got {kern.shape}")
    if not np.isfinite(kern).all() or (kern != np.round(kern)).any():
        raise ValueError("PWM kernel has non-integral entries")
    if kern.min() < 0 or kern.max() > _MAX_PWM_ENTRY:
        raise ValueError(
            f"PWM kernel entries outside [0, {_MAX_PWM_ENTRY}]: "
            f"[{kern.min()}, {kern.max()}]"
        )
    return uploaded(torch.as_tensor(kern.astype(np.int32), device=device))


def genome_planes_to_device(codes4: np.ndarray, nplane, device):
    """Upload the resident genome's uint32 word planes
    (``runscan._resident_genome``) as int64 tensors holding the same
    unsigned values; ``nplane`` may be None (no N bases)."""
    def put(words):
        return uploaded(torch.as_tensor(
            np.asarray(words, dtype=np.uint32).astype(np.int64), device=device
        ))

    return put(codes4), (put(nplane) if nplane is not None else None)


# --------------------------------------------------------------------------
# expansion (reference ``:63-173``, ``:230-240``, ``:878-938``)


def _unpack2(packed: torch.Tensor) -> torch.Tensor:
    """``(B, R/4)`` uint8 -> ``(B, R)`` int64 base codes."""
    shifts = torch.arange(4, device=packed.device) * 2
    quads = (packed.to(torch.int64)[:, :, None] >> shifts) & 3
    return quads.reshape(packed.shape[0], -1)


def _unpack1(packed: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, ceil(n/8))`` uint8 bit plane -> ``(B, n)`` int64 0/1."""
    shifts = torch.arange(8, device=packed.device)
    bits = (packed.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n]


def _aligned_words(words, word0, sb, nw: int) -> torch.Tensor:
    """Gather ``nw`` words per row from ``word0`` and funnel-shift each
    row right by ``sb`` bits: output word ``i`` holds bits
    ``[32*i + sb, 32*(i+1) + sb)`` of the row's word stream.  Indices are
    clamped into the plane, as the reference clamps them (``:109``): an
    out-of-range gather is a device-side assert on CUDA.  Clamped words
    only feed positions the caller masks (tail rows, spliced-away
    offsets)."""
    idx = word0[:, None] + torch.arange(nw + 1, device=words.device)
    idx = idx.clamp(0, words.shape[0] - 1)
    w = words[idx]  # (B, nw + 1)
    sb = sb[:, None]
    lo = w[:, :nw] >> sb
    hi = (w[:, 1:] << ((32 - sb) & 31)) & _WORD_MASK
    return torch.where(sb == 0, w[:, :nw], lo | hi)


def _expand_resident(words, gstart, r: int) -> torch.Tensor:
    """Row i's codes are ``genome[gstart[i] : gstart[i] + r]``."""
    nw = (r + 15) // 16
    w = _aligned_words(words, gstart // 16, (gstart % 16) * 2, nw)
    shifts = torch.arange(16, device=words.device) * 2
    codes = ((w[:, :, None] >> shifts) & 3).reshape(w.shape[0], -1)
    return codes[:, :r]


def _expand_resident_bits(words, gstart, r: int) -> torch.Tensor:
    """Same word gather for the 1-bit-per-base N plane."""
    nw = (r + 31) // 32
    w = _aligned_words(words, gstart // 32, gstart % 32, nw)
    shifts = torch.arange(32, device=words.device)
    bits = ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], -1)
    return bits[:, :r]


def _decode_span(words, lo: int, n_codes: int, bits: int) -> torch.Tensor:
    """Decode ``n_codes`` consecutive ``bits``-wide codes from element
    offset ``lo`` of a word plane.  A span past the plane raises
    (:func:`_check_span`): torch slicing would truncate it silently, as the
    reference's dynamic_slice would clamp it (see
    ``runscan._resident_genome``'s margin)."""
    _check_span(words, lo, n_codes, bits)
    per = 32 // bits
    nw = (n_codes + per - 1) // per + 1
    w0 = lo // per
    w = words[w0 : w0 + nw]
    sb = (lo % per) * bits
    shifted = w[:-1] >> sb
    if sb:
        shifted = shifted | ((w[1:] << (32 - sb)) & _WORD_MASK)
    shifts = torch.arange(per, device=words.device) * bits
    codes = ((shifted[:, None] >> shifts) & ((1 << bits) - 1)).reshape(-1)
    return codes[:n_codes]


def _expand_strided(words, lo: int, b: int, stride: int, r: int, bits: int):
    """Rows ``genome[lo + i*stride : lo + i*stride + r]`` from one span
    decode; requires ``stride <= r <= 2*stride``."""
    span = _decode_span(words, lo, b * stride + r, bits)
    a = span[: b * stride].reshape(b, stride)
    tail = span[stride : stride + b * stride].reshape(b, stride)
    return torch.cat([a, tail[:, : r - stride]], dim=1)


def _apply_patches(codes: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Per-row substitutions: ``patches (B, P) int16`` entries
    ``pos * 4 + base``, ``-1`` = empty slot (int16 -> int32 sign-extends)."""
    iota = torch.arange(codes.shape[1], device=codes.device)[None, :]
    p32 = patches.to(torch.int32)
    for p in range(patches.shape[1]):
        ent = p32[:, p : p + 1]
        codes = torch.where(
            (iota == (ent >> 2)) & (ent >= 0), (ent & 3).to(codes.dtype), codes
        )
    return codes


def _clear_at_patches(plane: torch.Tensor, patches: torch.Tensor):
    """Zero a per-base indicator plane at every patched offset (patched
    bases are ACGT by contract)."""
    iota = torch.arange(plane.shape[1], device=plane.device)[None, :]
    p32 = patches.to(torch.int32)
    for p in range(patches.shape[1]):
        ent = p32[:, p : p + 1]
        plane = torch.where((iota == (ent >> 2)) & (ent >= 0), 0, plane)
    return plane


# --------------------------------------------------------------------------
# the plain version of the scoring core (reference ``_window_scores :410``
# and the masks of ``_finish_scores :483-502``)

# launches of csrc/scan_runs.cu's unfused kernel ("kernel") and of its
# fused one ("fused"), and calls of the scores' plain version, since the
# last reset_counts()
COUNTS = {"kernel": 0, "fused": 0, "plain": 0}
spans.register("score_runs", COUNTS)


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _window_scores(codes: torch.Tensor, lut: torch.Tensor, k: int):
    """``(B, R)`` codes x ``(k, 4, M)`` int32 LUT -> ``(B, Noff, M)`` int32
    window scores, exact."""
    b, r = codes.shape
    noff = r - k + 1
    acc = torch.zeros((b, noff, lut.shape[-1]), dtype=torch.int32,
                      device=codes.device)
    for j in range(k):
        acc += lut[j][codes[:, j : j + noff]]
    return acc


def apply_masks(scores, n_ind, vbits, min_scores, k: int):
    """The N-window and validity masks over raw window scores ``(B, Noff,
    M)``: windows covering an N base of ``n_ind (B, R)`` score
    ``min_scores``, then offsets clear in ``vbits`` score -1 (either may be
    None)."""
    b, noff = scores.shape[:2]
    if n_ind is not None:
        cum = torch.cat(
            [torch.zeros((b, 1), dtype=torch.int64, device=scores.device),
             torch.cumsum(n_ind, dim=1)],
            dim=1,
        )
        has_n = (cum[:, k:] - cum[:, :-k]) > 0
        scores = torch.where(has_n[:, :, None], min_scores, scores)
    if vbits is not None:
        valid = _unpack1(vbits, noff).bool()
        scores = torch.where(valid[:, :, None], scores, -1)
    return scores.contiguous()


# Each kind's rows as ``(codes (B, R) int64, N indicator (B, R) or None)``


def _codes_packed(packed, nbits):
    r = packed.shape[1] * 4
    return _unpack2(packed), (_unpack1(nbits, r) if nbits is not None
                              else None)


def _codes_resident(genome, ngenome, gstart, r: int):
    gstart = gstart.to(torch.int64)
    return _expand_resident(genome, gstart, r), (
        _expand_resident_bits(ngenome, gstart, r)
        if ngenome is not None else None
    )


def _codes_strided(genome, ngenome, lo: int, b: int, stride: int, r: int):
    return _expand_strided(genome, lo, b, stride, r, 2), (
        _expand_strided(ngenome, lo, b, stride, r, 1)
        if ngenome is not None else None
    )


def _codes_patched(genome, ngenome, gstart, patches, r: int):
    """The N plane keeps its bits at patched offsets (reference
    ``:912-917``)."""
    codes, n_ind = _codes_resident(genome, ngenome, gstart, r)
    return _apply_patches(codes, patches), n_ind


def _codes_spliced(genome, ngenome, gstart, splice, patches, r: int):
    """The N plane is cleared at patched offsets (reference
    ``:987-989``)."""
    gstart = gstart.to(torch.int64)
    codes, n_ind = _codes_resident(genome, ngenome, gstart, r)
    iota = torch.arange(r, device=codes.device)[None, :]
    s64 = splice.to(torch.int64)
    for s in range(splice.shape[1] // 2):
        bound = s64[:, 2 * s : 2 * s + 1]
        shift = torch.where(bound == 0x7FFF, 0, s64[:, 2 * s + 1 : 2 * s + 2])
        sel = iota >= bound
        start = gstart + shift[:, 0]
        codes = torch.where(sel, _expand_resident(genome, start, r), codes)
        if n_ind is not None:
            n_ind = torch.where(
                sel, _expand_resident_bits(ngenome, start, r), n_ind
            )
    codes = _apply_patches(codes, patches)
    if n_ind is not None:
        n_ind = _clear_at_patches(n_ind, patches)
    return codes, n_ind


def _masked_scores(rows, vbits, lut, min_scores, k: int):
    COUNTS["plain"] += 1
    codes, n_ind = rows
    return apply_masks(_window_scores(codes, lut, k), n_ind, vbits,
                       min_scores, k)


def scan_runs_device_reference(packed, nbits, vbits, lut, min_scores, k: int):
    """Plain version of :func:`scan_runs_device`'s masked scores."""
    return _masked_scores(_codes_packed(packed, nbits), vbits, lut, min_scores,
                          k)


def scan_runs_resident_reference(genome, ngenome, gstart, vbits, lut,
                                 min_scores, r: int, k: int):
    """Plain version of :func:`scan_runs_resident`'s masked scores."""
    return _masked_scores(_codes_resident(genome, ngenome, gstart, r), vbits,
                          lut, min_scores, k)


def scan_runs_resident_strided_reference(genome, ngenome, lo: int, vbits,
                                         lut, min_scores, b: int,
                                         stride: int, r: int, k: int):
    """Plain version of :func:`scan_runs_resident_strided`'s masked
    scores."""
    return _masked_scores(_codes_strided(genome, ngenome, lo, b, stride, r),
                          vbits, lut, min_scores, k)


def scan_runs_resident_patched_reference(genome, ngenome, gstart, patches,
                                         vbits, lut, min_scores, r: int,
                                         k: int):
    """Plain version of :func:`scan_runs_resident_patched`'s masked
    scores."""
    return _masked_scores(
        _codes_patched(genome, ngenome, gstart, patches, r), vbits, lut,
        min_scores, k)


def scan_runs_resident_spliced_reference(genome, ngenome, gstart, splice,
                                         patches, vbits, lut, min_scores,
                                         r: int, k: int):
    """Plain version of :func:`scan_runs_resident_spliced`'s masked
    scores."""
    return _masked_scores(
        _codes_spliced(genome, ngenome, gstart, splice, patches, r), vbits,
        lut, min_scores, k)


# --------------------------------------------------------------------------
# the kernel (csrc/scan_runs.cu) and the checks both routes share

_PACKED, _GATHERED, _STRIDED = 0, 1, 2  # the kernel's row sources
_DTYPES = {
    "packed": torch.uint8, "nbits": torch.uint8, "vbits": torch.uint8,
    "genome": torch.int64, "ngenome": torch.int64, "gstart": torch.int32,
    "patches": torch.int16, "splice": torch.int16, "lut": torch.int32,
    "min_scores": torch.int32,
}


def _check_span(words, lo: int, n_codes: int, bits: int) -> None:
    """Raise when ``n_codes`` ``bits``-wide codes from element ``lo`` (and
    the word the funnel shift reads past them) leave the word plane."""
    per = 32 // bits
    nw = (n_codes + per - 1) // per + 1
    w0 = lo // per
    if lo < 0 or w0 + nw > words.shape[0]:
        raise RuntimeError(
            f"span of {nw} words from word {w0} exceeds the resident plane "
            f"of {words.shape[0]} words"
        )


def _check(source: int, b: int, r: int, k: int, lut, min_scores, vbits, *,
           lo: int = 0, stride: int = 0, **rows) -> None:
    """Device, dtype, contiguity and shape of a batch kind's tensors;
    raises on the first fault."""
    dev = lut.device
    for name, t in dict(rows, lut=lut, min_scores=min_scores,
                        vbits=vbits).items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"scan_runs: {name} on {t.device}, lut on {dev}")
        if t.dtype != _DTYPES[name]:
            raise TypeError(f"scan_runs: {name} must be {_DTYPES[name]}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"scan_runs: {name} must be contiguous")
    if lut.dim() != 3 or tuple(lut.shape[:2]) != (k, 4):
        raise ValueError(f"scan_runs: lut must be ({k}, 4, M), got "
                         f"{tuple(lut.shape)}")
    if tuple(min_scores.shape) != (lut.shape[2],):
        raise ValueError(f"scan_runs: min_scores must be ({lut.shape[2]},), "
                         f"got {tuple(min_scores.shape)}")
    if not 1 <= k <= r:
        raise ValueError(f"scan_runs: window width {k} outside 1..R={r}")
    noff = r - k + 1
    widths = {"vbits": (noff + 7) // 8, "nbits": (r + 7) // 8, "packed": 1,
              "patches": 1, "splice": 2}
    for name, t in dict(rows, vbits=vbits).items():
        if t is None:
            continue
        if name in ("genome", "ngenome"):
            ok = t.dim() == 1 and t.shape[0] > 0
        elif name == "gstart":
            ok = tuple(t.shape) == (b,)
        else:
            ok = (t.dim() == 2 and t.shape[0] == b
                  and t.shape[1] >= widths[name]
                  and (name != "splice" or t.shape[1] % 2 == 0))
        if not ok:
            raise ValueError(f"scan_runs: {name} has shape {tuple(t.shape)} "
                             f"for {b} rows of R={r}, k={k}")
    if source == _STRIDED:
        if not stride <= r <= 2 * stride:
            raise ValueError(f"scan_runs: strided rows need stride <= R <= "
                             f"2 * stride, got stride {stride}, R={r}")


# --------------------------------------------------------------------------
# a slice block's rows, one constructor a batch kind.  Arguments follow
# the reference's ``*_topk`` kernels; ``nbits``/``ngenome`` may be None
# (clean batch: no N bases).


@dataclass
class BatchRows:
    """A slice block's rows as a batch kind gives them: the kernel's row
    ``source``, ``b`` rows of ``r`` positions, the row tensors by name
    (``packed``, ``nbits``, ``genome``, ``ngenome``, ``gstart``,
    ``patches``, ``splice``), the strided rows' ``lo`` and ``stride``, the
    spliced kind's N clear, and ``expand``, the plain version's rows
    ``(codes (B, R) int64, N indicator (B, R) or None)``."""

    source: int
    b: int
    r: int
    tensors: dict
    expand: Callable
    lo: int = 0
    stride: int = 0
    clear_n: bool = False


def packed_rows(packed, nbits) -> BatchRows:
    """Packed rows: ``packed (B, R/4) uint8`` codes, ``nbits (B, R/8)`` N
    plane (reference ``scan_runs_device_topk :554``)."""
    if packed.dim() != 2:
        raise ValueError(f"scan_runs: packed must be (B, R/4), got "
                         f"{tuple(packed.shape)}")
    return BatchRows(_PACKED, packed.shape[0], packed.shape[1] * 4,
                     dict(packed=packed, nbits=nbits),
                     lambda: _codes_packed(packed, nbits))


def resident_rows(genome, ngenome, gstart, r: int) -> BatchRows:
    """Gathered backbone rows at genome offsets ``gstart (B,) int32``
    (reference ``scan_runs_resident_topk :789``)."""
    return BatchRows(_GATHERED, gstart.shape[0], r,
                     dict(genome=genome, ngenome=ngenome, gstart=gstart),
                     lambda: _codes_resident(genome, ngenome, gstart, r))


def strided_rows(genome, ngenome, lo: int, b: int, stride: int,
                 r: int) -> BatchRows:
    """Uniformly strided backbone rows, row i at ``lo + i*stride``
    (reference ``scan_runs_resident_strided_topk :819``); requires
    ``stride <= r <= 2*stride``, and a span past the planes raises."""
    return BatchRows(_STRIDED, b, r, dict(genome=genome, ngenome=ngenome),
                     lambda: _codes_strided(genome, ngenome, lo, b, stride, r),
                     lo=lo, stride=stride)


def patched_rows(genome, ngenome, gstart, patches, r: int) -> BatchRows:
    """Substitution-only cluster rows: genome at ``gstart`` plus per-row
    patches ``(B, P) int16`` (reference
    ``scan_runs_resident_patched_topk :901``)."""
    return BatchRows(_GATHERED, gstart.shape[0], r,
                     dict(genome=genome, ngenome=ngenome, gstart=gstart,
                          patches=patches),
                     lambda: _codes_patched(genome, ngenome, gstart, patches,
                                            r))


def spliced_rows(genome, ngenome, gstart, splice, patches,
                 r: int) -> BatchRows:
    """Indel cluster rows: the genome spliced piecewise at ``(bound,
    shift)`` pairs of ``splice (B, 2*S) int16`` (bound ``0x7FFF`` =
    unused), then patched (reference
    ``scan_runs_resident_spliced_topk :946``)."""
    return BatchRows(_GATHERED, gstart.shape[0], r,
                     dict(genome=genome, ngenome=ngenome, gstart=gstart,
                          patches=patches, splice=splice),
                     lambda: _codes_spliced(genome, ngenome, gstart, splice,
                                          patches, r),
                     clear_n=True)


def _check_rows(rows: BatchRows, k: int, lut, min_scores, vbits) -> None:
    _check(rows.source, rows.b, rows.r, k, lut, min_scores, vbits,
           lo=rows.lo, stride=rows.stride, **rows.tensors)


# a block's windows times columns stay below this: both kernel entries
# take an int32 flat hit index
FLAT_INDEX_LIMIT = 1 << 31


def _row_args(rows: BatchRows, k: int, lut, min_scores, vbits) -> list:
    """The row arguments both kernel entries take, through ``m``.  A
    strided span past a plane raises, as the plain version's span decode
    does; so do more windows than an int32 flat index holds."""
    t = rows.tensors
    if rows.source == _STRIDED:
        for words, bits in ((t.get("genome"), 2), (t.get("ngenome"), 1)):
            if words is not None:
                _check_span(words, rows.lo, rows.b * rows.stride + rows.r,
                            bits)
    m = lut.shape[2]
    if rows.b * (rows.r - k + 1) * m >= FLAT_INDEX_LIMIT:
        raise ValueError(f"scan_runs: {rows.b * (rows.r - k + 1) * m} "
                         f"windows do not fit an int32 flat index")

    def ptr(x):
        return None if x is None else x.data_ptr()

    def cols(x):
        return 0 if x is None else x.shape[-1]

    packed, nbits, genome, ngenome, patches, splice = (
        t.get(name) for name in ("packed", "nbits", "genome", "ngenome",
                                 "patches", "splice"))
    return [rows.source, ptr(packed), cols(packed), ptr(nbits), cols(nbits),
            ptr(genome), cols(genome), ptr(ngenome), cols(ngenome),
            ptr(t.get("gstart")), rows.lo, rows.stride, ptr(patches),
            cols(patches), ptr(splice), cols(splice) // 2, int(rows.clear_n),
            ptr(vbits), cols(vbits), lut.data_ptr(), min_scores.data_ptr(),
            rows.b, rows.r, k, m]


def _launch(rows: BatchRows, k: int, lut, min_scores, vbits) -> torch.Tensor:
    """One launch of ``csrc/scan_runs.cu``'s unfused kernel: the masked
    scores."""
    dev = lut.device
    args = _row_args(rows, k, lut, min_scores, vbits)
    out = torch.empty((rows.b, rows.r - k + 1, lut.shape[2]),
                      dtype=torch.int32, device=dev)
    lib = kernels.load()
    ix = dev.index
    with kernels.on_device(ix):
        code = lib.grafimo_scan_runs(
            *args, out.data_ptr(), ix,
            torch.cuda.current_stream(ix).cuda_stream)
    kernels.check(lib, code, "scan_runs launch")
    if rows.b:
        COUNTS["kernel"] += 1
    return out


def _scores(rows: BatchRows, k: int, lut, min_scores,
            vbits) -> torch.Tensor:
    """The masked scores: the plain version for CPU tensors, one launch of
    the unfused kernel for CUDA tensors."""
    _check_rows(rows, k, lut, min_scores, vbits)
    if lut.device.type == "cpu":
        return _masked_scores(rows.expand(), vbits, lut, min_scores, k)
    if lut.device.type != "cuda":
        raise ValueError(f"scan_runs: unsupported device {lut.device}")
    return _launch(rows, k, lut, min_scores, vbits)


# --------------------------------------------------------------------------
# the five batch kinds with their scores.  Arguments follow the
# reference's ``*_topk`` kernels without ``hist_acc``, ``cutoffs`` and
# ``topk``; ``vbits`` may be None (every offset valid).  Each returns
# ``(hist, scores)``: the masked scores and their histogram, remapped by
# ``hist_bases`` when given (:func:`~grafimo_tpu_torch.ops.hist.exact_hist`).


def _with_hist(rows, vbits, lut, min_scores, k, hist_size, hist_bases):
    scores = _scores(rows, k, lut, min_scores, vbits)
    return exact_hist(scores, hist_size, hist_bases), scores


def scan_runs_device(packed, nbits, vbits, lut, min_scores, k: int,
                     hist_size: int, hist_bases=None):
    """Packed rows (:func:`packed_rows`)."""
    return _with_hist(packed_rows(packed, nbits), vbits, lut, min_scores, k,
                      hist_size, hist_bases)


def scan_runs_resident(genome, ngenome, gstart, vbits, lut, min_scores,
                       r: int, k: int, hist_size: int, hist_bases=None):
    """Gathered backbone rows (:func:`resident_rows`)."""
    return _with_hist(resident_rows(genome, ngenome, gstart, r), vbits, lut,
                      min_scores, k, hist_size, hist_bases)


def scan_runs_resident_strided(genome, ngenome, lo: int, vbits, lut,
                               min_scores, b: int, stride: int, r: int,
                               k: int, hist_size: int, hist_bases=None):
    """Uniformly strided backbone rows (:func:`strided_rows`)."""
    return _with_hist(strided_rows(genome, ngenome, lo, b, stride, r), vbits,
                      lut, min_scores, k, hist_size, hist_bases)


def scan_runs_resident_patched(genome, ngenome, gstart, patches, vbits, lut,
                               min_scores, r: int, k: int, hist_size: int,
                               hist_bases=None):
    """Substitution-only cluster rows (:func:`patched_rows`)."""
    return _with_hist(patched_rows(genome, ngenome, gstart, patches, r),
                      vbits, lut, min_scores, k, hist_size, hist_bases)


def scan_runs_resident_spliced(genome, ngenome, gstart, splice, patches,
                               vbits, lut, min_scores, r: int, k: int,
                               hist_size: int, hist_bases=None):
    """Indel cluster rows (:func:`spliced_rows`)."""
    return _with_hist(
        spliced_rows(genome, ngenome, gstart, splice, patches, r), vbits,
        lut, min_scores, k, hist_size, hist_bases)


# --------------------------------------------------------------------------
# the slice block's entry: scores, histogram and hits in one pass

# bytes of shared memory a block may opt in to on an H100 (227 KB)
H100_SMEM_BLOCK = 232448
# scan_runs.cu's fused layout: a block of up to 1024 threads in sub-blocks
# of 256, each expanding row groups with enough rows for 4 tasks of 4
# 32-offset chunks a warp (kTasksPerWarp, kTaskChunks), at most 64
_SUBS = 1024 // 256
_TASK_OFFSETS = 4 * 32
_GROUP_TASKS = 4 * 256 // 32
_MAX_ROWS_PER_GROUP = 64


def fused_plan(m: int, k: int, r: int, comp_size: int,
               smem_block: int = H100_SMEM_BLOCK) -> dict:
    """The route of a slice block of ``m`` columns, ``k``-wide windows on
    rows of ``r`` positions and ``comp_size`` bins a column, on a card
    whose blocks take ``smem_block`` bytes of shared memory: ``route``
    "fused" (one launch of the fused kernel, its columns in ``groups``
    column groups) or "three" (scores, ``hist.cu``, ``compact.cu``;
    ``groups`` 0), taken when one column's bins do not fit a block beside
    its pair table and the rows: ``hist.cu`` splits those bins over a
    cluster of blocks, where a fused kernel counting into other blocks'
    shared memory ran three times slower than the three launches on an
    H100 (``PERF.md``).  Mirrors ``plan_fused`` of ``csrc/scan_runs.cu``
    and ``plan_bins`` of ``csrc/bins.cuh``.  Pure: the shape alone
    decides."""
    noff = r - k + 1
    rpg = min(max(_GROUP_TASKS // -(-noff // _TASK_OFFSETS), 1),
              _MAX_ROWS_PER_GROUP)
    # a row's codes, N bits, validity bits, start and splice pairs
    row_ints = (-(-r // 16) + 3) + (-(-r // 32) + 2) + -(-noff // 32) + 6
    cap = (smem_block - 4 * (_SUBS * rpg * row_ints + 3)) // 4
    # a column's pair table: 16 ints a position pair, the pairs rounded
    # up to a multiple of 4; and its cutoff, minimum and base
    per_col = ((k + 1) // 2 + 3) // 4 * 4 * 16 + 3
    fit = cap // (comp_size + per_col)
    if fit < 1:
        return {"route": "three", "groups": 0}
    groups = -(-m // min(m, fit))
    return {"route": "fused", "groups": -(-m // -(-m // groups))}


def _check_block(dev, m: int, cutoffs, comp_size: int, bases, count, idx,
                 more) -> None:
    """Device, dtype, contiguity and shape of the block's counting and
    compaction tensors (``bases`` and ``more`` may be None)."""
    if comp_size < 1:
        raise ValueError(f"scan_block: comp_size must be >= 1, got "
                         f"{comp_size}")
    for name, t in (("cutoffs", cutoffs), ("bases", bases), ("count", count),
                    ("idx", idx), ("more", more)):
        if t is None and name in ("bases", "more"):
            continue
        if t.device != dev:
            raise ValueError(f"scan_block: {name} on {t.device}, lut on "
                             f"{dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"scan_block: {name} must be int32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"scan_block: {name} must be contiguous")
        if name in ("cutoffs", "bases"):
            ok = tuple(t.shape) == (m,)
        elif name == "count":
            ok = t.numel() == 1
        else:
            ok = t.dim() == 1
        if not ok:
            raise ValueError(f"scan_block: {name} has shape "
                             f"{tuple(t.shape)}")


def scan_block_reference(rows: BatchRows, vbits, lut, min_scores, k: int,
                         cutoffs, comp_size: int, bases, count, idx,
                         more=None):
    """Plain version of :func:`scan_block`: the kind's plain scores, then
    :func:`~grafimo_tpu_torch.ops.hist.exact_hist_reference` and
    :func:`~grafimo_tpu_torch.ops.compact.compact_hits_reference`, on the
    tensors' own device."""
    scores = _masked_scores(rows.expand(), vbits, lut, min_scores, k)
    return (exact_hist_reference(scores, comp_size, bases),
            compact_hits_reference(scores, cutoffs, count, idx, more))


def _launch_fused(rows: BatchRows, k: int, lut, min_scores, vbits, cutoffs,
                  comp_size: int, bases, count, idx, more):
    """One launch of ``csrc/scan_runs.cu``'s fused kernel."""
    dev = lut.device
    args = _row_args(rows, k, lut, min_scores, vbits)
    m = lut.shape[2]
    hist = torch.empty((comp_size, m), dtype=torch.int32, device=dev)
    bits = torch.empty((rows.b, (rows.r - k + 8) // 8, m), dtype=torch.uint8,
                       device=dev)
    lib = kernels.load()
    ix = dev.index
    with kernels.on_device(ix):
        code = lib.grafimo_scan_runs_fused(
            *args, cutoffs.data_ptr(),
            None if bases is None else bases.data_ptr(), comp_size,
            hist.data_ptr(), count.data_ptr(), idx.data_ptr(), idx.numel(),
            None if more is None else more.data_ptr(),
            0 if more is None else more.numel(), bits.data_ptr(), ix,
            torch.cuda.current_stream(ix).cuda_stream)
    kernels.check(lib, code, "scan_runs fused launch")
    if rows.b:
        COUNTS["fused"] += 1
    return hist, bits


def scan_block(rows: BatchRows, vbits, lut, min_scores, k: int, cutoffs,
               comp_size: int, bases, count, idx, more=None):
    """Score, count and compact a slice block: ``(hist, bits)``.

    ``hist (comp_size, M) int32`` is the histogram of the block's masked
    scores, each remapped by ``bases (M,) int32`` when given
    (:func:`~grafimo_tpu_torch.ops.hist.exact_hist`); ``bits`` are its
    packed hit bits, and ``count`` (one int32), ``idx`` and ``more`` (1-D
    int32, or None) receive the hit count and flat indices, in any order
    on a card (:func:`~grafimo_tpu_torch.ops.compact.compact_hits`).
    CPU tensors take :func:`scan_block_reference`; CUDA tensors the route
    :func:`fused_plan` gives the shape, and a failed build or launch
    raises."""
    _check_rows(rows, k, lut, min_scores, vbits)
    dev = lut.device
    _check_block(dev, lut.shape[2], cutoffs, comp_size, bases, count, idx,
                 more)
    if dev.type == "cpu":
        return scan_block_reference(rows, vbits, lut, min_scores, k, cutoffs,
                                    comp_size, bases, count, idx, more)
    if dev.type != "cuda":
        raise ValueError(f"scan_runs: unsupported device {dev}")
    plan = fused_plan(lut.shape[2], k, rows.r, comp_size,
                      kernels.smem_block(dev.index))
    if plan["route"] == "fused":
        return _launch_fused(rows, k, lut, min_scores, vbits, cutoffs,
                             comp_size, bases, count, idx, more)
    scores = _launch(rows, k, lut, min_scores, vbits)
    return (exact_hist(scores, comp_size, bases),
            compact_hits(scores, cutoffs, count, idx, more))
