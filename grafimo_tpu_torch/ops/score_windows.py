"""Window scoring for the per-window engine, as torch ops and the port's
kernels.

Counterpart of ``grafimo_tpu/ops/score_jax.py``.  The reference scores a
``(B, k)`` code batch with a one-hot ``(B, 4k) @ (4k, M)`` float32
contraction; the port packs the codes on the host (``ops/pack.py``), moves
the packed rows and flags to the device in one copy and scores and counts
them in one launch of
:func:`~grafimo_tpu_torch.ops.scan_packed.score_packed_hist` -- integer
LUT sums and a clamp-then-count into an int64 histogram, the CUDA kernel
on a card.  :func:`score_and_accumulate` adds into the caller's running
histogram, so a region batch costs one copy in, one launch and the copy
of its scores out; the entry points that return ``(scores, hist int32)``
count into a fresh histogram.

PWMs cross as the reference's ``(4k, M)`` float32 layout
(:func:`pwms_to_flat`, position-major, row ``4*i + code``) and become the
port's ``(k, 4, M)`` int32 LUT in :func:`pwm_lut_from_flat`.

Row semantics kept from the reference: a window holding an N scores
``min_score``; a padding row (``PAD_CODE``) scores -1 and drops from the
histogram in :func:`score_hist_core` and the packed path, but scores
``min_score`` in :func:`score_batch` (``score_jax.py:114-115``).  Scores
are clamped into ``[0, hist_size - 1]`` before counting
(``score_jax.py:76-77``), so a score past ``RANGE * k`` lands in the last
bin, as in the reference; the kernel clamps as it counts.
"""

import numpy as np
import torch

from grafimo_tpu_torch.ops.pack import FLAG_N, FLAG_PAD, pack_codes
from grafimo_tpu_torch.ops.scan_packed import score_packed, score_packed_hist
from grafimo_tpu_torch.ops.score_runs import (  # noqa: F401  (re-exported)
    hist_size_for_width,
    pwm_lut_from_kernel,
    reverse_complement_pwm,
    uploaded,
)

# --------------------------------------------------------------------------
# host helpers, copied from the reference


def pwm_to_flat(score_matrix: np.ndarray) -> np.ndarray:
    """``(4, k)`` int score matrix -> ``(4k,)`` f32 layout matching the
    one-hot flattening (position-major: row ``i*4 + code``).
    (``grafimo_tpu/ops/score_jax.py:33``)"""
    return np.ascontiguousarray(
        np.asarray(score_matrix, dtype=np.float32).T.reshape(-1)
    )


def pwms_to_flat(score_matrices) -> np.ndarray:
    """Stack M same-width score matrices into ``(4k, M)`` f32.
    (``grafimo_tpu/ops/score_jax.py:41``)"""
    return np.stack([pwm_to_flat(m) for m in score_matrices], axis=1)


# --------------------------------------------------------------------------
# parameters carried across to the device


def pwm_lut_from_flat(pwm_flat: np.ndarray, device) -> torch.Tensor:
    """The reference window engine's ``(4k, M)`` f32 PWM
    (:func:`pwms_to_flat`) as the port's ``(k, 4, M)`` int32 lookup table
    on ``device``.  Raises on a shape that is not ``(4k, M)`` and, through
    :func:`pwm_lut_from_kernel`, on an entry that is not an integer in
    ``[0, 1020]``."""
    flat = np.asarray(pwm_flat)
    if flat.ndim != 2 or flat.shape[0] % 4 or flat.shape[0] == 0:
        raise ValueError(f"flat PWM must be (4k, M), got {flat.shape}")
    return pwm_lut_from_kernel(
        flat.reshape(flat.shape[0] // 4, 4, flat.shape[1]), device
    )


# --------------------------------------------------------------------------
# scoring


def _on(x, dtype, device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``; a copy from the host
    counts in the call's ``h2d_bytes``."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return torch.as_tensor(x, dtype=dtype, device=device)
    return uploaded(torch.as_tensor(x, dtype=dtype, device=device))


def _score_packed_host(packed: np.ndarray, flags: np.ndarray,
                       lut: torch.Tensor, min_scores,
                       hist=None) -> torch.Tensor:
    """Score host-packed rows on the LUT's device, after one host->device
    copy of the rows and their flags together; with ``hist``, count them
    into it in the same launch."""
    b, w8 = packed.shape
    buf = torch.from_numpy(np.concatenate([packed.reshape(-1), flags]))
    buf = uploaded(buf.to(lut.device))
    args = (buf[: b * w8].view(b, w8), buf[b * w8 :], lut,
            _on(min_scores, torch.int32, lut.device))
    if hist is None:
        return score_packed(*args)
    return score_packed_hist(*args, hist)


def score_and_accumulate(codes, lut: torch.Tensor, min_scores,
                         hist: torch.Tensor) -> torch.Tensor:
    """Score ``(B, k)`` host codes against the ``(k, 4, M)`` LUT on its
    device and add the clamped scores into ``hist (hist_size, M) int64``
    there, in place; returns the ``(B, M) int32`` scores.  Row semantics
    as :func:`score_hist_core`."""
    packed, flags = pack_codes(codes)
    return _score_packed_host(packed, flags, lut, min_scores, hist)


def score_hist_core(codes, lut: torch.Tensor, min_scores, hist_size: int):
    """Score ``(B, k)`` host codes against the ``(k, 4, M)`` LUT on its
    device and histogram the scores (``grafimo_tpu/ops/score_jax.py:46``).

    ``codes``: 0..3 bases, ``N_CODE`` (4) = N window -> ``min_score``,
    ``PAD_CODE`` (5) = padding row -> -1, dropped from the histogram.
    Returns ``scores (B, M) int32`` and ``hist (hist_size, M) int32`` on
    the LUT's device.
    """
    hist = torch.zeros((hist_size, lut.shape[2]), dtype=torch.int64,
                       device=lut.device)
    scores = score_and_accumulate(codes, lut, min_scores, hist)
    return scores, hist.to(torch.int32)


def score_and_histogram(codes, lut: torch.Tensor, min_scores, hist_size: int):
    """Score a batch against M same-width motifs and histogram the scores
    (``grafimo_tpu/ops/score_jax.py:82``); see :func:`score_hist_core`."""
    return score_hist_core(codes, lut, min_scores, hist_size)


def score_batch(codes, lut: torch.Tensor, min_scores) -> torch.Tensor:
    """Scores only, ``(B, M)`` int32 (``grafimo_tpu/ops/score_jax.py:101``):
    any code >= ``N_CODE``, padding included, scores ``min_score``."""
    packed, flags = pack_codes(codes)
    flags[flags == FLAG_PAD] = FLAG_N
    return _score_packed_host(packed, flags, lut, min_scores)


def score_and_histogram_packed(
    packed, flags, lut: torch.Tensor, min_scores, k: int, hist_size: int
):
    """Packed-input variant of :func:`score_and_histogram`
    (``grafimo_tpu/ops/score_jax.py:119``): ``packed (B, ceil(k/4))
    uint8``, ``flags (B,) uint8`` (1 -> ``min_score``, 2 -> -1 and
    dropped from the histogram), host arrays or tensors on the LUT's
    device."""
    if k != lut.shape[0]:
        raise ValueError(f"k = {k} but the LUT is for width {lut.shape[0]}")
    dev = lut.device
    hist = torch.zeros((hist_size, lut.shape[2]), dtype=torch.int64,
                       device=dev)
    scores = score_packed_hist(
        _on(packed, torch.uint8, dev), _on(flags, torch.uint8, dev), lut,
        _on(min_scores, torch.int32, dev), hist,
    )
    return scores, hist.to(torch.int32)
