"""Exact integer score histogram: the CUDA kernel and its plain version.

Counterpart of ``grafimo_tpu/ops/pallas_hist.py::hist_pallas`` and
``grafimo_tpu/ops/score_runs.py::_exact_hist`` (``:311-377``).  Contract:
``scores (..., M) int32`` -> ``(hist_size, M) int32`` with
``out[b, c] = #{scores[..., c] == b}``; values below 0 (invalid windows)
and at or above ``hist_size`` are dropped.  With ``bases (M,) int32``
each score is first remapped to the run engine's compressed bin,
``s < 0 ? -1 : max(s - bases[c] + 1, 0)`` (the remap of the reference's
``_finish_scores``, ``score_runs.py:514-518``); the kernel applies it as
it loads each score.

:func:`exact_hist` launches ``csrc/hist.cu`` for a CUDA tensor and raises
if it cannot; it takes :func:`exact_hist_reference` only for a CPU
tensor.  ``COUNTS`` records which of the two ran, so a run can show that
its main path went through the kernel.
"""

from typing import Optional

import torch

from grafimo_tpu_torch import kernels, spans

# launches of the CUDA kernel / calls of the plain version since the
# last reset_counts()
COUNTS = {"kernel": 0, "plain": 0}
spans.register("hist", COUNTS)


def reset_counts() -> None:
    COUNTS["kernel"] = 0
    COUNTS["plain"] = 0


def bincount(scores: torch.Tensor, hist_size: int) -> torch.Tensor:
    """``(hist_size, M) int64`` counts of ``scores (..., M)`` in
    ``[0, hist_size)``: one ``bincount`` over ``value * M + column`` of the
    in-range entries, on the tensor's own device."""
    m = scores.shape[-1]
    flat = scores.reshape(-1, m)
    keep = (flat >= 0) & (flat < hist_size)
    cols = torch.arange(m, device=scores.device).expand_as(flat)
    idx = flat.to(torch.int64)[keep] * m + cols[keep]
    return torch.bincount(idx, minlength=hist_size * m).view(hist_size, m)


def remap(scores: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """The compressed bins of ``scores``: bin 0 below the column's base
    (the N-window value), ``1 + i`` the score ``base + i``, -1 invalid."""
    return torch.where(scores < 0, -1, torch.clamp(scores - bases + 1, min=0))


def exact_hist_reference(scores: torch.Tensor, hist_size: int,
                         bases: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (:func:`remap`, then :func:`bincount`, as
    int32)."""
    COUNTS["plain"] += 1
    if bases is not None:
        scores = remap(scores, bases)
    return bincount(scores, hist_size).to(torch.int32)


def _check_bases(scores: torch.Tensor, bases: torch.Tensor) -> None:
    m = scores.shape[-1]
    if tuple(bases.shape) != (m,):
        raise ValueError(f"exact_hist: bases must be ({m},), got "
                         f"{tuple(bases.shape)}")
    if bases.device != scores.device:
        raise ValueError(f"exact_hist: bases on {bases.device}, scores on "
                         f"{scores.device}")
    if bases.dtype != torch.int32:
        raise TypeError(f"exact_hist: bases must be int32, got {bases.dtype}")
    if not bases.is_contiguous():
        raise ValueError("exact_hist: bases must be contiguous")


def exact_hist(scores: torch.Tensor, hist_size: int,
               bases: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact histogram of ``scores`` (remapped by ``bases`` when given) --
    the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if bases is not None:
        _check_bases(scores, bases)
    if scores.device.type == "cpu":
        return exact_hist_reference(scores, hist_size, bases)
    if scores.device.type != "cuda":
        raise ValueError(f"exact_hist: unsupported device {scores.device}")
    if scores.dtype != torch.int32:
        raise TypeError(f"exact_hist: scores must be int32, got {scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("exact_hist: scores must be contiguous")
    if scores.dim() < 1 or not 1 <= scores.shape[-1] <= 65535:
        raise ValueError(
            f"exact_hist: need 1..65535 columns, got shape {tuple(scores.shape)}"
        )
    lib = kernels.load()
    dev = scores.device.index
    if not 1 <= hist_size <= kernels.max_hist_size(dev):
        raise ValueError(f"exact_hist: hist_size {hist_size} out of range "
                         f"(1..{kernels.max_hist_size(dev)})")
    m = scores.shape[-1]
    n = scores.numel() // m
    out = torch.empty((hist_size, m), dtype=torch.int32, device=scores.device)
    with kernels.on_device(dev):
        code = lib.grafimo_exact_hist(
            scores.data_ptr(), n, m, hist_size,
            None if bases is None else bases.data_ptr(), out.data_ptr(), dev,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, code, "exact_hist launch")
    if n:
        COUNTS["kernel"] += 1
    return out
