"""Fused scoring (and counting) of 2-bit packed windows: the CUDA kernel
and its plain version.

Counterpart of ``grafimo_tpu/ops/pallas_scan.py::pallas_score_packed``
(``:74``), the fused form of the scoring in
``grafimo_tpu/ops/score_jax.py::score_and_histogram_packed`` (``:119``),
with that function's histogram fused in.  Contract: ``packed (B,
ceil(k/4)) uint8`` (the layout of :mod:`grafimo_tpu_torch.ops.pack`),
``flags (B,) uint8``, ``lut (k, 4, M) int32`` and ``min_scores (M,)
int32`` -> ``(B, M) int32`` with ``out[b, c] = sum_j lut[j, code(b, j),
c]``; flag 1 scores ``min_scores[c]``, flag 2 scores -1.
:func:`score_packed_hist` also adds every score ``>= 0``, clamped to the
last bin (``score_jax.py:75-77``), into a caller-owned ``(hist_size, M)
int64`` running histogram.

:func:`score_packed` and :func:`score_packed_hist` launch
``csrc/scan_packed.cu`` (counting compiled out, or in) for CUDA tensors
and raise if they cannot; they take their plain versions only for CPU
tensors.  ``COUNTS`` records which ran, so a run can show that its main
path went through the kernel: ``kernel`` and ``plain`` count every launch
and plain call, ``fused`` the launches that also counted.
"""

import torch

from grafimo_tpu_torch import kernels, spans
from grafimo_tpu_torch.ops.hist import bincount
from grafimo_tpu_torch.ops.pack import FLAG_N, FLAG_PAD, packed_width

# launches of the CUDA kernel / calls of the plain versions since the
# last reset_counts(); "fused": launches that counted into a histogram
COUNTS = {"kernel": 0, "plain": 0, "fused": 0}
spans.register("scan_packed", COUNTS)


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _check(packed, flags, lut, min_scores, hist=None) -> None:
    if lut.dim() != 3 or lut.shape[1] != 4:
        raise ValueError(f"score_packed: lut must be (k, 4, M), got "
                         f"{tuple(lut.shape)}")
    k, m = lut.shape[0], lut.shape[2]
    if packed.dim() != 2 or packed.shape[1] != packed_width(k):
        raise ValueError(
            f"score_packed: packed must be (B, {packed_width(k)}) for k = {k}, "
            f"got {tuple(packed.shape)}"
        )
    if tuple(flags.shape) != (packed.shape[0],):
        raise ValueError(f"score_packed: flags must be ({packed.shape[0]},), "
                         f"got {tuple(flags.shape)}")
    if tuple(min_scores.shape) != (m,):
        raise ValueError(f"score_packed: min_scores must be ({m},), got "
                         f"{tuple(min_scores.shape)}")
    if hist is not None and (hist.dim() != 2 or hist.shape[1] != m
                             or hist.shape[0] < 1):
        raise ValueError(f"score_packed_hist: hist must be (hist_size, {m}), "
                         f"got {tuple(hist.shape)}")


def _scores_plain(packed, flags, lut, min_scores) -> torch.Tensor:
    b, k = packed.shape[0], lut.shape[0]
    shifts = torch.arange(4, device=packed.device) * 2
    codes = ((packed.to(torch.int64)[:, :, None] >> shifts) & 3).reshape(
        b, 4 * packed.shape[1]
    )
    acc = torch.zeros((b, lut.shape[2]), dtype=torch.int32, device=lut.device)
    for j in range(k):
        acc += lut[j][codes[:, j]]
    flags = flags.to(torch.int64)[:, None]
    acc = torch.where(flags == FLAG_N, min_scores.to(torch.int32)[None, :], acc)
    return torch.where(flags == FLAG_PAD, torch.full_like(acc, -1), acc)


def score_packed_reference(
    packed: torch.Tensor,
    flags: torch.Tensor,
    lut: torch.Tensor,
    min_scores: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_packed`: unpack the codes,
    then ``acc += lut[j][codes[:, j]]`` for ``j < k`` in int32, on the
    tensors' own device."""
    _check(packed, flags, lut, min_scores)
    COUNTS["plain"] += 1
    return _scores_plain(packed, flags, lut, min_scores)


def score_packed_hist_reference(
    packed: torch.Tensor,
    flags: torch.Tensor,
    lut: torch.Tensor,
    min_scores: torch.Tensor,
    hist: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_packed_hist`: the plain
    scores, clamped to the last bin, counted with ``bincount`` and added
    into ``hist`` in place."""
    _check(packed, flags, lut, min_scores, hist)
    COUNTS["plain"] += 1
    scores = _scores_plain(packed, flags, lut, min_scores)
    hist += bincount(scores.clamp(max=hist.shape[0] - 1), hist.shape[0])
    return scores


def _launch(packed, flags, lut, min_scores, hist) -> torch.Tensor:
    dev = lut.device
    _check(packed, flags, lut, min_scores, hist)
    tensors = [("packed", packed, torch.uint8), ("flags", flags, torch.uint8),
               ("lut", lut, torch.int32),
               ("min_scores", min_scores, torch.int32)]
    if hist is not None:
        tensors.append(("hist", hist, torch.int64))
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"score_packed: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"score_packed: {name} must be contiguous")
    b, k, m = packed.shape[0], lut.shape[0], lut.shape[2]
    out = torch.empty((b, m), dtype=torch.int32, device=dev)
    if b == 0 or m == 0:
        return out
    lib = kernels.load()
    idx = dev.index
    hist_size = 0
    if hist is not None:
        hist_size = hist.shape[0]
        if hist_size > kernels.max_hist_size(idx):
            raise ValueError(f"score_packed_hist: {hist_size} bins out of "
                             f"range (1..{kernels.max_hist_size(idx)})")
    with kernels.on_device(idx):
        code = lib.grafimo_scan_packed(
            packed.data_ptr(), flags.data_ptr(), lut.data_ptr(),
            min_scores.data_ptr(), b, k, m, out.data_ptr(),
            None if hist is None else hist.data_ptr(), hist_size, idx,
            torch.cuda.current_stream(idx).cuda_stream,
        )
    kernels.check(lib, code, "score_packed launch")
    COUNTS["kernel"] += 1
    if hist is not None:
        COUNTS["fused"] += 1
    return out


def _device(what, tensors):
    """The common device of ``tensors``, which must be cpu or cuda."""
    dev = tensors[-1][1].device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, lut on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def score_packed(
    packed: torch.Tensor,
    flags: torch.Tensor,
    lut: torch.Tensor,
    min_scores: torch.Tensor,
) -> torch.Tensor:
    """``(B, M) int32`` window scores -- the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = _device("score_packed", [("packed", packed), ("flags", flags),
                                   ("min_scores", min_scores), ("lut", lut)])
    if dev.type == "cpu":
        return score_packed_reference(packed, flags, lut, min_scores)
    return _launch(packed, flags, lut, min_scores, None)


def score_packed_hist(
    packed: torch.Tensor,
    flags: torch.Tensor,
    lut: torch.Tensor,
    min_scores: torch.Tensor,
    hist: torch.Tensor,
) -> torch.Tensor:
    """``(B, M) int32`` window scores, with every score ``>= 0`` clamped
    to the last bin and added into ``hist (hist_size, M) int64`` in place
    -- one launch of the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    dev = _device("score_packed_hist", [
        ("packed", packed), ("flags", flags), ("min_scores", min_scores),
        ("hist", hist), ("lut", lut)])
    if dev.type == "cpu":
        return score_packed_hist_reference(packed, flags, lut, min_scores,
                                           hist)
    return _launch(packed, flags, lut, min_scores, hist)
