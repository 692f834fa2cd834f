"""Fused scoring of 2-bit packed windows: the CUDA kernel and its plain
version.

Counterpart of ``grafimo_tpu/ops/pallas_scan.py::pallas_score_packed``
(``:74``), the fused form of the scoring in
``grafimo_tpu/ops/score_jax.py::score_and_histogram_packed`` (``:119``).
Contract: ``packed (B, ceil(k/4)) uint8`` (the layout of
:mod:`grafimo_tpu_torch.ops.pack`), ``flags (B,) uint8``, ``lut (k, 4, M)
int32`` and ``min_scores (M,) int32`` -> ``(B, M) int32`` with
``out[b, c] = sum_j lut[j, code(b, j), c]``; flag 1 scores
``min_scores[c]``, flag 2 scores -1.

:func:`score_packed` launches ``csrc/scan_packed.cu`` for CUDA tensors and
raises if it cannot; it takes :func:`score_packed_reference` only for CPU
tensors.  ``COUNTS`` records which of the two ran, so a run can show that
its main path went through the kernel.
"""

import torch

from grafimo_tpu_torch import kernels
from grafimo_tpu_torch.ops.pack import FLAG_N, FLAG_PAD, packed_width

# launches of the CUDA kernel / calls of the plain version since the
# last reset_counts()
COUNTS = {"kernel": 0, "plain": 0}


def reset_counts() -> None:
    COUNTS["kernel"] = 0
    COUNTS["plain"] = 0


def _check(packed, flags, lut, min_scores) -> None:
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


def score_packed_reference(
    packed: torch.Tensor,
    flags: torch.Tensor,
    lut: torch.Tensor,
    min_scores: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: unpack the codes, then ``acc +=
    lut[j][codes[:, j]]`` for ``j < k`` in int32, on the tensors' own
    device."""
    _check(packed, flags, lut, min_scores)
    COUNTS["plain"] += 1
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


def score_packed(
    packed: torch.Tensor,
    flags: torch.Tensor,
    lut: torch.Tensor,
    min_scores: torch.Tensor,
) -> torch.Tensor:
    """``(B, M) int32`` window scores -- the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = lut.device
    for name, t in (("packed", packed), ("flags", flags),
                    ("min_scores", min_scores)):
        if t.device != dev:
            raise ValueError(
                f"score_packed: {name} on {t.device}, lut on {dev}"
            )
    if dev.type == "cpu":
        return score_packed_reference(packed, flags, lut, min_scores)
    if dev.type != "cuda":
        raise ValueError(f"score_packed: unsupported device {dev}")
    _check(packed, flags, lut, min_scores)
    for name, t, dtype in (("packed", packed, torch.uint8),
                           ("flags", flags, torch.uint8),
                           ("lut", lut, torch.int32),
                           ("min_scores", min_scores, torch.int32)):
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.grafimo_scan_packed(
            packed.data_ptr(), flags.data_ptr(), lut.data_ptr(),
            min_scores.data_ptr(), b, k, m, out.data_ptr(), stream,
        )
    kernels.check(lib, code, "score_packed launch")
    COUNTS["kernel"] += 1
    return out
