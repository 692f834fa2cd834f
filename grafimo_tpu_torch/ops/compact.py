"""On-device hit compaction: the CUDA kernel and its plain version.

Counterpart of the function that ``grafimo_tpu/ops/score_runs.py``
computes with ``_finish_scores``' hit bits (``:522-528``),
``_topk_package_tiered`` (``:684``) and ``absorb_slice`` (``:1000``), not
of their TPU form.  Contract, for a block's masked window scores ``scores
(B, Noff, M) int32`` (``_finish_scores``' scores after the N and validity
masks; invalid windows are -1) and ``cutoffs (M,) int32``: a window is a
hit when ``score >= cutoff`` and ``score >= 0``, and

* ``count`` (one int32) is set to the block's number of hits;
* ``idx`` (1-D int32, its length the capacity) receives the flat indices
  ``(row * Noff + off) * M + col`` of the first ``len(idx)`` hits and
  ``more`` (1-D int32, or None) those of the next ``len(more)``;
* the return value is the reference's packed hit bits ``(B, ceil(Noff/8),
  M) uint8``, bit ``j`` of byte ``(b, o8, c)`` set for a hit at offset
  ``8 * o8 + j`` (the layout of ``unpack_hitbits``), for a block denser
  than the index capacity.

The kernel writes the indices in any order; the plain version writes them
ascending.  The caller sorts a block's indices (``runscan.scan_batches``),
so the two agree on every block whose hits fit the capacity, and the count
and the bits agree always.

:func:`compact_hits` launches ``csrc/compact.cu`` for a CUDA tensor and
raises if it cannot; it takes :func:`compact_hits_reference` only for a
CPU tensor.  ``COUNTS`` records which of the two ran.
"""

from typing import Optional

import torch

from grafimo_tpu_torch import kernels, spans

# launches of the CUDA kernel / calls of the plain version since the
# last reset_counts()
COUNTS = {"kernel": 0, "plain": 0}
spans.register("compact", COUNTS)


def reset_counts() -> None:
    COUNTS["kernel"] = 0
    COUNTS["plain"] = 0


def _check(scores, cutoffs, count, idx, more) -> None:
    if scores.dim() != 3:
        raise ValueError(f"compact_hits: scores must be (B, Noff, M), got "
                         f"{tuple(scores.shape)}")
    m = scores.shape[2]
    if tuple(cutoffs.shape) != (m,):
        raise ValueError(f"compact_hits: cutoffs must be ({m},), got "
                         f"{tuple(cutoffs.shape)}")
    if count.numel() != 1:
        raise ValueError(f"compact_hits: count must hold one value, got "
                         f"{tuple(count.shape)}")
    for name, t in (("idx", idx), ("more", more)):
        if t is not None and t.dim() != 1:
            raise ValueError(f"compact_hits: {name} must be 1-D, got "
                             f"{tuple(t.shape)}")


def hit_mask(scores: torch.Tensor, cutoffs: torch.Tensor) -> torch.Tensor:
    """``(B, Noff, M) bool``: the windows with ``score >= cutoff`` and
    ``score >= 0`` (``grafimo_tpu/ops/score_runs.py:523``)."""
    return (scores >= cutoffs) & (scores >= 0)


def pack_hit_bits(hit: torch.Tensor) -> torch.Tensor:
    """``(B, Noff, M) bool -> (B, ceil(Noff/8), M) uint8``, offsets
    little-endian within a byte (``grafimo_tpu/ops/score_runs.py:524-528``)."""
    b, noff, m = hit.shape
    pad = (-noff) % 8
    if pad:
        hit = torch.cat(
            [hit, torch.zeros((b, pad, m), dtype=torch.bool,
                              device=hit.device)], dim=1)
    weights = (1 << torch.arange(8, device=hit.device)).view(1, 1, 8, 1)
    grouped = hit.view(b, (noff + pad) // 8, 8, m).to(torch.int32)
    return (grouped * weights).sum(dim=2).to(torch.uint8)


def compact_hits_reference(
    scores: torch.Tensor,
    cutoffs: torch.Tensor,
    count: torch.Tensor,
    idx: torch.Tensor,
    more: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`compact_hits`: the hit mask, its
    ``torch.nonzero`` (ascending flat indices) and its packed bits, on the
    tensors' own device."""
    _check(scores, cutoffs, count, idx, more)
    COUNTS["plain"] += 1
    hit = hit_mask(scores, cutoffs)
    flat = torch.nonzero(hit.reshape(-1)).reshape(-1).to(torch.int32)
    count.view(-1)[0] = flat.numel()
    na = min(flat.numel(), idx.numel())
    idx[:na] = flat[:na]
    if more is not None:
        nb = min(flat.numel() - na, more.numel())
        more[:nb] = flat[na : na + nb]
    return pack_hit_bits(hit)


def _launch(scores, cutoffs, count, idx, more) -> torch.Tensor:
    dev = scores.device
    tensors = [("scores", scores), ("cutoffs", cutoffs), ("count", count),
               ("idx", idx)] + ([("more", more)] if more is not None else [])
    for name, t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"compact_hits: {name} must be int32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"compact_hits: {name} must be contiguous")
    b, noff, m = scores.shape
    if scores.numel() >= 1 << 31:
        raise ValueError(f"compact_hits: {scores.numel()} windows do not fit "
                         f"an int32 flat index")
    bits = torch.empty((b, (noff + 7) // 8, m), dtype=torch.uint8,
                       device=dev)
    lib = kernels.load()
    ix = dev.index
    with kernels.on_device(ix):
        code = lib.grafimo_compact_hits(
            scores.data_ptr(), b, noff, m, cutoffs.data_ptr(),
            count.data_ptr(), idx.data_ptr(), idx.numel(),
            None if more is None else more.data_ptr(),
            0 if more is None else more.numel(), bits.data_ptr(), ix,
            torch.cuda.current_stream(ix).cuda_stream,
        )
    kernels.check(lib, code, "compact_hits launch")
    if scores.numel():
        COUNTS["kernel"] += 1
    return bits


def compact_hits(
    scores: torch.Tensor,
    cutoffs: torch.Tensor,
    count: torch.Tensor,
    idx: torch.Tensor,
    more: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Count the block's hits into ``count``, write their flat indices into
    ``idx`` then ``more`` as far as they hold, and return the packed hit
    bits -- one launch of the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(scores, cutoffs, count, idx, more)
    dev = scores.device
    for name, t in (("cutoffs", cutoffs), ("count", count), ("idx", idx),
                    ("more", more)):
        if t is not None and t.device != dev:
            raise ValueError(f"compact_hits: {name} on {t.device}, scores on "
                             f"{dev}")
    if dev.type == "cpu":
        return compact_hits_reference(scores, cutoffs, count, idx, more)
    if dev.type != "cuda":
        raise ValueError(f"compact_hits: unsupported device {dev}")
    return _launch(scores, cutoffs, count, idx, more)
