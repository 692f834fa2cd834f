"""Scans over a grid of torch devices: data-parallel rows x motif-parallel
PWM columns.

Counterpart of ``grafimo_tpu/parallel/pipeline.py``.  The reference builds
a ``(data, motif)`` jax ``Mesh`` and runs each step under ``shard_map``;
here the grid is a tuple of rows of ``torch.device``s (a device may appear
more than once), and every shard runs the port's single-device function
on its own block:

* rows split into contiguous blocks over ``data``
  (:func:`~grafimo_tpu_torch.device.split_rows`; block sizes may differ
  by one, so nothing is padded);
* PWM columns split the same way over ``motif``;
* histograms are summed over ``data`` and concatenated over ``motif`` on
  the host, in int64; each run-scan shard is one
  ``ops/score_runs.scan_block`` (the fused kernel on a card), whose hits
  come packed into hit bits, as the reference's are, and back as global
  ``(row, offset, column)`` rows in C order, with hit counts per motif
  column.

Every shard is launched before the first result is read back: reading a
shard waits for its device, and a wait per shard would serialize the
cards.  The results are host tensors.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from grafimo_tpu_torch.device import split_rows
from grafimo_tpu_torch.ops.score_runs import (
    genome_planes_to_device,
    packed_rows,
    pwm_lut_from_kernel,
    resident_rows,
    scan_block,
    unpack_hitbits,
)
from grafimo_tpu_torch.ops.score_windows import (
    pwm_lut_from_flat,
    score_hist_core,
)
from grafimo_tpu_torch.utils.constants import PAD_CODE

Grid = Tuple[Tuple[torch.device, ...], ...]


def make_mesh(
    n_data: Optional[int] = None, n_motif: int = 1, *,
    devices: Sequence[torch.device],
) -> Grid:
    """A ``(n_data, n_motif)`` grid over ``devices``
    (``device.resolve_devices``, or any list), taken in order; repeats
    are allowed.  ``n_data`` defaults to all the devices a motif column
    of the grid can take."""
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_motif
    if n_data < 1 or n_motif < 1 or n_data * n_motif > len(devices):
        raise ValueError(
            f"a ({n_data}, {n_motif}) grid needs {n_data * n_motif} "
            f"devices, got {len(devices)}"
        )
    return tuple(
        tuple(devices[i * n_motif : (i + 1) * n_motif]) for i in range(n_data)
    )


def _shards(grid: Grid, n_rows: int, n_cols: int):
    """``(device, rows, cols)`` of every non-empty shard."""
    for (r0, r1), row in zip(split_rows(n_rows, len(grid)), grid):
        for (c0, c1), dev in zip(split_rows(n_cols, len(row)), row):
            if r0 < r1 and c0 < c1:
                yield dev, slice(r0, r1), slice(c0, c1)


def _put(x, rows, dev):
    return (None if x is None
            else torch.as_tensor(np.ascontiguousarray(x[rows]), device=dev))


def sharded_scan_step(grid: Grid, hist_size: int):
    """The window-scoring step over ``grid``: returns ``run(codes,
    pwm_flat, min_scores, cutoffs=None) -> (scores, hist, hit_counts)``
    with ``codes (B, k)`` host codes, ``pwm_flat (4k, M)``
    (``ops/score_windows.pwms_to_flat``) and

    * ``scores (B, M) int32``;
    * ``hist (hist_size, M) int64``, the exact global histogram (padding
      rows score -1 and drop out);
    * ``hit_counts (M,) int64``, the windows with ``score >= cutoff`` and
      ``score >= 0``.

    Each shard runs ``ops/score_windows.score_hist_core`` (the fused
    ``scan_packed.cu`` kernel on a card)."""

    def run(codes, pwm_flat, min_scores, cutoffs=None):
        codes = np.asarray(codes)
        pwm_flat = np.asarray(pwm_flat)
        m = pwm_flat.shape[1]
        mins = np.asarray(min_scores, dtype=np.int32)
        cuts = np.zeros(m, np.int32) if cutoffs is None else np.asarray(
            cutoffs, dtype=np.int32)
        pending = []
        for dev, rows, cols in _shards(grid, codes.shape[0], m):
            lut = pwm_lut_from_flat(pwm_flat[:, cols], dev)
            s, h = score_hist_core(codes[rows], lut, mins[cols], hist_size)
            cut = torch.as_tensor(cuts[cols], device=dev)
            hits = ((s >= cut) & (s >= 0)).sum(dim=0)
            pending.append((rows, cols, s, h, hits))
        scores = torch.full((codes.shape[0], m), -1, dtype=torch.int32)
        hist = torch.zeros((hist_size, m), dtype=torch.int64)
        counts = torch.zeros(m, dtype=torch.int64)
        for rows, cols, s, h, hits in pending:
            scores[rows, cols] = s.cpu()
            hist[:, cols] += h.cpu()
            counts[cols] += hits.cpu()
        return scores, hist, counts

    return run


def _shard_scan(rows, vbits, pwm_kernel, min_scores, cutoffs, k: int,
                hist_size: int, dev):
    """A shard's ``(hist, hit bits, Noff)`` from one
    ``ops/score_runs.scan_block`` over its columns of the PWM, as the
    reference's shards return them: its histogram unremapped, its hits as
    packed bits (no indices)."""
    hist, bits = scan_block(
        rows, vbits, pwm_lut_from_kernel(pwm_kernel, dev),
        torch.as_tensor(min_scores, device=dev), k,
        torch.as_tensor(cutoffs, device=dev), hist_size, None,
        torch.empty(1, dtype=torch.int32, device=dev),
        torch.empty(0, dtype=torch.int32, device=dev))
    return hist, bits, rows.r - k + 1


def _merge(pending, hist_size: int, m: int):
    """Host merge of ``(rows, cols, hist, bits, noff)`` shard results."""
    hist = torch.zeros((hist_size, m), dtype=torch.int64)
    parts = [torch.zeros((0, 3), dtype=torch.int64)]
    for rows, cols, h, bits, noff in pending:
        hist[:, cols] += h.cpu()
        nz = torch.from_numpy(
            np.stack(np.nonzero(unpack_hitbits(bits.cpu().numpy(), noff)),
                     axis=1).astype(np.int64))
        nz[:, 0] += rows.start
        nz[:, 2] += cols.start
        parts.append(nz)
    hits = torch.cat(parts)
    order = np.lexsort((hits[:, 2].numpy(), hits[:, 1].numpy(),
                        hits[:, 0].numpy()))
    hits = hits[torch.from_numpy(order)]
    return hist, hits, torch.bincount(hits[:, 2], minlength=m)


def sharded_run_scan(grid: Grid, k: int, hist_size: int):
    """The run scan over ``grid`` (``ops/score_runs.packed_rows`` through
    ``scan_block``): returns ``run(packed, nbits, vbits, pwm_kernel,
    min_scores, cutoffs) -> (hist, hits, hit_counts)`` with
    ``packed (B, R/4) uint8``, ``nbits (B, R/8)`` and ``vbits (B,
    ceil(Noff/8))`` host planes (``nbits``/``vbits`` may be None),
    ``pwm_kernel (k, 4, M)`` and

    * ``hist (hist_size, M) int64``, the exact global histogram;
    * ``hits (n, 3) int64``, global ``(row, offset, column)`` in C order
      (the reference returns them as packed ``hitbits``);
    * ``hit_counts (M,) int64``."""

    def run(packed, nbits, vbits, pwm_kernel, min_scores, cutoffs):
        pwm_kernel = np.asarray(pwm_kernel)
        m = pwm_kernel.shape[-1]
        mins = np.asarray(min_scores, dtype=np.int32)
        cuts = np.asarray(cutoffs, dtype=np.int32)
        pending = []
        for dev, rows, cols in _shards(grid, packed.shape[0], m):
            pending.append((rows, cols, *_shard_scan(
                packed_rows(_put(packed, rows, dev), _put(nbits, rows, dev)),
                _put(vbits, rows, dev), pwm_kernel[:, :, cols], mins[cols],
                cuts[cols], k, hist_size, dev)))
        return _merge(pending, hist_size, m)

    return run


def sharded_resident_scan(grid: Grid, r: int, k: int, hist_size: int,
                          with_n: bool = False):
    """The device-resident backbone scan over ``grid``
    (``ops/score_runs.resident_rows`` through ``scan_block``): the packed
    chromosome is copied once to each distinct device, row descriptors
    split over ``data``, PWM columns over ``motif``.  Returns ``run(genome4,
    [ngenome,] gstart, vbits, pwm_kernel, min_scores, cutoffs) -> (hist,
    hits, hit_counts)`` as :func:`sharded_run_scan`; the genome planes are
    uint32 words (``ops/score_runs.bytes_to_words``)."""

    def run(*args):
        genome4, ngenome = args[0], (args[1] if with_n else None)
        gstart, vbits, pwm_kernel, min_scores, cutoffs = args[
            2 if with_n else 1 :
        ]
        gstart = np.asarray(gstart, dtype=np.int32)
        pwm_kernel = np.asarray(pwm_kernel)
        m = pwm_kernel.shape[-1]
        mins = np.asarray(min_scores, dtype=np.int32)
        cuts = np.asarray(cutoffs, dtype=np.int32)
        planes = {}
        pending = []
        for dev, rows, cols in _shards(grid, gstart.shape[0], m):
            if str(dev) not in planes:
                planes[str(dev)] = genome_planes_to_device(genome4, ngenome,
                                                           dev)
            g4, gn = planes[str(dev)]
            pending.append((rows, cols, *_shard_scan(
                resident_rows(g4, gn, _put(gstart, rows, dev), r),
                _put(vbits, rows, dev), pwm_kernel[:, :, cols], mins[cols],
                cuts[cols], k, hist_size, dev)))
        return _merge(pending, hist_size, m)

    return run


def pad_batch(codes: np.ndarray, multiple: int, pad_code: int = PAD_CODE):
    """Pad the window batch to a multiple of the data-shard count.  Padding
    rows carry ``PAD_CODE`` and score ``-1``: they are dropped from
    histograms and hit counts on device; strip them by row count on the
    scores output."""
    b = codes.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return codes, b
    pad = np.full((rem, codes.shape[1]), pad_code, dtype=codes.dtype)
    return np.concatenate([codes, pad]), b
