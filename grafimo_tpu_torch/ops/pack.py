"""2-bit window packing for host->device streaming.

Copied unchanged from ``grafimo_tpu/ops/pack.py:18-56``: the original is
pure numpy, but importing it runs ``grafimo_tpu/ops/__init__.py``, which
imports jax.  ``tests/test_torch_scan.py`` pins the copy to it.

Windows cross to the device as 2-bit codes -- 4 bases per byte -- plus one
flag byte per window for the rare non-ACGT / padding cases.

Layout: ``packed (B, ceil(k/4)) uint8``, base ``i`` of window ``b`` is
``(packed[b, i//4] >> (2*(i%4))) & 3``.  ``flags (B,) uint8``: 0 = clean,
1 = contains N (scores ``min_score``, reference ``score_sequences.py:
376-378``), 2 = padding row (scores -1, excluded from histograms).
"""

import numpy as np

from grafimo_tpu_torch.utils.constants import N_CODE, PAD_CODE

FLAG_CLEAN = 0
FLAG_N = 1
FLAG_PAD = 2


def packed_width(k: int) -> int:
    return (k + 3) // 4


def pack_codes(codes: np.ndarray):
    """Pack ``(B, k)`` uint8 codes (0..3, N_CODE, PAD_CODE) into
    ``(packed (B, ceil(k/4)) uint8, flags (B,) uint8)``."""
    codes = np.asarray(codes, dtype=np.uint8)
    b, k = codes.shape
    w = packed_width(k)
    flags = np.zeros(b, dtype=np.uint8)
    flags[(codes >= N_CODE).any(axis=1)] = FLAG_N
    flags[(codes >= PAD_CODE).any(axis=1)] = FLAG_PAD
    clipped = np.minimum(codes, 3)
    if k != w * 4:
        clipped = np.concatenate(
            [clipped, np.zeros((b, w * 4 - k), dtype=np.uint8)], axis=1
        )
    quads = clipped.reshape(b, w, 4)
    packed = (
        quads[:, :, 0]
        | (quads[:, :, 1] << 2)
        | (quads[:, :, 2] << 4)
        | (quads[:, :, 3] << 6)
    ).astype(np.uint8)
    return packed, flags


def unpack_codes(packed: np.ndarray, k: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_codes` (flags not applied)."""
    b, w = packed.shape
    shifts = np.arange(4, dtype=np.uint8) * 2
    quads = (packed[:, :, None] >> shifts[None, None, :]) & 3
    return quads.reshape(b, w * 4)[:, :k].astype(np.uint8)
