"""Sequence -> integer-code tensor packing.

Copied unchanged from ``grafimo_tpu/ops/encode.py:16-46``: the original is
pure numpy, but importing it runs ``grafimo_tpu/ops/__init__.py``, which
imports jax.  ``tests/test_torch_scan.py`` pins the copy to it.

Windows are carried through the pipeline as ``(B, k)`` uint8 tensors with
A=0, C=1, G=2, T=3 and 4 for any non-ACGT symbol (scored as ``min_score``,
reference ``score_sequences.py:376-378``).
"""

from typing import List, Sequence

import numpy as np

from grafimo_tpu_torch.utils.constants import N_CODE

# byte -> code lookup (case-insensitive); default N_CODE
_LUT = np.full(256, N_CODE, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _LUT[ord(c)] = i
    _LUT[ord(c.lower())] = i

_RC_CODE = np.array([3, 2, 1, 0, N_CODE], dtype=np.uint8)


def seqs_to_codes(seqs: Sequence[str], width: int) -> np.ndarray:
    """Encode equal-length sequences into a ``(B, width)`` uint8 tensor."""
    if len(seqs) == 0:
        return np.zeros((0, width), dtype=np.uint8)
    joined = "".join(seqs)
    raw = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)
    if raw.size != len(seqs) * width:
        raise ValueError("sequence length mismatch while encoding windows")
    return _LUT[raw].reshape(len(seqs), width)


def codes_to_seqs(codes: np.ndarray) -> List[str]:
    """Decode a ``(B, k)`` code tensor back to strings (N for code 4)."""
    table = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return [
        bytes(table[row]).decode("ascii") for row in np.asarray(codes)
    ]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement a ``(B, k)`` code tensor."""
    return _RC_CODE[np.asarray(codes)][:, ::-1]
