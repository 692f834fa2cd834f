"""Background nucleotide models.

Reads 0th-order Markov Background Model files (meme-suite bfile format) and
applies the reference's strand-averaging + pseudo-normalisation so the
resulting probabilities are bit-identical (reference:
``motif_processing.pyx:40-188``, ``motif_ops.py:1189-1304``).

Floating-point note: the reference accumulates the normalisation total by
iterating dict keys in insertion order; after reverse-complement averaging
that order is A,T,C,G (``motif_ops.py:1256-1263``).  Summation order changes
the float64 result, so we replicate the loops literally instead of using
``np.sum``.
"""

import os
from typing import Dict, List

import numpy as np

from grafimo_tpu_torch.errors import BGFileError
from grafimo_tpu_torch.utils.constants import DNA_ALPHABET, PSEUDOBG, REV_COMPL, UNIF


def read_bg_file(bg_file: str) -> Dict[str, float]:
    """Parse a 0th-order background file (reference ``pyx:40-130``)."""
    bg_dict: Dict[str, float] = {}
    found = set()
    with open(bg_file) as handle:
        for line in handle:
            if not line.strip():
                continue
            if line[0] == "#":
                continue
            if line[0].upper() in DNA_ALPHABET:
                nuc, prob_str = line.split()
                prob = float(prob_str)
                if prob <= 0:
                    raise BGFileError(f"non-positive probability in {bg_file}")
                if nuc.upper() in found:
                    raise BGFileError(f"found two times {nuc}")
                bg_dict[nuc.upper()] = prob
                found.add(nuc.upper())
            else:
                raise BGFileError(
                    f"symbol not part of the DNA alphabet: {line[0]}"
                )
            if len(found) == len(DNA_ALPHABET):
                break
    if len(found) != len(DNA_ALPHABET):
        raise BGFileError(f"incomplete background file {bg_file}")
    return bg_dict


def uniform_bg(alphabet: List[str]) -> Dict[str, float]:
    """Uniform background (reference ``pyx:134-188``)."""
    unifp = 1.0 / len(alphabet)
    return {nuc: unifp for nuc in alphabet}


def average_bg_with_rc(bgs: Dict[str, float]) -> Dict[str, float]:
    """Average each base probability with its reverse complement's
    (reference ``motif_ops.py:1233-1263``); preserves the reference's
    resulting key order (A,T,C,G)."""
    bgs_avg: Dict[str, float] = {}
    for nuc in bgs.keys():
        rc = REV_COMPL[nuc.upper()]
        if REV_COMPL[rc] == nuc and ord(nuc) < ord(rc):
            avg_freq = np.double((bgs[nuc] + bgs[rc]) / np.double(2))
            bgs_avg[nuc] = avg_freq
            bgs_avg[rc] = avg_freq
    return bgs_avg


def norm_bg(bgs: Dict[str, float]) -> Dict[str, float]:
    """Pseudo-normalise the background (reference ``motif_ops.py:1268-1304``).

    The accumulation order over ``bgs.keys()`` is kept identical to the
    reference for bitwise parity.
    """
    alphabet = sorted(bgs.keys())
    tot = np.double(len(alphabet) * PSEUDOBG)
    for nuc in bgs.keys():
        tot += np.double(bgs[nuc])
    assert tot > 0
    bgs_norm = {}
    for nuc in bgs.keys():
        bgs_norm[nuc] = np.double((bgs[nuc] + PSEUDOBG) / tot)
    return bgs_norm


def pseudo_bg(bgs: Dict[str, float], no_reverse: bool) -> Dict[str, float]:
    """Strand-average (unless ``no_reverse``) then pseudo-normalise
    (reference ``motif_ops.py:1189-1230``)."""
    if not no_reverse:
        bgs_avg = average_bg_with_rc(bgs)
    else:
        bgs_avg = bgs
    return norm_bg(bgs_avg)


def load_bg(bg_file: str, no_reverse: bool) -> Dict[str, float]:
    """Read (or synthesise uniform) + process a background model."""
    if bg_file == UNIF:
        bgs = uniform_bg(DNA_ALPHABET)
    elif os.path.isfile(bg_file):
        bgs = read_bg_file(bg_file)
    else:
        raise BGFileError(f"unable to parse {bg_file}")
    return pseudo_bg(bgs, no_reverse)
