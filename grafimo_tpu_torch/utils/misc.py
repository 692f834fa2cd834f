"""Small helpers shared across the framework (reference: ``src/grafimo/utils.py``)."""

from typing import Dict

import numpy as np

from grafimo_tpu_torch.utils.constants import LOG_FACTOR, NOMAP


def lg2(value) -> np.double:
    """C-style log2: ``ln(x) * 1.44269504`` (reference ``utils.py:479-495``).

    The reference deliberately computes log2 through the natural log times a
    truncated constant; replicating this bit-for-bit is required for integer
    scaled-matrix parity.
    """
    return np.log(value) * LOG_FACTOR


def almost_equal(value1, value2, slope) -> bool:
    """Tolerance comparison (reference ``utils.py:452-476``)."""
    return not ((value1 - slope) > value2 or (value1 + slope) < value2)


def is_numeric(s: str) -> bool:
    """True when the string parses as a float (reference ``utils.py:580-604``)."""
    try:
        float(s)
    except ValueError:
        return False
    return True


def parse_namemap(namemap_fn: str) -> Dict[str, str]:
    """Parse a two-column chromosome name-map file
    (reference ``utils.py:83-117``)."""
    chroms_namemap: Dict[str, str] = {}
    if namemap_fn == NOMAP:
        return chroms_namemap
    with open(namemap_fn) as infile:
        for line in infile:
            line = line.strip()
            if not line:
                continue
            chrom, name = line.split()
            chroms_namemap[chrom] = name
    if not chroms_namemap:
        raise ValueError(f"empty name-map file {namemap_fn}")
    return chroms_namemap
