"""UCSC BED region reading (reference ``extract_regions.py:371-435``).

Regions are grouped by chromosome — in the reference this optimised vg's
cache reuse; here it drives one graph-shard visit per chromosome.
"""

import gzip
from typing import Dict, List, Tuple

from grafimo_tpu_torch.errors import FileFormatError, FileReadError
from grafimo_tpu_torch.utils.sniff import is_bed


def read_bed_regions(
    bedfile: str,
) -> Tuple[Dict[str, List[Tuple[int, int]]], int]:
    """Return ``({chrom: [(start, stop), ...]}, n_regions)``.

    Matches the reference's acceptance rules: only lines starting with
    ``chr`` are data lines; coordinates stay as written (0-based half-open
    BED convention).
    """
    if not is_bed(bedfile):
        raise FileFormatError(f"{bedfile} is not a UCSC BED file")
    regions: Dict[str, List[Tuple[int, int]]] = {}
    region_num = 0
    opener = gzip.open if bedfile.split(".")[-1] == "gz" else open
    try:
        with opener(bedfile, mode="rt") as handle:
            for line in handle:
                if not line.startswith("chr"):
                    continue
                chrom, start, stop = line.strip().split()[:3]
                regions.setdefault(chrom, []).append((int(start), int(stop)))
                region_num += 1
    except OSError as e:
        raise FileReadError(f"error while reading {bedfile}") from e
    return regions, region_num
