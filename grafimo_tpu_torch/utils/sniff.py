"""Input file format sniffers (reference: ``src/grafimo/utils.py:212-449``).

Each sniffer answers "could this file be format X" with the same acceptance
rules as the reference so the CLI dispatches identically.
"""

import gzip
import os

from grafimo_tpu_torch.errors import FileReadError
from grafimo_tpu_torch.utils.constants import DNA_ALPHABET
from grafimo_tpu_torch.utils.misc import is_numeric


def _check_exists_nonempty(fn: str) -> None:
    if not os.path.isfile(fn):
        raise FileNotFoundError(f"unable to locate {fn}")
    if os.stat(fn).st_size == 0:
        raise EOFError(f"{fn} seems to be empty")


def is_jaspar(motif_file: str) -> bool:
    """JASPAR sniff: ``.jaspar`` extension, ``>`` header, ``X [ counts ]`` rows
    (reference ``utils.py:212-259``)."""
    _check_exists_nonempty(motif_file)
    if motif_file.split(".")[-1] != "jaspar":
        return False
    try:
        with open(motif_file) as handle:
            header = handle.readline().strip()
            if not header.startswith(">"):
                return False
            for line in handle:
                fields = line.strip().split()
                if not fields:
                    return False
                if fields[1] != "[" or fields[-1] != "]":
                    return False
                if any(not is_numeric(c) for c in fields[2:-1]):
                    return False
    except OSError as e:
        raise FileReadError(f"error while parsing {motif_file}") from e
    return True


def is_meme(motif_file: str) -> bool:
    """MEME sniff: any line starting with ``MEME version``
    (reference ``utils.py:262-297``)."""
    _check_exists_nonempty(motif_file)
    with open(motif_file) as handle:
        for line in handle:
            if line.startswith("MEME version"):
                return True
    return False


def is_transfac(motif_file: str) -> bool:
    """TRANSFAC sniff: AC/ID/P0 fields with 1-based count rows
    (reference ``utils.py:300-365``)."""
    _check_exists_nonempty(motif_file)
    transfac_fields = {"AC": False, "ID": False, "PO": False}
    width = 0
    with open(motif_file) as handle:
        for line in handle:
            line = line.strip()
            if not line:
                continue
            line_split = line.split(None, 1)
            field = line_split[0].strip()
            if len(field) != 2:
                return False
            if len(line_split) == 2:
                value = line_split[1].strip()
                if field in ("P0", "PO"):
                    if not value:
                        return False
                    if value.split()[:4] != DNA_ALPHABET:
                        return False
                    transfac_fields["PO"] = True
                elif field in transfac_fields:
                    if not value:
                        return False
                    transfac_fields[field] = True
                try:
                    position = int(field)
                except ValueError:
                    continue
                if width == 0 and position == 0:
                    return False
                width += 1
                if width != position:
                    return False
    return sum(transfac_fields.values()) == 3


def is_pfm(motif_file: str) -> bool:
    """PFM sniff: all non-header lines numeric (reference ``utils.py:367-405``)."""
    _check_exists_nonempty(motif_file)
    with open(motif_file) as handle:
        for line in handle:
            if line.startswith(">"):
                continue
            counts = line.strip().split()
            if any(not is_numeric(c) for c in counts):
                return False
    return True


def sniff_motif_format(motif_file: str) -> str:
    """Return one of ``jaspar|meme|transfac|pfm`` with the reference's
    dispatch precedence (``motif_ops.py:1160-1176``)."""
    if is_jaspar(motif_file):
        return "jaspar"
    if is_meme(motif_file):
        return "meme"
    if is_transfac(motif_file):
        return "transfac"
    if is_pfm(motif_file):
        return "pfm"
    raise ValueError(
        f"{motif_file}: motifs must be in JASPAR, MEME, TRANSFAC, or PFM format"
    )


def is_bed(bedfile: str) -> bool:
    """BED sniff: any ``chr``-prefixed line with >= 3 columns
    (reference ``utils.py:408-449``)."""
    if not os.path.isfile(bedfile):
        raise FileNotFoundError(f"unable to locate {bedfile}")
    opener = gzip.open if bedfile.split(".")[-1] == "gz" else open
    with opener(bedfile, mode="rt") as handle:
        for line in handle:
            if line.startswith("chr"):
                return len(line.split()) >= 3
    return False
