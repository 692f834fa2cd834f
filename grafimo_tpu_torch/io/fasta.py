"""FASTA reading.

The reference scans FASTA headers to list chromosomes
(``constructVG.py:407-468``) and otherwise delegates sequence access to the
external ``vg`` binary; here the graph builder consumes sequences directly.
"""

import gzip
from typing import Dict, Iterator, List, Optional, Tuple


def _opener(fn: str):
    return gzip.open(fn, "rt") if fn.endswith(".gz") else open(fn)


def iter_fasta(fn: str) -> Iterator[Tuple[str, str]]:
    """Yield ``(name, sequence)`` per record; name is the first
    whitespace-delimited token of the header."""
    name = None
    chunks: List[str] = []
    with _opener(fn) as handle:
        for line in handle:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def read_fasta(fn: str, chroms: Optional[List[str]] = None) -> Dict[str, str]:
    """Load (a subset of) a FASTA file into a dict of uppercase sequences."""
    want = set(chroms) if chroms else None
    out: Dict[str, str] = {}
    for name, seq in iter_fasta(fn):
        if want is None or name in want:
            out[name] = seq.upper()
            if want is not None and len(out) == len(want):
                break
    return out


def fasta_chrom_names(fn: str) -> List[str]:
    """Chromosome names in header order (reference ``get_chromlist``,
    ``constructVG.py:407-468``)."""
    names = []
    with _opener(fn) as handle:
        for line in handle:
            if line.startswith(">"):
                names.append(line[1:].split()[0].strip())
    return names
