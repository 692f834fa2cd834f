"""Window batches: the in-memory contract between graph extraction and
scoring.

Copied unchanged from ``grafimo_tpu/windows.py:27-143``: the original is
jax-free, but importing it imports ``grafimo_tpu.ops.encode`` and with it
``grafimo_tpu/ops/__init__.py``, which imports jax.
``tests/test_torch_scan.py`` pins the copy to it.

A :class:`WindowBatch` carries the reference's per-region extraction TSV
rows (``extract_regions.py:119-237``) as an integer code tensor plus
per-window metadata columns.  ``read_windows_tsv`` reads the reference's
7-column TSV format (``region  seq  start±  stop±  hap_freq  ref|non.ref
node_path``).
"""

import glob
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np

from grafimo_tpu_torch.ops.encode import seqs_to_codes


@dataclass
class WindowBatch:
    """A batch of candidate k-length path windows."""

    width: int
    seqnames: List[str]
    seqs: List[str]
    chroms: List[str]
    starts: np.ndarray  # int64
    stops: np.ndarray  # int64
    strands: List[str]  # "+" / "-"
    freqs: np.ndarray  # int64 haplotype frequency
    refs: List[str]  # "ref" / "non.ref"
    paths: Optional[List[str]] = None  # node path strings (report only)
    _codes: Optional[np.ndarray] = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.seqs)

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = seqs_to_codes(self.seqs, self.width)
        return self._codes

    def select(self, mask: np.ndarray) -> "WindowBatch":
        idx = np.nonzero(mask)[0]
        return WindowBatch(
            width=self.width,
            seqnames=[self.seqnames[i] for i in idx],
            seqs=[self.seqs[i] for i in idx],
            chroms=[self.chroms[i] for i in idx],
            starts=self.starts[idx],
            stops=self.stops[idx],
            strands=[self.strands[i] for i in idx],
            freqs=self.freqs[idx],
            refs=[self.refs[i] for i in idx],
            paths=[self.paths[i] for i in idx] if self.paths else None,
            _codes=self._codes[idx] if self._codes is not None else None,
        )

    @staticmethod
    def empty(width: int) -> "WindowBatch":
        return WindowBatch(
            width=width, seqnames=[], seqs=[], chroms=[],
            starts=np.zeros(0, dtype=np.int64),
            stops=np.zeros(0, dtype=np.int64),
            strands=[], freqs=np.zeros(0, dtype=np.int64), refs=[], paths=[],
        )


def read_windows_tsv(path: str, width: int) -> WindowBatch:
    """Parse one reference-format extraction TSV
    (field semantics: ``score_sequences.py:279-296``)."""
    seqnames, seqs, chroms, strands, refs, paths = [], [], [], [], [], []
    starts, stops, freqs = [], [], []
    with open(path) as handle:
        for line in handle:
            data = line.strip().split()
            if not data:
                continue
            seqname, seq = data[0], data[1]
            strand = data[2][-1]
            start = int(data[2].split(":")[1][:-1])
            stop = int(data[3].split(":")[1][:-1])
            seqnames.append(seqname)
            seqs.append(seq)
            chroms.append(seqname.split(":")[0])
            strands.append(strand)
            starts.append(start)
            stops.append(stop)
            freqs.append(int(data[4]))
            refs.append(data[5])
            paths.append(data[6] if len(data) > 6 else "")
    return WindowBatch(
        width=width,
        seqnames=seqnames,
        seqs=seqs,
        chroms=chroms,
        starts=np.array(starts, dtype=np.int64),
        stops=np.array(stops, dtype=np.int64),
        strands=strands,
        freqs=np.array(freqs, dtype=np.int64),
        refs=refs,
        paths=paths,
    )


def iter_windows_tsv_dir(
    sequence_loc: str, width: int
) -> Iterator[WindowBatch]:
    """Yield one batch per TSV under ``sequence_loc/width_{k}/``
    (mirrors the reference's glob, ``score_sequences.py:113-119``)."""
    width_dir = os.path.join(sequence_loc, f"width_{width}")
    for fn in sorted(glob.glob(os.path.join(width_dir, "*.tsv"))):
        yield read_windows_tsv(fn, width)


def concat_batches(batches: List[WindowBatch], width: int) -> WindowBatch:
    if not batches:
        return WindowBatch.empty(width)
    return WindowBatch(
        width=width,
        seqnames=[s for b in batches for s in b.seqnames],
        seqs=[s for b in batches for s in b.seqs],
        chroms=[s for b in batches for s in b.chroms],
        starts=np.concatenate([b.starts for b in batches]),
        stops=np.concatenate([b.stops for b in batches]),
        strands=[s for b in batches for s in b.strands],
        freqs=np.concatenate([b.freqs for b in batches]),
        refs=[s for b in batches for s in b.refs],
        paths=(
            [s for b in batches for s in (b.paths or [""] * len(b))]
            if any(b.paths for b in batches)
            else None
        ),
    )
