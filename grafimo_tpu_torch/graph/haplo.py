"""Haplotype index: the framework's GBWT replacement.

The reference delegates haplotype-aware window frequencies to ``vg find -H
chr.gbwt`` (``extract_regions.py:180``), whose GBWT stores each sample
haplotype as a path thread.  For VCF-derived graphs an equivalent but far
cheaper structure suffices: one bitset per (site, alt allele) over the ``H``
haplotypes, built straight from the phased GT matrix.

A window's haplotype frequency is the popcount of the AND of the bitsets of
its *determined* site choices (subpath semantics: a site constrains the count
only when the window's walk actually traverses the site's choice region —
see :mod:`grafimo_tpu.graph.enumerate`).  Windows determining no site are
contained in every haplotype, frequency ``H``.

This formulation is O(words) per window, embarrassingly parallel, trivially
shardable, and exactly reproduces GBWT subpath-count semantics on acyclic
VCF graphs.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class HaploIndex:
    """Per-(site, allele) haplotype bitsets.

    Parameters
    ----------
    n_hap:
        number of haplotypes (2 x samples for phased diploid VCFs).
    site_allele_rows:
        maps ``site_id`` to a dict ``allele_idx -> row`` into ``alt_bits``
        for every non-reference allele.
    alt_bits:
        ``(n_rows, W)`` uint64, bit h set when haplotype ``h`` carries that
        allele.
    """

    def __init__(
        self,
        n_hap: int,
        site_allele_rows: List[Dict[int, int]],
        alt_bits: np.ndarray,
    ):
        self.n_hap = n_hap
        self.words = (n_hap + 63) // 64
        self.site_allele_rows = site_allele_rows
        self.alt_bits = alt_bits
        self._full = self._full_mask()

    def _any_alt(self, sid: int) -> np.ndarray:
        """Per-site OR of all alt bitsets (complement = ref carriers),
        computed on demand: only hit reconstruction reads it — a handful
        of sites per scan — while an eager ``(n_sites, words)`` build
        dominated chromosome-graph load time (1.7M sites x 80 words)."""
        rows = self.site_allele_rows[sid]
        if len(rows) == 1:
            return self.alt_bits[next(iter(rows.values()))]
        acc = np.zeros(self.words, dtype=np.uint64)
        for row in rows.values():
            acc |= self.alt_bits[row]
        return acc

    def _full_mask(self) -> np.ndarray:
        full = np.full(self.words, ~np.uint64(0), dtype=np.uint64)
        rem = self.n_hap % 64
        if self.words and rem:
            full[-1] = (np.uint64(1) << np.uint64(rem)) - np.uint64(1)
        return full

    @staticmethod
    def from_genotypes(
        n_hap: int, site_gts: Sequence[Optional[Sequence[int]]]
    ) -> "HaploIndex":
        """Build from per-site genotypes: either allele-index-per-haplotype
        vectors, or pre-built ``{allele: uint64 bitset words}`` dicts (the
        native VCF scanner's output, ``native/vcfio.cpp``); ``None`` for
        sites without genotype data -> no carriers.

        Allele-vector sites are packed in CHUNKS — one equality compare +
        ``np.packbits`` per (chunk, allele) instead of ``np.unique`` +
        ``packbits`` per site (the per-site form dominated graph build at
        pangenome scale: ~60% of a 10 Mbp / 333k-site build).  Row order
        (site-major, allele-minor) is unchanged — the native and python
        builders stay array-identical.
        """
        words = (n_hap + 63) // 64
        pad_bytes = words * 8

        # chunked packing of allele-vector sites: site index -> {allele:
        # word row} computed with whole-chunk numpy ops
        vec_idx = [
            i
            for i, g in enumerate(site_gts)
            if g is not None and not isinstance(g, dict)
        ]
        vec_rows: Dict[int, Dict[int, np.ndarray]] = {}
        chunk_sz = max(1, (1 << 23) // max(1, n_hap))  # ~8MB int8 chunks
        for lo in range(0, len(vec_idx), chunk_sz):
            chunk = vec_idx[lo : lo + chunk_sz]
            mat = np.zeros((len(chunk), n_hap), dtype=np.int16)
            for j, i in enumerate(chunk):
                a = np.asarray(site_gts[i], dtype=np.int16)[:n_hap]
                mat[j, : a.size] = a
            mx = int(mat.max(initial=0))
            for a in range(1, mx + 1):
                mask = mat == a
                carried = mask.any(axis=1)
                if not carried.any():
                    continue
                packed = np.packbits(
                    mask[carried], axis=1, bitorder="little"
                )
                full = np.zeros((packed.shape[0], pad_bytes), np.uint8)
                full[:, : packed.shape[1]] = packed
                wrds = full.view(np.uint64)
                for r, j in zip(wrds, np.flatnonzero(carried).tolist()):
                    vec_rows.setdefault(chunk[j], {})[a] = r

        rows: List[Dict[int, int]] = []
        bits: List[np.ndarray] = []
        for i, gts in enumerate(site_gts):
            site_rows: Dict[int, int] = {}
            if isinstance(gts, dict):
                for a in sorted(gts):
                    src = np.asarray(gts[a], dtype=np.uint64)
                    row = np.zeros(words, dtype=np.uint64)
                    n = min(words, src.size)
                    row[:n] = src[:n]
                    if row.any():  # carried alleles only
                        site_rows[int(a)] = len(bits)
                        bits.append(row)
            elif gts is not None:
                for a, row in sorted(vec_rows.get(i, {}).items()):
                    site_rows[a] = len(bits)
                    bits.append(row)
            rows.append(site_rows)
        alt_bits = (
            np.stack(bits) if bits else np.zeros((0, words), dtype=np.uint64)
        )
        return HaploIndex(n_hap, rows, alt_bits)

    def count(self, choices: Sequence[Tuple[int, int]]) -> int:
        """Haplotype frequency of a walk given its determined
        ``(site_id, allele_idx)`` choices."""
        acc = self._full.copy()
        for sid, allele in choices:
            if allele == 0:
                acc &= ~self._any_alt(sid) & self._full
            else:
                row = self.site_allele_rows[sid].get(allele)
                if row is None:
                    return 0  # allele carried by no haplotype
                acc &= self.alt_bits[row]
            if not acc.any():
                return 0
        return int(np.bitwise_count(acc).sum())

    # -- serialisation -----------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        flat_sites, flat_alleles, flat_rows = [], [], []
        for sid, rows in enumerate(self.site_allele_rows):
            for a, r in rows.items():
                flat_sites.append(sid)
                flat_alleles.append(a)
                flat_rows.append(r)
        return {
            "hap_n": np.array([self.n_hap], dtype=np.int64),
            "hap_nsites": np.array(
                [len(self.site_allele_rows)], dtype=np.int64
            ),
            "hap_map_site": np.array(flat_sites, dtype=np.int64),
            "hap_map_allele": np.array(flat_alleles, dtype=np.int64),
            "hap_map_row": np.array(flat_rows, dtype=np.int64),
            "hap_alt_bits": self.alt_bits,
        }

    @staticmethod
    def from_arrays(arrays) -> "HaploIndex":
        n_hap = int(arrays["hap_n"][0])
        n_sites = int(arrays["hap_nsites"][0])
        rows: List[Dict[int, int]] = [dict() for _ in range(n_sites)]
        for s, a, r in zip(
            arrays["hap_map_site"].tolist(),
            arrays["hap_map_allele"].tolist(),
            arrays["hap_map_row"].tolist(),
        ):
            rows[s][a] = r
        return HaploIndex(n_hap, rows, np.asarray(arrays["hap_alt_bits"]))
