"""Minimal phased-VCF reader for graph construction.

The reference shells out to ``tabix`` + ``vg construct -v VCF``
(``constructVG.py:213-236,332``); here the VCF is parsed directly.  Only the
fields the graph builder needs are materialised: position, alleles and the
per-haplotype phased genotype matrix.
"""

import gzip
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 1-based
    ref: str
    alts: List[str]
    # genotypes, one of:
    #   * allele index per haplotype (0=ref, 1..=alts), length 2*n_samples
    #     for diploid phased samples (python reader);
    #   * dict {allele_idx: uint64 haplotype-bitset words} — the HaploIndex
    #     row layout, produced by the native scanner (native/vcfio.cpp);
    #   * None when the VCF has no samples.
    gt: object


def _opener(fn: str):
    with open(fn, "rb") as f:
        magic = f.read(2)
    return gzip.open(fn, "rt") if magic == b"\x1f\x8b" else open(fn)


def _parse_gt_fast(sample_str: str, n_samples: int) -> Optional[np.ndarray]:
    """Vectorised GT parse for the dominant pangenome-VCF shape (every
    sample field exactly ``a|b`` / ``a/b`` with single-digit alleles).
    Returns allele indices per haplotype or None when the line does not
    fit (the caller then tries the native parser, then the general one —
    see :func:`iter_vcf_records`)."""
    raw = np.frombuffer(sample_str.encode("ascii"), dtype=np.uint8)
    if raw.size != 4 * n_samples - 1:
        return None
    cells = np.concatenate([raw, np.frombuffer(b"\t", np.uint8)]).reshape(
        n_samples, 4
    )
    a = cells[:, 0] - ord("0")
    b = cells[:, 2] - ord("0")
    seps_ok = (
        ((cells[:, 1] == ord("|")) | (cells[:, 1] == ord("/"))).all()
        and (cells[:-1, 3] == ord("\t")).all()
    )
    digits_ok = bool((a <= 9).all() and (b <= 9).all())
    if not (seps_ok and digits_ok):
        # '.' missing alleles are common enough to handle here: treat as 0
        dot = ord(".") - ord("0")
        if seps_ok and bool(
            (((a <= 9) | (a == dot)) & ((b <= 9) | (b == dot))).all()
        ):
            a = np.where(a == dot, 0, a)
            b = np.where(b == dot, 0, b)
        else:
            return None
    out = np.empty(2 * n_samples, dtype=np.int32)
    out[0::2] = a
    out[1::2] = b
    return out


def iter_vcf_records(
    fn: str, chrom: Optional[str] = None
) -> Iterator[VcfRecord]:
    """Yield records (optionally restricted to one chromosome).

    Genotypes are parsed from the GT field (first FORMAT key by VCF spec);
    ``|`` and ``/`` separators are both accepted (the reference pipeline
    requires phased VCFs; unphased calls are treated as listed).  Missing
    alleles (``.``) count as reference.
    """
    n_samples: Optional[int] = None
    with _opener(fn) as handle:
        for line in handle:
            if line.startswith("#"):
                if line.startswith("#CHROM"):
                    n_samples = max(0, len(line.rstrip("\n").split("\t")) - 9)
                continue
            line = line.rstrip("\n")
            if chrom is not None and not line.startswith(chrom + "\t"):
                continue
            fields = line.split("\t", 9)
            if chrom is not None and fields[0] != chrom:
                continue
            ref = fields[3].upper()
            alts = [a.upper() for a in fields[4].split(",") if a != "."]
            if not alts:
                continue
            # symbolic / breakend alleles are not representable as sequence
            if any(
                ("<" in a) or (">" in a) or ("[" in a) or ("]" in a)
                for a in alts
            ):
                continue
            gt = None
            if len(fields) > 9 and n_samples:
                gt = _parse_gt_fast(fields[9], n_samples)
                if gt is None:  # irregular line: native parser
                    try:
                        from grafimo_tpu_torch.native import vcf_parse_gt

                        gt = vcf_parse_gt(
                            fields[9].encode("ascii"), 2 * n_samples
                        )
                    except Exception:
                        gt = None
                if gt is None:  # general (slow) parse
                    gt = []
                    for sample in fields[9].split("\t"):
                        gt_str = sample.split(":", 1)[0]
                        for al in gt_str.replace("|", "/").split("/"):
                            if al in (".", ""):
                                gt.append(0)
                            else:
                                gt.append(int(al))
            yield VcfRecord(
                chrom=fields[0],
                pos=int(fields[1]),
                ref=ref,
                alts=alts,
                gt=gt,
            )


def read_vcf_records(
    fn: str, chrom: str
) -> Tuple[List[VcfRecord], Optional[int]]:
    """Read one chromosome's records, preferring the threaded native
    scanner (``native/vcfio.cpp``: parallel BGZF inflate + parallel GT →
    haplotype-bitset parse); falls back to :func:`iter_vcf_records`.

    Returns ``(records, n_hap)`` — ``n_hap`` is known only on the native
    path (``None`` tells the graph builder to infer it from GT lengths).
    """
    if not os.environ.get("GRAFIMO_TPU_NO_NATIVE"):
        try:
            from grafimo_tpu_torch.native import vcf_scan_native

            return vcf_scan_native(fn, chrom)
        except Exception:
            pass
    return list(iter_vcf_records(fn, chrom)), None


def vcf_chroms(fn: str) -> List[str]:
    """Distinct chromosome names in record order."""
    seen = []
    seen_set = set()
    with _opener(fn) as handle:
        for line in handle:
            if line.startswith("#"):
                continue
            c = line.split("\t", 1)[0]
            if c not in seen_set:
                seen.append(c)
                seen_set.add(c)
    return seen
