"""Synthetic chromosome inputs at the 1KGP profile.

Copied from ``tools/bench_chrom_scale.py:47-161`` (``synth_chrom``,
``make_variants``, ``write_fasta``, ``write_vcf`` and the BGZF writer
they share), over the port's own ``_bgzf_block``: the tool imports the
reference package.  The profile: variant density 1/30 bp, 12% indels
(geometric lengths, 55/45 del/ins), rare-skewed allele frequencies,
phased diploid samples, and MHC-like dense pockets at 5x density.
``encode_like_bed`` is the same tool's ENCODE-shaped peak set.
``tests/test_torch_isolation.py`` holds the files these write byte for
byte against the tool's.

The many-motif inputs are copied from ``tools/bench_jaspar_ladder.py``
(``WIDTH_PMF`` and ``synth_meme``, ``:35-78``; the pangenome of its
``main``, ``:124-144``): 800-odd PWMs drawn from JASPAR CORE
vertebrates' width histogram, over a random chromosome with one SNP
every 30 bp, each alt on 1 haplotype in 7.
``tests/test_torch_scale_configs.py`` holds them to the tool.
"""

import numpy as np

from grafimo_tpu_torch.graph.vgproto import _bgzf_block
from grafimo_tpu_torch.io.vcf import VcfRecord

BASES = np.frombuffer(b"ACGT", np.uint8)


def synth_chrom(rng, L: int, H: int, pockets: int = 3):
    """Sequence codes + variant tuples at the 1KGP profile with
    ``pockets`` MHC-like dense windows (5x density over 200 kb)."""
    seq = rng.integers(0, 4, L).astype(np.uint8)
    density = np.full(L, 1 / 30.0)
    pocket_spans = []
    for i in range(pockets):
        c = int((i + 1) * L / (pockets + 1))
        lo, hi = max(1, c - 100_000), min(L - 100, c + 100_000)
        density[lo:hi] *= 5
        pocket_spans.append((lo, hi))
    pos = np.flatnonzero(rng.random(L) < density)
    pos = pos[(pos > 1) & (pos < L - 30)]
    return seq, pos, pocket_spans


def make_variants(rng, seq, pos, H):
    """Per-site (pos0, ref, alt, carriers) tuples; 12% indels."""
    out = []
    last = 0
    n_indel = 0
    afs = rng.beta(0.2, 1.8, len(pos))
    kinds = rng.random(len(pos))
    for i, p in enumerate(pos):
        p = int(p)
        if p < last:
            continue
        # 1KGP-like site frequency spectrum: ~55% singleton/very-rare
        # (2504-sample 1KGP has ~64% MAF<0.5%), the rest beta-skewed
        if rng.random() < 0.55:
            n_car = int(rng.geometric(0.5))  # 1, 2, 3... halving
        else:
            af = float(afs[i])
            n_car = min(H, max(1, int(round(af * H))))
        if n_car < H // 8:
            # rare variant: sample with replacement + dedup (collision
            # odds tiny; avoids numpy choice's O(H) permutation)
            carriers = np.unique(rng.integers(0, H, n_car))
        else:
            carriers = rng.choice(H, size=n_car, replace=False)
        if kinds[i] < 0.12:
            ln = min(12, 1 + int(rng.geometric(0.45)))
            if rng.random() < 0.55 and p + ln + 1 < len(seq):  # deletion
                ref = seq[p - 1 : p + ln]
                alt = ref[:1]
                last = p + ln
            else:  # insertion
                ref = seq[p - 1 : p]
                alt = np.concatenate([ref, rng.integers(0, 4, ln)])
                last = p + 1
            n_indel += 1
        else:
            ref = seq[p : p + 1]
            alt = np.array([(int(seq[p]) + 1) % 4], np.uint8)
            last = p + 1
        out.append((p, ref, alt, carriers))
    return out, n_indel


def write_fasta(path, name, seq):
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        txt = BASES[seq].tobytes()
        for i in range(0, len(txt), 60):
            f.write(txt[i : i + 60] + b"\n")


def encode_like_bed(path, L, n, chrom="21"):
    """``n`` 270 bp regions of an ``L``-base chromosome ``chrom`` drawn
    from seed 7 and sorted, as ``tools/bench_chrom_scale.py:297-303``
    writes its ``encode_like.bed`` (the reference's headline workload's
    shape: CTCF over the top ENCODE peaks)."""
    starts = np.sort(np.random.default_rng(7).integers(0, L - 300, n))
    with open(path, "w") as f:
        for s0 in starts.tolist():
            f.write(f"chr{chrom}\t{s0}\t{s0 + 270}\n")


class BgzfWriter:
    def __init__(self, path):
        self.f = open(path, "wb")
        self.buf = bytearray()

    def write(self, b: bytes):
        self.buf += b
        while len(self.buf) >= 60000:
            self.f.write(_bgzf_block(bytes(self.buf[:60000]), level=1))
            del self.buf[:60000]

    def close(self):
        if self.buf:
            self.f.write(_bgzf_block(bytes(self.buf), level=1))
        self.f.write(_bgzf_block(b""))  # EOF marker
        self.f.close()


def write_vcf(path, chrom, seq, variants, H):
    """BGZF VCF with 2548 diploid phased sample columns."""
    n_s = H // 2
    w = BgzfWriter(path)
    w.write(b"##fileformat=VCFv4.2\n")
    w.write(
        ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
         + "\t".join(f"s{i}" for i in range(n_s)) + "\n").encode()
    )
    # template row of 0|0 genotypes; carriers patched per record:
    # sample j's field "0|0\t" sits at bytes [4j, 4j+4) — haplotype h
    # (sample h//2, allele h%2) is byte 4*(h//2) + 2*(h%2)
    template = np.frombuffer(b"0|0\t" * n_s, np.uint8).copy()
    template[-1] = 0x0A  # newline ends the row
    for p, ref, alt, carriers in variants:
        # indels anchor at 0-based p-1 (1-based p); SNPs at p (p+1)
        pos1 = p if len(ref) > 1 or len(alt) > 1 else p + 1
        head = (
            f"{chrom}\t{pos1}\t.\t{BASES[ref].tobytes().decode()}\t"
            f"{BASES[alt].tobytes().decode()}\t99\tPASS\t.\tGT\t"
        ).encode()
        row = template.copy()
        row[4 * (carriers // 2) + 2 * (carriers % 2)] = 0x31  # '1'
        w.write(head)
        w.write(row.tobytes())
    w.close()


# JASPAR CORE vertebrates width histogram (approximate, JASPAR 2020
# non-redundant vertebrates, 746 profiles): P(width)
WIDTH_PMF = {
    6: 0.02, 7: 0.03, 8: 0.07, 9: 0.07, 10: 0.12, 11: 0.14, 12: 0.11,
    13: 0.08, 14: 0.08, 15: 0.09, 16: 0.05, 17: 0.04, 18: 0.03,
    19: 0.02, 20: 0.015, 21: 0.015, 22: 0.01, 23: 0.008, 24: 0.007,
    25: 0.005, 26: 0.004, 28: 0.003, 30: 0.003,
}


def synth_meme(path: str, n_motifs: int, rng) -> dict:
    """Write ``n_motifs`` synthetic PWMs as one MEME file; returns the
    width histogram."""
    widths = list(WIDTH_PMF)
    probs = np.array([WIDTH_PMF[w] for w in widths])
    probs = probs / probs.sum()
    lines = [
        "MEME version 4", "",
        "ALPHABET= ACGT", "",
        "strands: + -", "",
        "Background letter frequencies (from uniform background):",
        "A 0.25000 C 0.25000 G 0.25000 T 0.25000", "",
    ]
    histo = {}
    for i in range(n_motifs):
        k = int(rng.choice(widths, p=probs))
        histo[k] = histo.get(k, 0) + 1
        nsites = int(rng.integers(20, 5000))
        lines.append(f"MOTIF M{i:04d} TF{i:04d}")
        lines.append(
            "letter-probability matrix: alength= 4 w= "
            f"{k} nsites= {nsites} E= 0"
        )
        # realistic IC profile: strong core, fuzzy flanks
        for j in range(k):
            edge = min(j, k - 1 - j) / max(1, (k - 1) / 2)
            conc = 0.15 + 2.5 * edge  # low conc = peaky column
            p = rng.dirichlet([conc] * 4)
            p = np.maximum(p, 1e-4)
            p = p / p.sum()
            lines.append(" ".join(f"{x:.6f}" for x in p))
        lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return histo


def ladder_pangenome(rng, L: int, H: int, chrom: str = "c"):
    """The ladder's chromosome: ``L`` random bases (a string) and its SNP
    records, one every 30 bp on average, each alt carried by about one
    haplotype in 7 of ``H`` (``gt`` rows of int32 allele indices)."""
    seq = rng.integers(0, 4, L).astype(np.uint8).tobytes().translate(
        bytes.maketrans(bytes(range(4)), b"ACGT")
    ).decode()
    positions = np.sort(
        rng.choice(np.arange(1, L - 10), L // 30, replace=False)
    )
    keep = np.ones(len(positions), bool)
    keep[1:] = np.diff(positions) > 0
    positions = positions[keep]
    gt_all = (rng.integers(0, 7, (len(positions), H)) == 0).astype(
        np.int32
    )
    records = [
        VcfRecord(
            chrom, int(p) + 1, seq[p],
            ["ACGT"[("ACGT".index(seq[p]) + 1) % 4]], gt_all[i],
        )
        for i, p in enumerate(positions)
    ]
    return seq, records
