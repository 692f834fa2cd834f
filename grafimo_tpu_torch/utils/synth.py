"""Synthetic chromosome inputs at the 1KGP profile.

Copied from ``tools/bench_chrom_scale.py:47-161`` (``synth_chrom``,
``make_variants``, ``write_fasta``, ``write_vcf`` and the BGZF writer
they share), over the port's own ``_bgzf_block``: the tool imports the
reference package.  The profile: variant density 1/30 bp, 12% indels
(geometric lengths, 55/45 del/ins), rare-skewed allele frequencies,
phased diploid samples, and MHC-like dense pockets at 5x density.
``tests/test_torch_isolation.py`` holds the files these write byte for
byte against the tool's.
"""

import numpy as np

from grafimo_tpu_torch.graph.vgproto import _bgzf_block

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
