"""A cell's inputs, drawn from the run's seed, and its graph.

    python3 benchmark/inputs.py CONFIG.json TRAFFIC.json SEED OUTDIR

Writes into OUTDIR the chromosome as a FASTA (``ref.fa``) and its phased
variants as a BGZF VCF (``synth.vcf.gz``), the traffic's regions
(``regions.bed``), the configuration's motifs (``motifs.meme``), the
graph that the port's own ``buildvg`` makes of them (``graphs/``), and
``truth.npz``: the drawn sequence and variants, from which the plain
reference works without reading any file the port wrote.  Prints one
JSON line of counts and seconds.

The generators are a frozen copy of ``grafimo_tpu_torch/utils/synth.py``
(``synth_chrom``, ``make_variants``, ``write_fasta``, ``write_vcf``,
``encode_like_bed``) with the same distributions, drawn in bulk from the
seed: variants every ``variant_every_bp`` bases (denser in ``pockets``
windows where a configuration asks for them), a rare-skewed allele
spectrum, indels of geometric length, ``haplotypes`` phased haplotypes
(two a sample).  A traffic mix of peaks may plant a motif site near a
share of its regions' centres (``plant``).
"""

import json
import os
import struct
import sys
import time
import zlib

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
SNP, DELETION, INSERTION = 0, 1, 2
# BGZF payload per block, as the port's writer cuts it
BGZF_CHUNK = 60000
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def streams(seed: int):
    """Independent generators for the genome, the traffic and the
    carriers: any seed, however large, gives the same three every
    time."""
    return [np.random.default_rng([seed, i]) for i in range(3)]


def chromosome(rng, cfg: dict) -> dict:
    """The sequence and its sites at the configuration's profile
    (``synth.synth_chrom`` and ``synth.make_variants``): positions at
    ``1 / variant_every_bp``, ``pocket_density_factor`` times denser over
    ``pockets`` windows of twice ``pocket_half_bp`` (none where the
    configuration names no ``pockets``); ``indel_share``
    indels of length ``1 + Geometric(indel_len_p)`` (at most
    ``indel_len_max``), ``deletion_share`` of them deletions; a share
    ``rare_share`` of sites carried by a geometric number of haplotypes,
    the rest by a Beta-drawn allele frequency.  A site that starts inside
    the previous one's span is dropped, so sites never overlap.  The
    carriers are drawn with the VCF's rows (``write_vcf``)."""
    L, H = cfg["length_bp"], cfg["haplotypes"]
    seq = rng.integers(0, 4, L, dtype=np.uint8)
    density = np.full(L, 1.0 / cfg["variant_every_bp"])
    pockets = cfg.get("pockets", 0)
    for i in range(pockets):
        c = int((i + 1) * L / (pockets + 1))
        lo = max(1, c - cfg["pocket_half_bp"])
        hi = min(L - 100, c + cfg["pocket_half_bp"])
        density[lo:hi] *= cfg["pocket_density_factor"]
    pos = np.flatnonzero(rng.random(L) < density)
    del density
    pos = pos[(pos > 1) & (pos < L - 30)]
    n = len(pos)
    rare = rng.random(n) < cfg["rare_share"]
    n_car = np.where(
        rare, rng.geometric(cfg["rare_geometric_p"], n),
        np.clip(np.rint(rng.beta(*cfg["af_beta"], n) * H), 1, H),
    ).astype(np.int64)
    n_car = np.minimum(n_car, H)
    indel = rng.random(n) < cfg["indel_share"]
    length = np.minimum(cfg["indel_len_max"],
                        1 + rng.geometric(cfg["indel_len_p"], n))
    deletion = rng.random(n) < cfg["deletion_share"]
    ins_bases = rng.integers(0, 4, (n, cfg["indel_len_max"]), dtype=np.uint8)

    kind = np.full(n, SNP, np.int8)
    keep = np.zeros(n, bool)
    last = 0
    for i, (p, is_indel, ln, is_del) in enumerate(zip(
            pos.tolist(), indel.tolist(), length.tolist(),
            deletion.tolist())):
        if p < last:
            continue
        keep[i] = True
        if not is_indel:
            last = p + 1
        elif is_del and p + ln + 1 < L:
            kind[i] = DELETION
            last = p + ln
        else:
            kind[i] = INSERTION
            last = p + 1
    length = length[keep]
    length[kind[keep] == SNP] = 1
    return {"seq": seq, "pos": pos[keep], "kind": kind[keep],
            "length": length, "ins_bases": ins_bases[keep],
            "n_car": n_car[keep], "haplotypes": H}


def carriers(rng, n_car: np.ndarray, H: int) -> np.ndarray:
    """``(sites, H)`` carrier flags: a site with fewer than ``H / 8``
    carriers draws them with replacement and keeps the distinct ones
    (``synth.make_variants``); a commoner one carries its allele on each
    haplotype with probability ``n_car / H``."""
    out = np.zeros((len(n_car), H), bool)
    few = n_car < H // 8
    rows = np.repeat(np.flatnonzero(few), n_car[few])
    out[rows, rng.integers(0, H, len(rows))] = True
    common = np.flatnonzero(~few)
    out[common] = (rng.random((len(common), H), dtype=np.float32)
                   < (n_car[common] / H).astype(np.float32)[:, None])
    return out


def write_fasta(path: str, name: str, seq: np.ndarray) -> None:
    txt = BASES[seq].tobytes()
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(b"\n".join(txt[i:i + 60] for i in range(0, len(txt), 60)))
        f.write(b"\n")


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block: a gzip member with htslib's ``BC`` extra field."""
    comp = zlib.compressobj(1, zlib.DEFLATED, -15)
    deflated = comp.compress(data) + comp.flush()
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<H", 6) + b"BC"
              + struct.pack("<HH", 2, 12 + 6 + len(deflated) + 8 - 1))
    return header + deflated + struct.pack("<II", zlib.crc32(data),
                                           len(data) & 0xFFFFFFFF)


def vcf_heads(chrom: str, g: dict, letters: bytes, sites) -> list:
    """Each site's VCF columns up to ``FORMAT``: SNPs at their own base,
    indels anchored on the base before them (``synth.write_vcf``);
    ``letters`` is the sequence as text."""
    heads = []
    for i in sites:
        p, kind, ln = int(g["pos"][i]), g["kind"][i], int(g["length"][i])
        if kind == SNP:
            ref = letters[p:p + 1]
            alt = b"ACGT"[("ACGT".index(chr(ref[0])) + 1) % 4:][:1]
            pos1 = p + 1
        elif kind == DELETION:
            pos1, ref, alt = p, letters[p - 1:p + ln], letters[p - 1:p]
        else:
            pos1, ref = p, letters[p - 1:p]
            alt = ref + BASES[g["ins_bases"][i, :ln]].tobytes()
        heads.append(b"%s\t%d\t.\t%s\t%s\t99\tPASS\t.\tGT\t"
                     % (chrom.encode(), pos1, ref, alt))
    return heads


def write_vcf(path: str, chrom: str, g: dict, rng,
              keep: np.ndarray) -> np.ndarray:
    """BGZF VCF with ``haplotypes / 2`` phased diploid samples, its
    carriers drawn in batches of sites.  Returns the packed carrier flags
    of the sites ``keep`` marks."""
    H = g["haplotypes"]
    n_s = H // 2
    template = np.frombuffer(b"0|0\t" * n_s, np.uint8).copy()
    template[-1] = 0x0A
    header = (b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
              b"FILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(n_s)).encode() + b"\n")
    kept = []
    n = len(g["pos"])
    letters = BASES[g["seq"]].tobytes()
    with open(path, "wb") as f:
        pending = header
        for lo in range(0, n + 1, 4096):
            sites = range(lo, min(lo + 4096, n))
            flags = carriers(rng, g["n_car"][lo:lo + 4096], H)
            kept.append(np.packbits(flags[keep[lo:lo + 4096]], axis=1))
            rows = np.tile(template, (len(sites), 1))
            # haplotype h is allele h % 2 of sample h // 2, at byte
            # 4 * (h // 2) + 2 * (h % 2) of its row
            rows[:, 0::4] += flags[:, 0::2]
            rows[:, 2::4] += flags[:, 1::2]
            parts = [pending]
            for head, row in zip(vcf_heads(chrom, g, letters, sites), rows):
                parts.append(head)
                parts.append(row)
            blob = memoryview(b"".join(parts))
            cut = len(blob)
            if lo + 4096 <= n:
                cut -= cut % BGZF_CHUNK
                pending = bytes(blob[cut:])
            for i in range(0, cut, BGZF_CHUNK):
                f.write(_bgzf_block(blob[i:min(i + BGZF_CHUNK, cut)]))
        f.write(BGZF_EOF)
    return np.concatenate(kept)


def regions(rng, traffic: dict, length: int):
    """The traffic's regions, sorted: ``regions`` distinct starts drawn
    uniformly over the chromosome (``synth.encode_like_bed``), each
    ``region_bp`` long; or the whole chromosome."""
    if traffic.get("whole_chromosome"):
        return [(0, length)]
    span = traffic["region_bp"]
    starts = np.sort(rng.choice(length - span - traffic["margin_bp"],
                                traffic["regions"], replace=False))
    return [(s, s + span) for s in starts.tolist()]


def plant(rng, seq: np.ndarray, spans, traffic: dict, meme: str) -> int:
    """Writes a motif site into the sequence near the centre of a share
    ``planted_share`` of the regions (drawn from the seed): a motif of the
    MEME text drawn uniformly, its bases drawn from its letter
    probabilities, on either strand, starting ``planted_offset_bp`` or
    fewer bases either side of the centred start and kept inside the
    region.  Variants drawn later may fall on it, as they fall on real
    sites.  Returns the number of sites planted."""
    from benchmark.reference import parse_meme

    share = traffic.get("planted_share", 0)
    if not share or traffic.get("whole_chromosome"):
        return 0
    motifs = [probs / probs.sum(axis=0) for _, _, probs, _ in
              parse_meme(meme)]
    kmax = max(p.shape[1] for p in motifs)
    chosen = np.flatnonzero(rng.random(len(spans)) < share)
    n = len(chosen)
    which = rng.integers(0, len(motifs), n)
    shift = rng.integers(-traffic["planted_offset_bp"],
                         traffic["planted_offset_bp"] + 1, n)
    reverse = rng.random(n) < 0.5
    draws = rng.random((n, kmax))
    for i, m, d, rc, u in zip(chosen.tolist(), which.tolist(),
                              shift.tolist(), reverse.tolist(), draws):
        probs = motifs[m]
        k = probs.shape[1]
        s, e = spans[i]
        if e - s < k:
            continue
        start = min(max(s, (s + e - k) // 2 + d), e - k)
        codes = np.minimum((u[:k] > np.cumsum(probs, axis=0)).sum(axis=0),
                           3).astype(np.uint8)
        seq[start:start + k] = 3 - codes[::-1] if rc else codes
    return n


def sites_near(g: dict, spans) -> np.ndarray:
    """Indices of the variants whose span meets a region (each padded by
    the longest indel): the ones a region's windows can pass through."""
    starts = np.array([s for s, _ in spans], np.int64)
    stops = np.array([e for _, e in spans], np.int64)
    pad = int(g["length"].max(initial=1)) + 1
    pos = g["pos"]
    i = np.searchsorted(starts, pos, side="right") - 1
    near = (i >= 0) & (pos <= stops[np.maximum(i, 0)] + pad)
    nxt = np.minimum(i + 1, len(starts) - 1)
    near |= pos + pad >= starts[nxt]
    return np.flatnonzero(near)


def make(cfg: dict, traffic: dict, seed: int, outdir: str,
         graph: bool = True) -> dict:
    """Every input of one run of a cell into ``outdir``, the graph unless
    ``graph`` is false; returns counts and the seconds of each step."""
    os.makedirs(outdir, exist_ok=True)
    g_rng, t_rng, c_rng = streams(seed)
    chrom = cfg["chrom"]
    out = {}
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, cfg["motif_file"])) as f:
        meme = f.read()
    g = chromosome(g_rng, cfg)
    spans = regions(t_rng, traffic, cfg["length_bp"])
    out["planted"] = plant(t_rng, g["seq"], spans, traffic, meme)
    near = sites_near(g, spans)
    keep = np.zeros(len(g["pos"]), bool)
    keep[near] = True
    out["draw_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_fasta(os.path.join(outdir, "ref.fa"), chrom, g["seq"])
    bits = write_vcf(os.path.join(outdir, "synth.vcf.gz"), chrom, g, c_rng,
                     keep)
    out["write_s"] = time.perf_counter() - t0
    with open(os.path.join(outdir, "regions.bed"), "w") as f:
        f.writelines(f"chr{chrom}\t{s}\t{e}\n" for s, e in spans)
    with open(os.path.join(outdir, "motifs.meme"), "w") as f:
        f.write(meme)
    # the reference reads the sites that the regions reach, with their
    # carriers; the port reads the VCF
    np.savez(os.path.join(outdir, "truth.npz"), seq=g["seq"],
             pos=g["pos"][near], kind=g["kind"][near],
             length=g["length"][near], ins_bases=g["ins_bases"][near],
             alt=(g["seq"][g["pos"][near]] + 1) % 4, carriers=bits,
             haplotypes=g["haplotypes"],
             regions=np.array(spans, np.int64).reshape(-1, 2))
    out.update(variants=len(g["pos"]),
               indels=int((g["kind"] != SNP).sum()), regions=len(spans),
               vcf_bytes=os.path.getsize(os.path.join(outdir,
                                                      "synth.vcf.gz")))
    del g
    if not graph:
        return out
    from grafimo_tpu_torch.cli import main as port_cli

    t0 = time.perf_counter()
    gdir = os.path.join(outdir, "graphs")
    rc = port_cli(["buildvg", "-l", os.path.join(outdir, "ref.fa"),
                   "-v", os.path.join(outdir, "synth.vcf.gz"), "-o", gdir])
    if rc != 0:
        raise RuntimeError(f"buildvg exited {rc}")
    out["buildvg_s"] = time.perf_counter() - t0
    (name,) = [n for n in os.listdir(gdir) if n.endswith(".gvt.npz")]
    out["graph"] = os.path.join(gdir, name)
    out["graph_bytes"] = os.path.getsize(out["graph"])
    return out


if __name__ == "__main__":
    config_path, traffic_path, seed, outdir = sys.argv[1:5]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(config_path) as f:
        config = json.load(f)
    with open(traffic_path) as f:
        traffic = json.load(f)
    print(json.dumps(make(config, traffic, int(seed), outdir)))
