"""The plain reference: what a ``findmotif`` report over a variation graph
must hold, worked out in NumPy from the benchmark's own inputs (the drawn
sequence and variants, the BED regions and the MEME text).  It reads no
file the port wrote and imports nothing of the port.

The semantics are GRAFIMO's (Tognon et al., PLOS Comput Biol 2021):

* motifs: MEME probabilities, pseudocount ``0.1`` against the uniform
  background, log-odds in bits (``ln(x) * 1.44269504``), scaled to
  integers over ``[0, 1000]``; the p-value of an integer score is the
  tail of its background score distribution (Staden's convolution);
* windows: every walk of ``k`` bases through the region's graph, any mix
  of alleles (observed or not), inside the region; its coordinates are
  the reference projections of its first base and of the base after its
  last, swapped on the reverse strand; its haplotype frequency counts the
  haplotypes carrying every allele choice the walk makes; ``ref`` when
  it leaves the reference path nowhere and spans ``k`` bases;
* report: the windows of either strand with ``p < threshold`` carried by
  a haplotype, with the Benjamini-Hochberg q-value over every window of
  every region and strand.

``dtype`` is the floating type of the p-values, the q-values and the
score distribution behind them.
"""

import os

import numpy as np

RANGE = 1000
LOG2_FACTOR = 1.44269504
PSEUDO_BG = 0.0000005
PSEUDOCOUNT = 0.1
CODE = np.full(256, 255, np.uint8)
CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
LETTERS = np.frombuffer(b"ACGT", np.uint8)
SNP, DELETION, INSERTION = 0, 1, 2


def parse_meme(text: str):
    """``[(id, name, probs (4, k), nsites)]`` from a MEME file's text."""
    motifs = []
    lines = iter(text.splitlines())
    for line in lines:
        if not line.startswith("MOTIF"):
            continue
        words = line.split()
        mid, name = (words[1], words[1]) if len(words) == 2 else words[1:3]
        for line in lines:
            if line.startswith("letter-probability matrix:"):
                break
        k = int(line.split("w=")[1].split()[0])
        nsites = int(line.split("nsites=")[1].split()[0])
        rows = [next(lines).split() for _ in range(k)]
        probs = np.array(rows, np.float64).T
        motifs.append((mid, name, probs, nsites))
    return motifs


def uniform_background() -> float:
    """Each base's background probability after the pseudo-count
    normalisation of a uniform background."""
    tot = 4 * PSEUDO_BG
    for _ in range(4):
        tot += 0.25
    return (0.25 + PSEUDO_BG) / tot


def score_matrix(probs: np.ndarray, nsites: int):
    """The integer ``(4, k)`` score matrix, its scale and its offset."""
    bg = uniform_background()
    probs = probs.copy()
    for j in range(probs.shape[1]):
        tot = 0.0
        for i in range(4):
            tot += probs[i, j]
        if abs(tot - 1.0) > 0.00001:
            probs[:, j] = probs[:, j] / tot
    probs = (probs * nsites + PSEUDOCOUNT * bg) / (nsites + PSEUDOCOUNT)
    log_odds = np.log(probs / bg) * LOG2_FACTOR
    lower, upper = log_odds.min(), log_odds.max()
    if lower == upper:
        lower = upper - 1
    lower = np.floor(lower)
    offset = np.round(lower)
    scale = np.floor(RANGE / (upper - lower))
    return np.round((log_odds - offset) * scale).astype(np.int64), \
        int(scale), float(offset)


def pvalue_of_score(scores: np.ndarray, dtype) -> np.ndarray:
    """p-value of every integer score ``0 .. RANGE * k`` of a score
    matrix, in ``dtype``: the background mass of the scores at or above
    it over the whole mass."""
    k = scores.shape[1]
    bg = dtype(uniform_background())
    dist = np.zeros(RANGE * k + 1, dtype)
    for i in range(4):
        dist[scores[i, 0]] += bg
    for j in range(1, k):
        nxt = np.zeros_like(dist)
        for i in range(4):
            s = scores[i, j]
            nxt[s:] += dist[:len(dist) - s] * bg
        dist = nxt
    tail = np.cumsum(dist[::-1], dtype=dtype)[::-1]
    return (tail / tail[0]).astype(dtype)


def bh_qvalues(hist: np.ndarray, pvals: np.ndarray, dtype) -> np.ndarray:
    """Benjamini-Hochberg q-value of every score over ``hist``, the count
    of windows at each score; windows with equal p-values tie."""
    occupied = np.flatnonzero(hist)
    p_occ = pvals[occupied]
    p_uniq, inverse = np.unique(p_occ, return_inverse=True)
    counts = np.bincount(inverse, weights=hist[occupied]).astype(np.int64)
    n = counts.sum()
    raw = p_uniq / (np.cumsum(counts) / dtype(n)).astype(dtype)
    q = np.minimum.accumulate(raw[::-1])[::-1]
    q = np.minimum(q, 1).astype(dtype)
    out = np.full(len(hist), np.nan, dtype)
    out[occupied] = q[inverse]
    return out


class Variants:
    """The chromosome's sites in trimmed form: a SNP spans its base, a
    deletion the bases it removes, an insertion no base (it sits before
    ``start``); each with its reference and alternative allele and the
    haplotypes that carry the alternative."""

    def __init__(self, truth):
        self.letters = LETTERS[truth["seq"]].tobytes()
        pos, kind, length = truth["pos"], truth["kind"], truth["length"]
        self.n_hap = int(truth["haplotypes"])
        self.start = pos.astype(np.int64)
        self.end = np.where(kind == INSERTION, pos, pos + length)
        self.end = self.end.astype(np.int64)
        self.ref, self.alt = [], []
        for p, kd, ln, ins, alt in zip(pos.tolist(), kind.tolist(),
                                       length.tolist(), truth["ins_bases"],
                                       truth["alt"].tolist()):
            if kd == SNP:
                self.ref.append(self.letters[p:p + 1])
                self.alt.append(b"ACGT"[alt:alt + 1])
            elif kd == DELETION:
                self.ref.append(self.letters[p:p + ln])
                self.alt.append(b"")
            else:
                self.ref.append(b"")
                self.alt.append(LETTERS[ins[:ln]].tobytes())
        self.carriers = truth["carriers"]

    def frequency(self, choices) -> int:
        """Haplotypes carrying each ``(site, allele)`` choice."""
        ok = np.ones(self.n_hap, bool)
        for site, allele in choices:
            alt = np.unpackbits(self.carriers[site],
                                count=self.n_hap).astype(bool)
            ok &= alt if allele else ~alt
        return int(ok.sum())


def region_walks(var: Variants, rs: int, re_: int, k: int, out: dict,
                 lo: int, hi: int):
    """Append every walk of ``k`` bases inside region ``[rs, re_]`` that
    starts at a coordinate in ``[lo, hi)`` to ``out``'s lists: first-base
    and after-last-base coordinates, bases, whether it stays on the
    reference path, and its allele choices.

    The graph is the chain segment 0, site 0, segment 1, ..., site n - 1,
    segment n, where segment ``j`` holds the reference bases between
    sites ``j - 1`` and ``j``; a walk takes one allele at each site it
    enters (an empty allele passes the site by) and stops once an element
    starts past the region."""
    seq, starts, ends = var.letters, var.start, var.end
    n = len(starts)
    lo, hi = max(lo, rs), min(hi, re_)

    def segment(j):
        return (int(ends[j - 1]) if j else 0,
                int(starts[j]) if j < n else len(seq))

    def finish(begin, end, bases, is_ref, choices):
        if end <= re_:
            out["begin"].append(begin)
            out["end"].append(end)
            out["bases"].append(bases)
            out["is_ref"].append(is_ref)
            out["choices"].append(choices)

    def allele_end(site, taken, allele_len):
        if taken == allele_len:
            return int(ends[site])
        return min(int(starts[site]) + taken, int(ends[site]))

    def walk(begin, j, need, bases, is_ref, choices):
        """Complete a walk that has ``need`` bases to go from segment
        ``j`` on."""
        a, b = segment(j)
        if b > a:
            if a > re_:
                return
            if b - a >= need:
                finish(begin, a + need, bases + seq[a:a + need], is_ref,
                       choices)
                return
            bases += seq[a:b]
            need -= b - a
        if j == n:
            return
        site(begin, j, need, bases, is_ref, choices)

    def site(begin, j, need, bases, is_ref, choices):
        """Complete a walk that enters site ``j`` with ``need`` to go."""
        if starts[j] > re_:
            return
        for allele, al in enumerate((var.ref[j], var.alt[j])):
            ch = choices + ((j, allele),)
            ref_path = is_ref and (allele == 0 or not al)
            if len(al) >= need:
                finish(begin, allele_end(j, need, len(al)),
                       bases + al[:need], ref_path, ch)
            else:
                walk(begin, j + 1, need - len(al), bases + al, ref_path, ch)

    j = max(int(np.searchsorted(starts, lo, side="right")) - 1, 0)
    while j <= n:
        a, b = segment(j)
        if a >= hi:
            break
        for c in range(max(a, lo), min(b, hi)):
            if b - c >= k:
                finish(c, c + k, seq[c:c + k], True, ())
            elif j < n:
                site(c, j, k - (b - c), seq[c:b], True, ())
        if j == n or starts[j] >= hi:
            break
        s0, s1 = int(starts[j]), int(ends[j])
        for allele, al in enumerate((var.ref[j], var.alt[j])):
            for o in range(len(al)):
                coord = min(s0 + o, s1)
                if not lo <= coord < hi:
                    continue
                ch = ((j, allele),)
                if len(al) - o >= k:
                    finish(coord, allele_end(j, o + k, len(al)),
                           al[o:o + k], allele == 0, ch)
                else:
                    walk(coord, j + 1, k - (len(al) - o), al[o:],
                         allele == 0, ch)
        j += 1


def motif_set(meme_text: str) -> dict:
    """``{k: [(id, name, score matrix, scale, offset)]}``."""
    by_width = {}
    for mid, name, probs, nsites in parse_meme(meme_text):
        by_width.setdefault(probs.shape[1], []).append(
            (mid, name, *score_matrix(probs, nsites)))
    return by_width


def scan_part(truth_path: str, meme_text: str, threshold: float, dtype,
              items) -> dict:
    """One share of the scan: the walks starting in each ``(region, lo,
    hi)`` of ``items``, scored on both strands by every motif.  Returns
    the walks a strand per width, each motif's score histogram, and the
    rows of its hits carried by a haplotype (``score`` as an integer)."""
    with np.load(truth_path) as f:
        truth = {key: f[key] for key in f.files}
    var = Variants(truth)
    regions = truth["regions"].tolist()
    part = {"windows": {}, "hist": {}, "rows": {}}
    for k, motifs in motif_set(meme_text).items():
        out = {key: [] for key in ("begin", "end", "bases", "is_ref",
                                   "choices")}
        region = []
        for ri, lo, hi in items:
            before = len(out["begin"])
            region_walks(var, *regions[ri], k, out, lo, hi)
            region.extend([ri] * (len(out["begin"]) - before))
        codes = CODE[np.frombuffer(b"".join(out["bases"]), np.uint8)]
        codes = codes.reshape(-1, k)
        strands = (("+", codes), ("-", 3 - codes[:, ::-1]))
        part["windows"][k] = len(region)
        cols = np.arange(k)
        for mid, _name, scores, _scale, _offset in motifs:
            pvals = pvalue_of_score(scores, dtype)
            hist = np.zeros(len(pvals), np.int64)
            rows = {c: [] for c in ("sequence_name", "start", "stop",
                                    "strand", "score", "matched_sequence",
                                    "haplotype_frequency", "reference")}
            for strand, c in strands:
                sc = scores[c, cols].sum(1)
                hist += np.bincount(sc, minlength=len(pvals))
                for i in np.flatnonzero(pvals[sc] < threshold).tolist():
                    freq = var.frequency(out["choices"][i])
                    if freq == 0:
                        continue
                    begin, end = out["begin"][i], out["end"][i]
                    start, stop = ((begin, end) if strand == "+"
                                   else (end, begin))
                    rs, re_ = regions[region[i]]
                    rows["sequence_name"].append(f"{rs}-{re_}")
                    rows["start"].append(start)
                    rows["stop"].append(stop)
                    rows["strand"].append(strand)
                    rows["score"].append(int(sc[i]))
                    rows["matched_sequence"].append(
                        LETTERS[c[i]].tobytes().decode())
                    rows["haplotype_frequency"].append(freq)
                    rows["reference"].append(
                        "ref" if out["is_ref"][i] and abs(stop - start) == k
                        else "non.ref")
            part["hist"][mid] = hist
            part["rows"][mid] = rows
    return part


def shares(regions, n: int):
    """The regions' start coordinates cut into about ``n`` shares of
    ``(region, lo, hi)`` items."""
    total = sum(re_ - rs for rs, re_ in regions)
    size = max(1, -(-total // n))
    out, cur, room = [], [], size
    for ri, (rs, re_) in enumerate(regions):
        lo = rs
        while lo < re_:
            hi = min(re_, lo + room)
            cur.append((ri, lo, hi))
            room -= hi - lo
            lo = hi
            if room == 0:
                out.append(cur)
                cur, room = [], size
    return out + ([cur] if cur else [])


def report(truth_path: str, meme_text: str, chrom: str, threshold: float,
           dtype=np.float64) -> dict:
    """The report rows of every motif, ``{motif_id: columns}``, and what
    the scan counted: walks a strand per width, window-strand-motif
    scorings and their ``k`` adds, and the bases read (each region's
    reference bases and inserted bases once).  The scan's shares run on
    a process a core, up to eight."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with np.load(truth_path) as f:
        regions = [tuple(r) for r in f["regions"].tolist()]
        var_start, kind, length = f["pos"], f["kind"], f["length"]
    workers = min(8, os.cpu_count() or 1)
    parts = shares(regions, 4 * workers)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(scan_part, [truth_path] * len(parts),
                             [meme_text] * len(parts),
                             [threshold] * len(parts),
                             [dtype] * len(parts), parts))
    by_width = motif_set(meme_text)
    work = {"windows_per_strand": {}, "scorings": 0, "adds": 0, "bases": 0}
    inserted = np.where(kind == INSERTION, length, 0)
    for rs, re_ in regions:
        lo, hi = np.searchsorted(var_start, [rs, re_])
        work["bases"] += int(re_ - rs + inserted[lo:hi].sum())
    rows = {}
    for k, motifs in by_width.items():
        n = sum(p["windows"][k] for p in done)
        work["windows_per_strand"][k] = n
        work["scorings"] += 2 * n * len(motifs)
        work["adds"] += 2 * n * len(motifs) * k
        for mid, name, scores, scale, offset in motifs:
            pvals = pvalue_of_score(scores, dtype)
            qvals = bh_qvalues(sum(p["hist"][mid] for p in done), pvals,
                               dtype)
            cols = {c: [x for p in done for x in p["rows"][mid][c]]
                    for c in done[0]["rows"][mid]}
            score = np.array(cols["score"], np.int64)
            rows[mid] = {
                "motif_id": [mid] * len(score),
                "motif_alt_id": [name] * len(score),
                "sequence_name": [f"{chrom}:{r}"
                                  for r in cols["sequence_name"]],
                "start": cols["start"], "stop": cols["stop"],
                "strand": cols["strand"],
                "score": (score / scale + k * offset).tolist(),
                "p-value": pvals[score].astype(np.float64).tolist(),
                "q-value": qvals[score].astype(np.float64).tolist(),
                "matched_sequence": cols["matched_sequence"],
                "haplotype_frequency": cols["haplotype_frequency"],
                "reference": cols["reference"],
            }
    return {"rows": rows, "work": work}
