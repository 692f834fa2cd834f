"""GFA v1 import/export — interoperability with the vg toolkit.

Users of the reference pipeline hold ``vg``-built graphs (VG/XG); ``vg view
-g graph.vg`` emits GFA v1, which this module ingests, and
:func:`sitegraph_to_gfa` exports this framework's graphs for inspection with
vg/Bandage.

Import strategy: a VCF-derived variation graph is a linear reference
backbone with local bubbles.  The importer walks the reference path (``P``
line), classifies every off-path node chain as an alt allele (SNP/MNP/
insertion), every path-skipping edge as a deletion, reconstructs the
equivalent variant records and rebuilds through the standard
:func:`~grafimo_tpu.graph.sitegraph.build_graph` — so node numbering,
site decomposition and every downstream engine behave identically to a
FASTA+VCF build.  Graphs with nested bubbles or non-linear structure are
rejected with a clear error.

Haplotypes: plain GFA 1.0 exports (``vg view -g``) carry no GBWT threads,
so such imports have no haplotype index (every window reports frequency 0,
like the reference's toy GBWT).  GFA 1.1 **W lines** (walks) DO carry
haplotypes — this importer converts them into the bitset index, and the
exporter emits them — so graphs round-trip with frequencies intact.
"""

from typing import Dict, List, Optional, Set, Tuple

from grafimo_tpu_torch.errors import GraphError
from grafimo_tpu_torch.graph.sitegraph import SiteGraph, build_graph
from grafimo_tpu_torch.io.vcf import VcfRecord


def parse_gfa(path: str):
    """Parse S/L/P/W lines; returns (segments, links, paths, walks).

    ``walks`` (GFA 1.1 W lines) carry haplotypes: one entry per
    (sample, hap-index, contig) with the ordered node list.
    """
    segments: Dict[str, str] = {}
    links: List[Tuple[str, str, str, str]] = []
    paths: Dict[str, List[Tuple[str, str]]] = {}
    walks: List[Tuple[str, int, str, List[str]]] = []
    with open(path) as handle:
        for line in handle:
            fields = line.rstrip("\n").split("\t")
            if not fields:
                continue
            if fields[0] == "S":
                segments[fields[1]] = fields[2].upper()
            elif fields[0] == "L":
                links.append((fields[1], fields[2], fields[3], fields[4]))
            elif fields[0] == "P":
                steps = []
                for step in fields[2].split(","):
                    step = step.strip()
                    if step:
                        steps.append((step[:-1], step[-1]))
                paths[fields[1]] = steps
            elif fields[0] == "W" and len(fields) >= 7:
                walk = fields[6]
                nodes = []
                cur = ""
                for ch in walk:
                    if ch in "><":
                        if cur:
                            nodes.append(cur)
                        cur = ""
                    else:
                        cur += ch
                if cur:
                    nodes.append(cur)
                walks.append((fields[1], int(fields[2]), fields[3], nodes))
    return segments, links, paths, walks


def _warn(msg: str) -> None:
    import sys

    sys.stderr.write(f"\033[33mWARNING: {msg}\033[0m\n")


def gfa_to_sitegraph(
    path: str,
    chrom: Optional[str] = None,
    gbwt: Optional[str] = None,
    strict: bool = False,
) -> SiteGraph:
    """Import a vg-style GFA as a :class:`SiteGraph`.

    GFA 1.1 W (walk) lines, when present, are converted into the haplotype
    bitset index (one haplotype per full-length walk of the imported
    contig); plain GFA 1.0 files import without haplotypes.  For vg
    exports that predate W lines, a binary ``.gbwt`` sidecar (``gbwt=``,
    or auto-detected next to the GFA by :func:`grafimo_tpu.workflows.
    load_graph_file`) supplies the haplotype walks instead
    (``graph/gbwt.py``; reference keeps haplotypes in exactly such a
    GBWT, ``constructVG.py:327-340``).

    Degradation policy: structure this importer cannot flatten into site
    alleles (cyclic/dead-end/over-budget snarls, backward links,
    unreachable segments) is LOCAL to one variant site — by default the
    offending site is skipped with a warning and the rest of the
    chromosome imports, mirroring the failed-region warn-and-continue of
    the scan itself (reference ``extract_regions.py:328-331``).
    ``strict=True`` restores hard errors.
    """
    segments, links, paths, walks = parse_gfa(path)
    return tuples_to_sitegraph(
        path, segments, links, paths, walks,
        chrom=chrom, gbwt=gbwt, strict=strict,
    )


def tuples_to_sitegraph(
    path: str,
    segments: Dict[str, str],
    links: List[Tuple[str, str, str, str]],
    paths: Dict[str, List[Tuple[str, str]]],
    walks: List[Tuple[str, int, str, List[str]]],
    *,
    chrom: Optional[str] = None,
    gbwt: Optional[str] = None,
    strict: bool = False,
) -> SiteGraph:
    """Snarl-flattening core shared by the GFA and ``.vg`` protobuf
    front-ends (``graph/vgproto.py``): both formats reduce to the same
    (segments, links, paths, walks) tuples; ``path`` labels warnings."""
    if not walks and gbwt:
        from grafimo_tpu_torch.graph.gbwt import gbwt_walks

        ref_name = chrom if chrom is not None else next(iter(paths), None)
        walks = gbwt_walks(gbwt, contig=ref_name)
    if not paths:
        raise GraphError(f"{path}: no P (path) line — cannot identify the "
                         f"reference backbone")
    if chrom is None:
        chrom = next(iter(paths))
    if chrom not in paths:
        raise GraphError(f"{path}: no path named {chrom!r}")
    ref_steps = paths[chrom]
    if any(o != "+" for _, o in ref_steps):
        raise GraphError("reverse-oriented reference path steps are not "
                        "supported")
    ref_nodes = [n for n, _ in ref_steps]
    ref_set: Set[str] = set(ref_nodes)
    # ref coordinates per backbone node
    start_of: Dict[str, int] = {}
    end_of: Dict[str, int] = {}
    pos = 0
    for n in ref_nodes:
        if n not in segments:
            raise GraphError(f"path references unknown segment {n}")
        start_of[n] = pos
        pos += len(segments[n])
        end_of[n] = pos
    seq = "".join(segments[n] for n in ref_nodes)
    ref_next = {
        ref_nodes[i]: ref_nodes[i + 1] for i in range(len(ref_nodes) - 1)
    }

    # adjacency (forward orientation only — vg VCF graphs are + / +)
    succs: Dict[str, List[str]] = {}
    preds: Dict[str, List[str]] = {}
    for u, uo, v, vo in links:
        if uo != "+" or vo != "+":
            if strict:
                raise GraphError(
                    "reverse-oriented links are not supported"
                )
            _warn(
                f"{path}: skipping reverse-oriented link {u}{uo} -> "
                f"{v}{vo} (inversions are not representable as site "
                f"alleles)"
            )
            continue
        succs.setdefault(u, []).append(v)
        preds.setdefault(v, []).append(u)

    # collect alt alleles per (anchor_end_coord, reattach_start_coord):
    # (allele string, node chain — () for deletion edges).  Off-backbone
    # structure is flattened by snarl-path enumeration: from every
    # backbone anchor, ALL simple paths through off-path nodes up to the
    # first backbone node become alleles — so nested/branching bubbles
    # (e.g. vg construct sharing common alt prefixes, or bubbles inside
    # bubbles from overlapping records) import exactly, not just linear
    # chains.
    site_alleles: Dict[
        Tuple[int, int], List[Tuple[str, Tuple[str, ...]]]
    ] = {}

    def add_allele(
        span: Tuple[int, int], allele: str, chain: Tuple[str, ...]
    ) -> None:
        site_alleles.setdefault(span, []).append((allele, chain))

    MAX_SNARL_PATHS = 4096
    covered: Set[str] = set()
    tolerated: Set[str] = set()  # off-path nodes of skipped snarls

    def _off_reachable(starts: List[str]) -> Set[str]:
        """All off-path nodes reachable from a snarl's entry points
        (bounded BFS; cycles terminate via the visited set)."""
        seen: Set[str] = set()
        frontier = [s for s in starts if s not in ref_set]
        while frontier:
            cur = frontier.pop()
            if cur in seen:
                continue
            seen.add(cur)
            frontier.extend(
                t for t in succs.get(cur, []) if t not in ref_set
            )
        return seen

    def _flatten_snarl(left: str, off_starts: List[str]):
        """All simple paths from ``left`` through off-path nodes to the
        backbone, as (span, allele, chain) triples; raises GraphError on
        structure it cannot flatten."""
        local: List[Tuple[Tuple[int, int], str, Tuple[str, ...]]] = []
        pushes = 0
        # iterative DFS over simple paths through off-path nodes
        stack: List[List[str]] = [[s] for s in reversed(off_starts)]
        while stack:
            pushes += 1
            if pushes > MAX_SNARL_PATHS * 64:
                raise GraphError(
                    f"snarl at {left}: path enumeration exceeds the "
                    "search budget; graph is too tangled to flatten"
                )
            chain = stack.pop()
            cur = chain[-1]
            nxt = succs.get(cur, [])
            if not nxt:
                raise GraphError(
                    f"off-path segment {cur} is a dead end: graph has no "
                    "reattachment to the reference path"
                )
            for t in nxt:
                if t in ref_set:
                    # equality = pure insertion between adjacent backbone
                    # nodes (empty ref span)
                    if start_of[t] < end_of[left]:
                        raise GraphError(
                            f"backward off-path reattachment at {t}"
                        )
                    if len(local) >= MAX_SNARL_PATHS:
                        raise GraphError(
                            f"snarl at {left} exceeds {MAX_SNARL_PATHS} "
                            "paths; graph is too tangled to flatten into "
                            "site alleles"
                        )
                    local.append((
                        (end_of[left], start_of[t]),
                        "".join(segments[c] for c in chain),
                        tuple(chain),
                    ))
                elif t in chain:
                    raise GraphError(
                        f"cyclic off-path structure at segment {t}"
                    )
                else:
                    stack.append(chain + [t])
        return local

    for left in ref_nodes:
        off_starts = [s for s in succs.get(left, []) if s not in ref_set]
        if not off_starts:
            continue
        try:
            local = _flatten_snarl(left, off_starts)
        except GraphError as e:
            if strict:
                raise
            _warn(
                f"{path}: skipping variant site at segment {left} "
                f"(~ref coord {end_of[left]}): {e}"
            )
            tolerated |= _off_reachable(off_starts)
            continue
        for span, allele, chain in local:
            covered.update(chain)
            add_allele(span, allele, chain)
    orphans = [
        n
        for n in segments
        if n not in ref_set and n not in covered and n not in tolerated
    ]
    if orphans:
        msg = (
            f"segments unreachable from the reference path: "
            f"{sorted(orphans)[:5]}"
            f"{' ...' if len(orphans) > 5 else ''} "
            f"({len(orphans)} total; their variants will not be scanned)"
        )
        if strict:
            raise GraphError(msg)
        _warn(f"{path}: {msg}")

    # deletion edges: backbone links skipping ref nodes
    for u, uo, v, vo in links:
        if u in ref_set and v in ref_set and ref_next.get(u) != v:
            if start_of[v] <= end_of[u]:
                if strict:
                    raise GraphError("backward reference link")
                _warn(
                    f"{path}: skipping backward reference link "
                    f"{u} -> {v}"
                )
                continue
            add_allele((end_of[u], start_of[v]), "", ())

    # synthesise VCF-style records (anchor-base convention; build_graph
    # re-trims) and rebuild through the standard constructor
    records: List[VcfRecord] = []
    spans: List[Tuple[int, int]] = []
    allele_lists: List[List[str]] = []
    for (s, e), alleles in sorted(site_alleles.items()):
        if s == 0:
            msg = ("variant at contig start is not representable "
                   "with an anchor base")
            if strict:
                raise GraphError(msg)
            _warn(f"{path}: skipping site at coord 0: {msg}")
            continue
        anchor = seq[s - 1]
        ref_allele = anchor + seq[s:e]
        alts = [anchor + a for a, _ in alleles]
        records.append(
            VcfRecord(chrom=chrom, pos=s, ref=ref_allele, alts=alts, gt=None)
        )
        spans.append((s, e))
        allele_lists.append(alleles)

    # haplotypes from W lines: for each full-length walk decide, per site,
    # which allele chain the walk contains (absence of every non-empty
    # allele's nodes means the unique empty allele: a deletion, or the
    # reference side of an insertion)
    contig_walks = [w for w in walks if w[2] == chrom]
    if contig_walks:
        ref_cover: Dict[Tuple[int, int], List[str]] = {}
        for (s, e) in spans:
            ref_cover[(s, e)] = [
                n for n in ref_nodes if s <= start_of[n] < e
            ]
        walk_sets = [set(nodes) for (_s, _h, _c, nodes) in contig_walks]
        for ri, (span, alleles) in enumerate(zip(spans, allele_lists)):
            # alleles of branching snarls can share nodes (common
            # prefixes), so a walk matches the allele whose chain equals
            # the walk's footprint inside this site's node universe
            universe: Set[str] = set()
            for _a, chain in alleles:
                universe.update(chain)
            gts = []
            for node_set in walk_sets:
                footprint = node_set & universe
                allele_idx = None
                for ai, (_a, chain) in enumerate(alleles):
                    if chain and footprint == set(chain):
                        allele_idx = ai + 1  # 1-based alt index
                        break
                if allele_idx is None:
                    # ref nodes present -> ref; absent -> the empty alt
                    if all(n in node_set for n in ref_cover[span]) and (
                        ref_cover[span] or span[0] == span[1]
                    ):
                        allele_idx = 0
                    else:
                        empties = [
                            ai + 1
                            for ai, (a, _c) in enumerate(alleles)
                            if a == ""
                        ]
                        allele_idx = empties[0] if empties else 0
                gts.append(allele_idx)
            records[ri].gt = gts
        return build_graph(
            chrom, seq, records, with_haplotypes=True,
            prune_composite=True,
        )
    return build_graph(
        chrom, seq, records, with_haplotypes=False, prune_composite=True
    )


def _haplotype_walks(graph: SiteGraph) -> List[Tuple[int, List[int]]]:
    """Per-haplotype node walks derived from the bitset index."""
    haplo = graph.haplo
    if haplo is None:
        return []
    if haplo.n_hap * max(1, len(graph.sites)) > 50_000_000:
        import sys

        sys.stderr.write(
            "\033[33mWARNING: skipping W-line export "
            f"({haplo.n_hap} haplotypes x {len(graph.sites)} sites is too "
            "large); re-export with include_haplotypes=False to silence\033[0m\n"
        )
        return []
    walks = []
    for h in range(haplo.n_hap):
        word, bit = h >> 6, h & 63
        allele_of = {}
        for sid, rows in enumerate(haplo.site_allele_rows):
            allele_of[sid] = 0
            for a, row in rows.items():
                if (int(haplo.alt_bits[row][word]) >> bit) & 1:
                    allele_of[sid] = a
                    break
        nodes: List[int] = []
        for kind, idx in graph.elements:
            if kind == "seg":
                nodes.append(idx)
            else:
                site = graph.sites[idx]
                a = allele_of.get(site.site_id, 0)
                nid = site.allele_nodes[a]
                if nid:
                    nodes.append(nid)
        walks.append((h, nodes))
    return walks


def sitegraph_to_gfa(
    graph: SiteGraph, path: str, include_haplotypes: bool = True
) -> None:
    """Export as GFA v1 (S/L lines for every node and edge, one P line for
    the reference path, and — when a haplotype index exists and
    ``include_haplotypes`` — one GFA 1.1 W line per haplotype so
    frequencies survive a round trip)."""
    lines = ["H\tVN:Z:1.0"]
    for nid in range(1, graph.n_nodes + 1):
        if graph.node_seqs[nid]:
            lines.append(f"S\t{nid}\t{graph.node_seqs[nid]}")
    links: List[Tuple[int, int]] = []
    prev_tails: List[int] = []

    def connect(tails: List[int], heads: List[int]) -> None:
        for t in tails:
            for h in heads:
                links.append((t, h))

    ref_path: List[int] = []
    for kind, idx in graph.elements:
        if kind == "seg":
            connect(prev_tails, [idx])
            prev_tails = [idx]
            ref_path.append(idx)
        else:
            site = graph.sites[idx]
            heads, tails = [], []
            passthrough = False
            for a_idx, allele in enumerate(site.alleles):
                nid = site.allele_nodes[a_idx]
                if allele == "" or nid == 0:
                    passthrough = True
                    continue
                heads.append(nid)
                tails.append(nid)
                if a_idx == 0:
                    ref_path.append(nid)
            connect(prev_tails, heads)
            if passthrough:
                tails = tails + prev_tails
            prev_tails = tails
    for t, h in sorted(set(links)):
        lines.append(f"L\t{t}\t+\t{h}\t+\t0M")
    lines.append(
        f"P\t{graph.chrom}\t" + ",".join(f"{n}+" for n in ref_path) + "\t*"
    )
    if include_haplotypes:
        for h, nodes in _haplotype_walks(graph):
            walk = "".join(f">{n}" for n in nodes)
            lines.append(
                f"W\tsample{h // 2}\t{h % 2}\t{graph.chrom}\t0\t"
                f"{graph.length}\t{walk}"
            )
    with open(path, "w") as out:
        out.write("\n".join(lines) + "\n")
