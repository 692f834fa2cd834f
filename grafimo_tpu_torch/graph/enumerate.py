"""Haplotype-aware k-window enumeration over a site graph.

Replaces the reference's per-region ``vg find -p chrom:start-stop -x .xg -H
.gbwt -K k -E`` subprocess calls (``extract_regions.py:180,225``).  Output
semantics reproduce the vg kmer table observed in the reference fixtures
(``expected_seqs.tsv``, ``width_19/scoring_test_input.tsv``):

* every walk of ``k`` path-bases whose reference-projected span lies inside
  ``[region_start, region_end]`` is emitted, i.e. all combinations of
  variant alleles inside the window (observed and recombinant alike);
* coordinates are the reference projections of the window's first base
  (``begin``) and of the position following its last base (``end``); with a
  deletion inside the window ``end - begin > k``;
* forward rows report ``(begin, end)``; reverse-complement rows swap them
  (``x:0+ x:19+`` / ``x:19- x:0-`` in the toy oracle);
* the ``ref`` flag means the walk touches only reference-path nodes — a
  deletion-skipping walk is still ``ref`` here and is reclassified by span
  at scoring time, exactly like vg + the reference's fix
  (``score_sequences.py:305-307``);
* the haplotype frequency is the number of GBWT-style haplotype threads
  containing the walk as a subpath, computed from phased-genotype bitsets
  (:mod:`grafimo_tpu.graph.haplo`).  A site constrains the count only when
  the walk traverses its choice region (entering an allele node, or
  crossing a deletion/insertion point), which is precisely GBWT subpath
  semantics.  (Note: the reference's bundled toy GBWT reports frequency 0
  for every window — an artifact its own test inherits; this engine counts
  correctly, and the toy parity test masks that column.)

The pure-python implementation here is the semantic reference; the C++
engine in :mod:`grafimo_tpu.native` reproduces it at speed (differentially
tested).
"""

from dataclasses import dataclass
from typing import Iterator, List, Tuple

from grafimo_tpu_torch.graph.sitegraph import SiteGraph


@dataclass
class Window:
    begin: int  # ref projection of first base (0-based)
    end: int  # ref projection past the last base
    seq: str
    path: List[int]  # node ids in walk order
    is_ref: bool  # all nodes on the reference path
    freq: int  # haplotype frequency (0 when no haplotype index)
    choices: Tuple[Tuple[int, int], ...] = ()  # determined (site, allele)


def enumerate_region_windows(
    graph: SiteGraph, region_start: int, region_end: int, k: int
) -> Iterator[Window]:
    """Yield every forward k-window whose span fits in ``[region_start,
    region_end]``; reverse-strand rows are derived by the caller."""
    elements = graph.elements
    n_el = len(elements)
    sites = graph.sites
    node_seqs = graph.node_seqs
    node_is_ref = graph.node_is_ref
    haplo = graph.haplo

    def allele_end(site, taken: int, allele_len: int) -> int:
        """Ref projection after consuming ``taken`` bases of an allele node:
        a fully-crossed site projects to its ref end; a window stopping
        inside the node projects to the clamped interpolation (exact for
        SNP/MNP positions, the insertion point for inserted bases)."""
        if taken == allele_len:
            return site.ref_end
        return min(site.ref_start + taken, site.ref_end)

    def walk(ei: int, remaining: int, seq_parts, path, choices):
        """Yield ``(seq, path, choices, end)`` for every completion of the
        current walk entering element ``ei`` with ``remaining`` bases due."""
        if ei >= n_el:
            return  # ran off the graph: cannot complete k bases
        kind, idx = elements[ei]
        if kind == "seg":
            start_coord = int(graph.node_ref_start[idx])
            if start_coord > region_end:
                return  # every further base pushes the span out of range
            s = node_seqs[idx]
            take = min(len(s), remaining)
            seq_parts.append(s[:take])
            path.append(idx)
            if take == remaining:
                yield (
                    "".join(seq_parts), list(path), list(choices),
                    start_coord + take,
                )
            else:
                yield from walk(ei + 1, remaining - take, seq_parts, path,
                                choices)
            seq_parts.pop()
            path.pop()
            return
        site = sites[idx]
        if site.ref_start > region_end:
            return
        for a_idx, allele in enumerate(site.alleles):
            choices.append((site.site_id, a_idx))
            if allele == "":
                # deletion edge / reference side of a pure insertion:
                # consumes nothing but determines the site
                yield from walk(ei + 1, remaining, seq_parts, path, choices)
            else:
                nid = site.allele_nodes[a_idx]
                take = min(len(allele), remaining)
                seq_parts.append(allele[:take])
                path.append(nid)
                if take == remaining:
                    yield (
                        "".join(seq_parts), list(path), list(choices),
                        allele_end(site, take, len(allele)),
                    )
                else:
                    yield from walk(ei + 1, remaining - take, seq_parts,
                                    path, choices)
                seq_parts.pop()
                path.pop()
            choices.pop()

    def finish(begin: int, completions) -> Iterator[Window]:
        for seq, path, choices, end in completions:
            if end > region_end:
                continue
            yield Window(
                begin=begin,
                end=end,
                seq=seq,
                path=path,
                is_ref=all(node_is_ref[n] for n in path),
                freq=haplo.count(choices) if haplo is not None else 0,
                choices=tuple(choices),
            )

    for ei in range(n_el):
        kind, idx = elements[ei]
        if kind == "seg":
            span_s = int(graph.node_ref_start[idx])
            span_e = int(graph.node_ref_end[idx])
            if span_s > region_end:
                break
            s = node_seqs[idx]
            for coord in range(max(span_s, region_start),
                               min(span_e, region_end)):
                o = coord - span_s
                take = min(len(s) - o, k)
                seq_parts = [s[o : o + take]]
                path = [idx]
                choices: List[Tuple[int, int]] = []
                if take == k:
                    comps = [("".join(seq_parts), list(path), [], coord + take)]
                else:
                    comps = walk(ei + 1, k - take, seq_parts, path, choices)
                yield from finish(coord, comps)
        else:
            site = sites[idx]
            if site.ref_start > region_end:
                break
            for a_idx, allele in enumerate(site.alleles):
                nid = site.allele_nodes[a_idx]
                for o in range(len(allele)):
                    coord = min(site.ref_start + o, site.ref_end)
                    if not (region_start <= coord < region_end):
                        continue
                    take = min(len(allele) - o, k)
                    seq_parts = [allele[o : o + take]]
                    path = [nid]
                    choices = [(site.site_id, a_idx)]
                    if take == k:
                        comps = [(
                            "".join(seq_parts), list(path), list(choices),
                            allele_end(site, o + take, len(allele)),
                        )]
                    else:
                        comps = walk(ei + 1, k - take, seq_parts, path,
                                     choices)
                    yield from finish(coord, comps)
