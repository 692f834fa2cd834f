"""Workflow orchestration on torch: ``buildvg`` and ``findmotif``.

Counterpart of ``grafimo_tpu/workflows.py``.  ``buildvg`` is host-only
and copied (``:70-128``) because the reference module imports jax; so
are the graph-loading helpers (``:131-302``).  ``findmotif`` runs either
engine -- the default run engine over a list of explicit torch devices,
or the per-window engine on the first of them -- in one process or, with
``--coordinator``, in several (``:366-578``; ``parallel/cluster.py``).
Options that cannot run raise with the ``ROADMAP.md`` item that records
why.
"""

import contextlib
import os
from typing import Dict, List, Sequence, Tuple

import torch

from grafimo_tpu_torch.config import BuildVG, Findmotif
from grafimo_tpu_torch.errors import GrafimoError, GraphError
from grafimo_tpu_torch.graph.sitegraph import SiteGraph, build_graph
from grafimo_tpu_torch.io.bed import read_bed_regions
from grafimo_tpu_torch.io.fasta import fasta_chrom_names, read_fasta
from grafimo_tpu_torch.io.vcf import read_vcf_records
from grafimo_tpu_torch.models.motif import MotifSet
from grafimo_tpu_torch.models.parse import load_motifs
from grafimo_tpu_torch.report.writer import print_results, write_results
from grafimo_tpu_torch.utils.constants import DEFAULT_OUTDIR
from grafimo_tpu_torch import spans
from grafimo_tpu_torch.device import check_deps
from grafimo_tpu_torch.parallel import cluster

GVT_SUFFIX = ".gvt.npz"


class NotPortedError(GrafimoError):
    """An option whose counterpart the port does not have yet."""


def print_welcome() -> None:
    """Startup banner (reference ``workflows.print_welcome``)."""
    from grafimo_tpu_torch import __version__

    print("\n" + "*" * 54)
    print("  GRAFIMO-TPU-torch — variation-graph motif scanning")
    print(f"  version {__version__} (PyTorch / CUDA)")
    print("*" * 54 + "\n")


def graph_filename(outdir: str, prefix: str, chrom: str) -> str:
    """(``grafimo_tpu/workflows.py:70``)"""
    return os.path.join(outdir, f"{prefix}{chrom}{GVT_SUFFIX}")


def buildvg(workflow: BuildVG) -> List[str]:
    """Build per-chromosome site graphs; returns the written graph paths
    (``grafimo_tpu/workflows.py:74-128``).  ``--verbose`` ends with the
    call's phase table (``spans.table``).

    ``--export`` raises: the reference's buildvg calls an
    ``_export_graph`` that its module does not define
    (``grafimo_tpu/workflows.py:113,120``; ROADMAP C4)."""
    with spans.call("buildvg_s"):
        written = _build_graphs(workflow)
    if workflow.verbose:
        print(spans.table(spans.last_call()))
    return written


def _build_graphs(workflow: BuildVG) -> List[str]:
    workflow.validate()
    if workflow.export:
        raise NotPortedError(
            "--export is not available: the reference buildvg has no "
            "_export_graph implementation to port (ROADMAP C4)"
        )
    print_welcome()
    outdir = workflow.outdir
    if outdir == DEFAULT_OUTDIR:
        outdir = os.getcwd()
    os.makedirs(outdir, exist_ok=True)
    chroms = workflow.chroms
    if not chroms:
        chroms = fasta_chrom_names(workflow.reference_genome)
    if workflow.verbose:
        print(f"Building variation graphs for chromosomes: {chroms}")
    seqs = read_fasta(workflow.reference_genome, chroms)
    written = []
    for chrom in chroms:
        if chrom not in seqs:
            raise GraphError(
                f"chromosome {chrom} not found in "
                f"{workflow.reference_genome}"
            )
        name = chrom
        if workflow.namemap:
            name = workflow.namemap.get(chrom, chrom)
        path = graph_filename(outdir, workflow.chroms_prefix, name)
        if os.path.isfile(path) and not workflow.reindex:
            # reference skips recomputing indexes unless --reindex
            # (constructVG.py:213-236)
            print(f"graph for {chrom} exists ({path}); skipping "
                  f"(use --reindex to rebuild)")
            written.append(path)
            continue
        with spans.span("vcf_read_s"):
            records, n_hap = read_vcf_records(workflow.vcf, chrom)
        with spans.span("graph_build_s"):
            graph = build_graph(chrom, seqs[chrom], records, n_hap=n_hap)
        with spans.span("graph_save_s"):
            graph.save(path)
        written.append(path)
        if workflow.verbose:
            print(
                f"graph for {chrom}: {graph.n_nodes} nodes, "
                f"{len(graph.sites)} sites, "
                f"{graph.haplo.n_hap if graph.haplo else 0} haplotypes "
                f"-> {path}"
            )
    return written


def _resolve_graph_path(workflow: Findmotif, chrom: str) -> str:
    """Map a BED chromosome name to its graph file
    (``grafimo_tpu/workflows.py:131-148``)."""
    c = chrom[3:] if chrom.startswith("chr") else chrom
    if workflow.namemap:
        c = workflow.namemap.get(c, c)
        name = c
    else:
        name = f"{workflow.chroms_prefix}{c}"
    gvt = os.path.join(workflow.graph_genome_dir, f"{name}{GVT_SUFFIX}")
    if os.path.isfile(gvt):
        return gvt
    for ext in (".gfa", ".vg", ".xg"):
        cand = os.path.join(workflow.graph_genome_dir, f"{name}{ext}")
        if os.path.isfile(cand):
            return cand
    return gvt


def _display_chrom(workflow: Findmotif, chrom: str) -> str:
    """(``grafimo_tpu/workflows.py:151-157``)"""
    c = chrom[3:] if chrom.startswith("chr") else chrom
    if workflow.namemap:
        return workflow.namemap.get(c, c)
    return c


def _xg_conversion_error(path: str, cause: str = "") -> GraphError:
    """(``grafimo_tpu/workflows.py:160-177``)"""
    stem = os.path.splitext(path)[0]
    why = f" ({cause})" if cause else ""
    return GraphError(
        f"{path} could not be parsed natively{why}. Export it once "
        f"with\n\n"
        f"    vg convert -p {path} > {stem}.vg\n"
        f"    (or: vg view -g {path} > {stem}.gfa)\n\n"
        f"(a {os.path.basename(stem)}.gbwt sidecar next to the export is "
        f"imported natively for the haplotype panel) and re-run against "
        f"the exported graph."
    )


def load_graph_file(path: str) -> SiteGraph:
    """Load a ``.gvt.npz``, ``.vg``, ``.xg`` or ``.gfa`` graph, with a
    ``.gbwt`` sidecar where present (``grafimo_tpu/workflows.py:180-210``)."""
    if path.endswith(".xg"):
        from grafimo_tpu_torch.graph.xg import xg_to_sitegraph

        gbwt = path[:-3] + ".gbwt"
        try:
            return xg_to_sitegraph(
                path, gbwt=gbwt if os.path.isfile(gbwt) else None
            )
        except GraphError as exc:
            raise _xg_conversion_error(path, cause=str(exc)) from exc
    for ext, loader_name in ((".gfa", "gfa"), (".vg", "vgproto")):
        if path.endswith(ext):
            if loader_name == "gfa":
                from grafimo_tpu_torch.graph.gfa import (
                    gfa_to_sitegraph as loader,
                )
            else:
                from grafimo_tpu_torch.graph.vgproto import (
                    vg_to_sitegraph as loader,
                )
            gbwt = path[: -len(ext)] + ".gbwt"
            return loader(
                path, gbwt=gbwt if os.path.isfile(gbwt) else None
            )
    return SiteGraph.load(path)


def _warn(msg: str) -> None:
    import sys

    sys.stderr.write(f"\033[33mWARNING: {msg}\033[0m\n")


def _ensure_haplotypes(
    workflow: Findmotif, graph: SiteGraph, path: str
) -> SiteGraph:
    """Haplotype-panel bootstrap for graphs that import without a
    GBWT/walk index (``grafimo_tpu/workflows.py:219-264``)."""
    if graph.haplo is not None:
        return graph
    if not workflow.vcf:
        _warn(
            f"{path}: no haplotype index (no .gbwt sidecar / GFA walks) "
            f"— every window reports haplotype frequency 0 and is "
            f"dropped from the report unless --recomb. Pass --vcf "
            f"PHASED.vcf.gz to build the panel from the graph's VCF, or "
            f"rebuild with buildvg."
        )
        return graph
    records, n_hap = read_vcf_records(workflow.vcf, graph.chrom)
    if not records:
        raise GraphError(
            f"--vcf {workflow.vcf}: no usable records for chromosome "
            f"{graph.chrom!r} — cannot build a haplotype panel for "
            f"{path}"
        )
    rebuilt = build_graph(graph.chrom, graph.seq, records, n_hap=n_hap)
    if sorted(rebuilt.node_seqs[1:]) != sorted(graph.node_seqs[1:]):
        _warn(
            f"{path}: graph rebuilt from --vcf differs from the "
            f"imported topology — is {workflow.vcf} the VCF this graph "
            f"was built from? Scanning the rebuilt graph."
        )
    if workflow.verbose:
        print(
            f"haplotype panel for {graph.chrom} built from "
            f"{workflow.vcf} ({rebuilt.haplo.n_hap if rebuilt.haplo else 0}"
            f" haplotypes)"
        )
    return rebuilt


@spans.span("graph_load_s")
def _load_graphs(
    workflow: Findmotif, chroms_in_bed: List[str]
) -> Dict[str, Tuple[str, SiteGraph]]:
    """``{bed_chrom: (display_name, graph)}`` for every requested
    chromosome (``grafimo_tpu/workflows.py:267-302``)."""
    selected = workflow.chroms
    graphs: Dict[str, Tuple[str, SiteGraph]] = {}
    if workflow.has_graphgenome():
        g = load_graph_file(workflow.graph_genome)
        g = _ensure_haplotypes(workflow, g, workflow.graph_genome)
        for chrom in chroms_in_bed:
            c = chrom[3:] if chrom.startswith("chr") else chrom
            if selected and c not in selected:
                continue
            if c == g.chrom or chrom == g.chrom:
                graphs[chrom] = (_display_chrom(workflow, chrom), g)
        if not graphs:
            raise GraphError(
                f"graph chromosome {g.chrom!r} does not match any BED "
                f"chromosome {chroms_in_bed}"
            )
        return graphs
    for chrom in chroms_in_bed:
        c = chrom[3:] if chrom.startswith("chr") else chrom
        if selected and c not in selected:
            continue
        path = _resolve_graph_path(workflow, chrom)
        if not os.path.isfile(path):
            raise GraphError(
                f"unable to locate {path} — are your graphs named with "
                f'"chr"? Consider --chroms-prefix-find or '
                f"--chroms-namemap-find"
            )
        g = _ensure_haplotypes(workflow, load_graph_file(path), path)
        graphs[chrom] = (_display_chrom(workflow, chrom), g)
    return graphs


def _scan_cache_path(workflow: Findmotif, regions, width: int) -> str:
    """Checkpoint file for one (graph inputs, region set, width), keyed by
    graph paths + mtimes (``grafimo_tpu/workflows.py:305-336``)."""
    import hashlib

    h = hashlib.sha256()
    h.update(b"scan-cache-v1")
    rank, n_proc = cluster.rank_and_size()
    if n_proc > 1:
        # per-host region shards differ: key the checkpoint per process
        h.update(f"proc{rank}/{n_proc}".encode())
    sources = []
    if workflow.has_graphgenome():
        sources.append(workflow.graph_genome)
    else:
        for chrom in sorted(regions):
            sources.append(_resolve_graph_path(workflow, chrom))
    for p in sources:
        try:
            h.update(f"{p}:{os.path.getmtime(p)}".encode())
        except OSError:
            h.update(p.encode())
    for chrom in sorted(regions):
        h.update(chrom.encode())
        for s, e in regions[chrom]:
            h.update(f"{s}-{e};".encode())
    h.update(str(width).encode())
    os.makedirs(workflow.cache_dir, exist_ok=True)
    return os.path.join(
        workflow.cache_dir, f"scan_{h.hexdigest()[:20]}.npz"
    )


@contextlib.contextmanager
def _profiled(profile_dir: str, devices: Sequence[torch.device], rank: int):
    """``torch.profiler`` over the enclosed call, CPU and (when a device
    is a card) CUDA activities, written to ``profile_dir`` as one Chrome
    trace per process, which TensorBoard and Perfetto open (reference
    ``workflows.py:437-449, 552-554``, which traces the scan alone).  The
    call's spans show in it under their names."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, f"grafimo_rank{rank}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def _scan_runs(workflow: Findmotif, motif_set: MotifSet, regions, graphs,
               devices: Sequence[torch.device]) -> Dict[str, object]:
    """The run engine: one extraction + scan pass per distinct width,
    shared by all motifs of that width (reference grafimo.py:176;
    ``grafimo_tpu/workflows.py:453-517``)."""
    from grafimo_tpu_torch.runscan import (
        build_region_runs,
        compute_results_runs,
    )

    results: Dict[str, object] = {}
    for width in sorted(motif_set.widths):
        region_runs_list = []
        for chrom, (display, graph) in graphs.items():
            region_runs_list.extend(
                build_region_runs(
                    graph, display, regions.get(chrom, []), width
                )
            )
        cache_path = None
        if workflow.cache_dir:
            cache_path = _scan_cache_path(workflow, regions, width)
        if workflow.verbose:
            materialised = [
                r for r in region_runs_list if r.payloads is not None
            ]
            if materialised:
                n_runs = sum(len(r.payloads) for r in materialised)
                print(
                    f"width {width}: {n_runs} runs over "
                    f"{len(region_runs_list)} regions"
                )
            else:
                print(
                    f"width {width}: {len(region_runs_list)} regions "
                    f"prepared (native batch pipeline)"
                )
        dfs = compute_results_runs(
            motif_set.by_width(width),
            region_runs_list,
            devices,
            threshold=workflow.threshold,
            no_qvalue=workflow.no_qvalue,
            qval_t=workflow.qval_t,
            no_reverse=workflow.no_reverse,
            recomb=workflow.recomb,
            verbose=workflow.verbose,
            cores=workflow.cores,
            cache_path=cache_path,
        )
        results.update(dfs)
    return results


def _scan_windows(workflow: Findmotif, motif_set: MotifSet, regions,
                  graphs, device: torch.device) -> Dict[str, object]:
    """The per-window engine: every region's windows on both strands,
    then one scoring pass per motif (``grafimo_tpu/workflows.py:
    518-551``).  A width's extraction is the span ``batching_s``, a
    motif's scoring the span ``scan_s``."""
    from grafimo_tpu_torch.graph.extract import extract_region
    from grafimo_tpu_torch.scan import ScanStats, compute_results

    results: Dict[str, object] = {}
    batches_per_width = {}
    for width in sorted(motif_set.widths):
        batches = []
        with spans.span("batching_s") as extracting:
            for chrom, (display, graph) in graphs.items():
                for start, stop in regions.get(chrom, []):
                    batch = extract_region(
                        graph, start, stop, width, chrom_display=display,
                        both_strands=True,
                    )
                    if len(batch):
                        batches.append(batch)
        batches_per_width[width] = batches
        if workflow.verbose:
            n = sum(len(b) for b in batches)
            print(
                f"width {width}: extracted {n} candidate windows in "
                f"{extracting.seconds:.2f}s"
            )
    for motif in motif_set:
        stats = ScanStats()
        results[motif.motif_id] = compute_results(
            motif,
            batches_per_width[motif.width],
            device,
            threshold=workflow.threshold,
            no_qvalue=workflow.no_qvalue,
            qval_t=workflow.qval_t,
            no_reverse=workflow.no_reverse,
            recomb=workflow.recomb,
            stats=stats,
        )
        if workflow.verbose:
            print(
                f"window scan {motif.motif_id}: {stats.seqs_scanned} window "
                f"rows scored in {stats.scoring_time:.3f}s"
            )
        print(f"Scanned sequences:\t{stats.seqs_scanned}")
        print(f"Scanned nucleotides:\t{stats.nucs_scanned}")
    return results


def findmotif(workflow: Findmotif,
              devices: Sequence[torch.device]) -> List[str]:
    """Scan the variation graph(s) for motif occurrences on ``devices``
    (the run engine splits each slice over all of them, the window engine
    runs on the first); returns the written report directories (empty for
    ``--text-only`` and on every rank but 0).

    The call, from its banner to its last report, is the span
    ``findmotif_s`` (``spans.call``); ``--profile DIR`` traces all of it,
    on every rank, and ``--verbose`` ends with its phase table."""
    workflow.validate()
    devices = list(devices)
    # multi-host: join the process group before any device work; every
    # rank scans its round-robin region shard and rank 0 writes the
    # merged report
    rank, n_proc = 0, 1
    if workflow.coordinator or workflow.num_processes:
        rank, n_proc = cluster.initialize_cluster(
            workflow.coordinator, workflow.num_processes,
            workflow.process_id,
        )
    if workflow.engine == "windows" and n_proc > 1:
        # every rank raises here, before any device work or output
        raise GrafimoError(
            "--engine windows runs in one process only: the reference "
            "scans each host's region shard with no merge and writes a "
            "partial report with local q-values (ROADMAP C6); use the "
            "default --engine runs for a multi-process scan"
        )
    with (_profiled(workflow.profile_dir, devices, rank)
          if workflow.profile_dir else contextlib.nullcontext()):
        with spans.call("findmotif_s"):
            outdirs = _find(workflow, devices, rank, n_proc)
    if workflow.verbose:
        print(spans.table(spans.last_call()))
    return outdirs


def _find(workflow: Findmotif, devices: List[torch.device], rank: int,
          n_proc: int) -> List[str]:
    if rank == 0:
        print_welcome()
        check_deps(devices)
    motif_set = MotifSet()
    with spans.span("motif_processing_s"):
        for motif_file in workflow.motifs:
            motif_set.add(
                load_motifs(
                    motif_file, workflow.bgfile, workflow.pseudo,
                    workflow.no_reverse,
                )
            )
    print(f"Read {len(motif_set)} motif(s); widths: {sorted(motif_set.widths)}")
    regions, region_num = read_bed_regions(workflow.bedfile)
    if rank == 0:
        print(f"Found {region_num} regions in {workflow.bedfile}")
    graphs = _load_graphs(workflow, list(regions.keys()))
    if n_proc > 1:
        flat = [
            (chrom, s, e) for chrom in regions for (s, e) in regions[chrom]
        ]
        mine = cluster.shard_regions(flat, rank, n_proc)
        regions = {}
        for chrom, s, e in mine:
            regions.setdefault(chrom, []).append((s, e))
        if workflow.verbose:
            print(
                f"process {rank}/{n_proc}: scanning "
                f"{len(mine)}/{len(flat)} regions"
            )
    if workflow.engine == "runs":
        results = _scan_runs(workflow, motif_set, regions, graphs, devices)
    else:
        results = _scan_windows(workflow, motif_set, regions, graphs,
                                devices[0])
    if rank != 0:
        return []
    outdirs = []
    chrom_graphs = {d: g for (d, g) in graphs.values()}
    with spans.span("report_write_s"):
        for motif in motif_set:
            df = results[motif.motif_id]
            if workflow.text_only:
                print_results(df)
            else:
                outdirs.append(
                    write_results(
                        df,
                        motif.motif_id,
                        len(motif_set),
                        workflow.outdir,
                        no_qvalue=workflow.no_qvalue,
                        top_graphs=workflow.top_graphs,
                        graphs=chrom_graphs,
                        verbose=workflow.verbose,
                    )
                )
    return outdirs
