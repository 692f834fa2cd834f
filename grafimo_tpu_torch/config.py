"""Workflow configuration objects.

Reference: ``src/grafimo/workflow.py:39-634`` (``BuildVG`` / ``Findmotif``
argument containers with per-field validation).  These are lean dataclasses
with a ``validate()`` performing the checks that matter.
"""

import os
from dataclasses import dataclass, field
from typing import Dict, List

from grafimo_tpu_torch.utils.constants import DEFAULT_OUTDIR, NOMAP, UNIF


@dataclass
class BuildVG:
    """``buildvg`` workflow arguments (reference ``workflow.py:39-230``)."""

    reference_genome: str
    vcf: str
    chroms: List[str] = field(default_factory=list)
    chroms_prefix: str = ""
    namemap: Dict[str, str] = field(default_factory=dict)
    cores: int = 0
    outdir: str = DEFAULT_OUTDIR
    reindex: bool = False
    export: str = ""  # also write "gfa" / "vg" artifacts per graph
    verbose: bool = False
    debug: bool = False

    def validate(self) -> None:
        if not os.path.isfile(self.reference_genome):
            raise FileNotFoundError(
                f"unable to locate {self.reference_genome}"
            )
        if not os.path.isfile(self.vcf):
            raise FileNotFoundError(f"unable to locate {self.vcf}")
        if self.export not in ("", "gfa", "vg"):
            raise ValueError(
                f"unknown --export format {self.export!r} "
                f"(choose gfa or vg)"
            )


@dataclass
class Findmotif:
    """``findmotif`` workflow arguments (reference ``workflow.py:233-634``)."""

    bedfile: str
    motifs: List[str]
    graph_genome: str = ""  # single .gvt graph
    graph_genome_dir: str = ""  # directory of per-chromosome graphs
    chroms: List[str] = field(default_factory=list)
    chroms_prefix: str = ""
    namemap: Dict[str, str] = field(default_factory=dict)
    bgfile: str = UNIF
    pseudo: float = 0.1
    threshold: float = 1e-4
    no_qvalue: bool = False
    no_reverse: bool = False
    text_only: bool = False
    qval_t: bool = False
    recomb: bool = False
    top_graphs: int = 0
    cores: int = 0
    outdir: str = DEFAULT_OUTDIR
    verbose: bool = False
    debug: bool = False
    # haplotype-panel bootstrap: phased VCF used to (re)build the
    # haplotype index for graphs that import without one (the
    # reference's interactive "index it now?" flow for a bare .vg,
    # ``grafimo.py:134-162`` -> ``constructVG.py:343``)
    vcf: str = ""
    # scan engine: "runs" = run-compressed device scan (production),
    # "windows" = per-window reference path
    engine: str = "runs"
    # when set, write a jax profiler trace of the scan phase here
    profile_dir: str = ""
    # when set, persist/reuse device-ready scan batches per
    # (graphs, regions, width) under this directory (checkpoint/resume)
    cache_dir: str = ""
    # multi-host (pod-slice) execution: jax.distributed coordinator
    # "host:port" + process topology; leave unset for single-host (or for
    # managed TPU environments, where --num-processes 0 with
    # --coordinator "auto" autodetects)
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1

    def has_graphgenome(self) -> bool:
        return bool(self.graph_genome)

    def has_graphgenome_dir(self) -> bool:
        return bool(self.graph_genome_dir)

    def validate(self) -> None:
        if self.has_graphgenome() == self.has_graphgenome_dir():
            raise ValueError(
                "exactly one of --genome-graph / --genome-graph-dir required"
            )
        if self.has_graphgenome() and not os.path.isfile(self.graph_genome):
            raise FileNotFoundError(f"unable to locate {self.graph_genome}")
        if self.has_graphgenome_dir() and not os.path.isdir(
            self.graph_genome_dir
        ):
            raise FileNotFoundError(
                f"unable to locate {self.graph_genome_dir}"
            )
        if not os.path.isfile(self.bedfile):
            raise FileNotFoundError(f"unable to locate {self.bedfile}")
        for m in self.motifs:
            if not os.path.isfile(m):
                raise FileNotFoundError(f"unable to locate {m}")
        if not (0 < self.threshold <= 1):
            raise ValueError("the threshold must be between 0 and 1")
        if self.pseudo <= 0:
            raise ValueError("the pseudocount must be > 0")
        if self.qval_t and self.no_qvalue:
            raise ValueError(
                "--qvalueT requires q-values (do not pass --no-qvalue)"
            )
        if self.top_graphs < 0:
            raise ValueError("--top-graphs must be >= 0")
        if self.engine not in ("runs", "windows"):
            raise ValueError(f"unknown scan engine {self.engine!r}")
        if self.vcf and not os.path.isfile(self.vcf):
            raise FileNotFoundError(f"unable to locate {self.vcf}")


NOMAP_SENTINEL = NOMAP
