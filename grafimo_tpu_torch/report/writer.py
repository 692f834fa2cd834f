"""Result report writers: TSV, HTML, GFF3, stdout, top-region graph images.

Reference: ``src/grafimo/res_writer.py:41-439``.  File formats and naming
conventions are reproduced exactly (``grafimo_out_{PID}_{MOTIF}`` default
out-dir, per-motif file prefixes, GFF3 attribute strings); the top-graphs
feature renders region subgraphs from the framework's own site graph
instead of shelling out to ``vg view`` + graphviz (a ``.dot`` file is
always written; PNG rendering uses the ``dot`` binary when present).
"""

import os
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from grafimo_tpu_torch.spans import span
from grafimo_tpu_torch.utils.constants import DEFAULT_OUTDIR, PHASE, SOURCE, TP


def write_results(
    results: pd.DataFrame,
    motif_id: str,
    motif_num: int,
    outdir: str,
    no_qvalue: bool = False,
    top_graphs: int = 0,
    graphs: Optional[Dict[str, "object"]] = None,
    verbose: bool = False,
) -> str:
    """Write the TSV + HTML + GFF3 report triple
    (reference ``res_writer.py:41-210``); returns the output directory."""
    if len(results) == 0:
        raise ValueError("no potential motif occurrence retrieved")
    dirname_default = False
    if outdir == DEFAULT_OUTDIR:
        outdir = "_".join(["grafimo_out", str(os.getpid()), motif_id])
        dirname_default = True
    os.makedirs(outdir, exist_ok=True)
    print(f"\nWriting results in {outdir}.\n")
    if not dirname_default and motif_num > 1:
        prefix = "_".join(["grafimo_out", motif_id])
    else:
        prefix = "grafimo_out"
    with span("report_tsv_s"):
        results.to_csv(
            os.path.join(outdir, ".".join([prefix, "tsv"])),
            sep="\t",
            encoding="utf-8",
        )
    with span("report_html_s"):
        results.to_html(os.path.join(outdir, ".".join([prefix, "html"])))
    with span("report_gff_s"):
        write_gff3(os.path.join(outdir, prefix), results, no_qvalue)
    if top_graphs > 0:
        regions: List[str] = []
        for r in results["sequence_name"].tolist():
            if len(regions) >= top_graphs:
                break
            if r not in regions:
                regions.append(r)
        image_dir = (
            "_".join(["top_graphs", motif_id]) if motif_num > 1 else "top_graphs"
        )
        image_dir = os.path.join(outdir, image_dir)
        os.makedirs(image_dir, exist_ok=True)
        print(f"Writing the top {len(regions)} graphs in {image_dir}\n")
        for r in regions:
            write_region_graph_image(r, image_dir, graphs or {})
    return outdir


def write_gff3(prefix: str, data: pd.DataFrame, no_qvalue: bool) -> None:
    """GFF3 report with the reference's exact attribute strings
    (``writeGFF3``, ``res_writer.py:213-305``)."""
    gfffn = ".".join([prefix, "gff"])
    with open(gfffn, "w") as ofstream:
        ofstream.write("##gff-version 3\n")
        for i in range(len(data)):
            row = data.iloc[i]
            seqname = row["sequence_name"]
            chrom = seqname.split(":")[0]
            score = round(float(row["score"]), 1)
            strand = row["strand"]
            if strand == "-":  # keep forward strand coordinates
                start = str(row["stop"])
                stop = str(row["start"])
            else:
                start = str(row["start"])
                stop = str(row["stop"])
            motif_id = row["motif_id"]
            motif_name = row["motif_alt_id"]
            pvalue = np.format_float_scientific(
                float(row["p-value"]), exp_digits=2
            )
            sequence = row["matched_sequence"]
            reference = row["reference"]
            att1 = "".join(
                ["Name=", motif_id, "_", seqname, strand, ":", reference]
            )
            att2 = "=".join(["Alias", motif_name])
            att3 = "=".join(["ID", motif_id, "-", motif_name, "-", seqname])
            att4 = "=".join(["pvalue=", str(pvalue)])
            att5 = "=".join(["sequence=", sequence, ";\n"])
            if not no_qvalue:
                qvalue = np.format_float_scientific(
                    float(row["q-value"]), exp_digits=2
                )
                attqv = "=".join(["qvalue", str(qvalue)])
                atts = ";".join([att1, att2, att3, att4, attqv, att5])
            else:
                atts = ";".join([att1, att2, att3, att4, att5])
            gffline = "\t".join(
                [chrom, SOURCE, TP, start, stop, str(score), strand, PHASE, atts]
            )
            ofstream.write(gffline)


def region_graph_dot(graph, region_start: int, region_end: int) -> str:
    """Render the subgraph covering a region as graphviz DOT (replaces the
    ``vg find | vg view -dp | dot`` chain, ``res_writer.py:308-411``)."""
    lines = ["digraph region {", "  rankdir=LR;", "  node [shape=box];"]
    prev_tail: List[int] = []

    def edge_all(tails: List[int], heads: List[int]):
        for t in tails:
            for h in heads:
                lines.append(f"  n{t} -> n{h};")

    for kind, idx in graph.elements:
        if kind == "seg":
            s, e = int(graph.node_ref_start[idx]), int(graph.node_ref_end[idx])
            if e <= region_start or s > region_end:
                continue
            lines.append(
                f'  n{idx} [label="{idx}:{graph.node_seqs[idx]}"];'
            )
            edge_all(prev_tail, [idx])
            prev_tail = [idx]
        else:
            site = graph.sites[idx]
            if site.ref_end < region_start or site.ref_start > region_end:
                continue
            heads = []
            tails = []
            passthrough = False
            for a_idx, allele in enumerate(site.alleles):
                nid = site.allele_nodes[a_idx]
                if allele == "" or nid == 0:
                    passthrough = True
                    continue
                color = "black" if a_idx == 0 else "red"
                lines.append(
                    f'  n{nid} [label="{nid}:{allele}" color={color}];'
                )
                heads.append(nid)
                tails.append(nid)
            edge_all(prev_tail, heads)
            if passthrough:
                tails = tails + prev_tail
            prev_tail = tails
    lines.append("}")
    return "\n".join(lines) + "\n"


def write_region_graph_image(
    region: str, image_dir: str, graphs: Dict[str, "object"]
) -> None:
    """Write ``<region>.dot`` (+ ``.png`` when graphviz is available)."""
    chrom = region.split(":")[0]
    graph = graphs.get(chrom)
    if graph is None:
        return
    start, stop = (int(x) for x in region.split(":")[1].split("-"))
    dot = region_graph_dot(graph, start, stop)
    dot_path = os.path.join(image_dir, f"{region}.dot")
    with open(dot_path, "w") as f:
        f.write(dot)
    if shutil.which("dot"):
        png = os.path.join(image_dir, f"{region}.png")
        subprocess.run(
            ["dot", "-Tpng", dot_path, "-o", png], check=False,
            capture_output=True,
        )


def print_results(results: pd.DataFrame) -> None:
    """``--text-only`` output (reference ``print_results``,
    ``res_writer.py:415-439``)."""
    pd.set_option("display.max_columns", None)
    print()
    print(results)
    pd.reset_option("display.max_rows")
