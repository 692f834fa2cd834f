"""Test-data download conveniences.

Parity with the reference's buildvg test helpers
(``constructVG.py:40-134``): fetch the hg38 assembly from UCSC and the
1000 Genomes phase-3 biallelic SNV+indel sites VCF.  The reference shells
out to ``wget`` + ``gunzip``; these are python-native (urllib + gzip,
resumable via a ``.part`` temp file) and return the downloaded path.

Like the reference's, these exist for test/bootstrap purposes only — a
production deployment stages its own genome + phased panel.
"""

import gzip
import os
import shutil
import urllib.request

from grafimo_tpu_torch.errors import DependencyError

HG38_URL = (
    "ftp://hgdownload.soe.ucsc.edu/goldenPath/hg38/bigZips/hg38.fa.gz"
)
KGP_VCF_URL = (
    "ftp://ftp.1000genomes.ebi.ac.uk/vol1/ftp/data_collections/"
    "1000_genomes_project/release/20190312_biallelic_SNV_and_INDEL/"
    "ALL.wgs.shapeit2_integrated_snvindels_v2a.GRCh38.27022019."
    "sites.vcf.gz"
)


def _download(url: str, dest: str) -> str:
    """Fetch ``url`` to ``dest`` (write-then-rename; skip if present)."""
    if os.path.exists(dest):
        return os.path.abspath(dest)
    tmp = f"{dest}.part"
    try:
        with urllib.request.urlopen(url) as resp, open(tmp, "wb") as out:
            shutil.copyfileobj(resp, out, length=1 << 20)
        os.replace(tmp, dest)
    except Exception as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise DependencyError(f"download of {url} failed: {e}") from e
    return os.path.abspath(dest)


def get_reference_genome_from_ucsc(outdir: str = ".") -> str:
    """Download + decompress the hg38 FASTA (reference
    ``constructVG.py:40-91``); returns the path to ``hg38.fa``."""
    fa = os.path.join(outdir, "hg38.fa")
    if os.path.exists(fa):
        return os.path.abspath(fa)
    gz = _download(HG38_URL, os.path.join(outdir, "hg38.fa.gz"))
    tmp = f"{fa}.part"
    try:
        with gzip.open(gz, "rb") as src, open(tmp, "wb") as out:
            shutil.copyfileobj(src, out, length=1 << 20)
        os.replace(tmp, fa)
    except Exception as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise DependencyError(f"decompression of {gz} failed: {e}") from e
    os.remove(gz)
    return os.path.abspath(fa)


def get_1000GProject_vcf(outdir: str = ".") -> str:
    """Download the 1000 Genomes phase-3 sites VCF (reference
    ``constructVG.py:94-134``).  NOTE (as the reference notes): this
    sites-only file is unphased — usable for graph-construction tests,
    not for haplotype indexing."""
    dest = os.path.join(outdir, os.path.basename(KGP_VCF_URL))
    return _download(KGP_VCF_URL, dest)
