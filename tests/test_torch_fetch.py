"""The port's copy of the test-data fetch helpers
(``grafimo_tpu_torch/utils/fetch.py``, pinned to
``grafimo_tpu/utils/fetch.py`` by ``tests/test_torch_isolation.py``):
``tests/test_fetch.py``'s three cases with ``urlopen`` replaced, so no
network is touched; URLs, atomicity and decompression."""

import gzip
import io
import urllib.request

import pytest

from grafimo_tpu.utils import fetch as ref_fetch
from grafimo_tpu_torch.errors import DependencyError
from grafimo_tpu_torch.utils import fetch


def test_hg38_fetch_and_decompress(tmp_path, monkeypatch):
    fasta = b">chr1\nACGTACGT\n"
    seen = {}

    def fake_urlopen(url):
        seen["url"] = url
        return io.BytesIO(gzip.compress(fasta))

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    out = fetch.get_reference_genome_from_ucsc(str(tmp_path))
    assert seen["url"] == fetch.HG38_URL == ref_fetch.HG38_URL
    assert out.endswith("hg38.fa")
    assert open(out, "rb").read() == fasta
    assert not (tmp_path / "hg38.fa.gz").exists()  # cleaned up
    # idempotent: a second call returns without downloading again
    monkeypatch.setattr(
        urllib.request, "urlopen",
        lambda url: (_ for _ in ()).throw(AssertionError("re-download")),
    )
    assert fetch.get_reference_genome_from_ucsc(str(tmp_path)) == out


def test_1kgp_vcf_fetch(tmp_path, monkeypatch):
    body = b"##fileformat=VCFv4.2\n"
    seen = {}

    def fake_urlopen(url):
        seen["url"] = url
        return io.BytesIO(body)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    out = fetch.get_1000GProject_vcf(str(tmp_path))
    assert seen["url"] == fetch.KGP_VCF_URL == ref_fetch.KGP_VCF_URL
    assert out.endswith(
        "ALL.wgs.shapeit2_integrated_snvindels_v2a.GRCh38.27022019."
        "sites.vcf.gz"
    )
    assert open(out, "rb").read() == body


def test_fetch_failure_leaves_no_debris(tmp_path, monkeypatch):
    def boom(url):
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", boom)
    with pytest.raises(DependencyError, match="download of"):
        fetch.get_1000GProject_vcf(str(tmp_path))
    assert list(tmp_path.iterdir()) == []
