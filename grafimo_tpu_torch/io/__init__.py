from grafimo_tpu_torch.io.bed import read_bed_regions  # noqa: F401
from grafimo_tpu_torch.io.fasta import read_fasta, fasta_chrom_names  # noqa: F401
from grafimo_tpu_torch.io.vcf import iter_vcf_records, VcfRecord  # noqa: F401
