from grafimo_tpu_torch.report.writer import (  # noqa: F401
    print_results,
    write_gff3,
    write_results,
)
