"""Host seconds a ``findmotif`` call spends on statistics:
``runscan._build_reports``, the p-values, the q-value tables and the
filtered frames."""

WRAPS = "grafimo_tpu_torch.runscan:_build_reports"


def read(record):
    return record.per_call("statistics_s")
