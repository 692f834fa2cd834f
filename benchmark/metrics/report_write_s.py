"""Host seconds a ``findmotif`` call spends writing its reports:
``workflows.write_results``, the port's ``report/writer.py``."""

WRAPS = "grafimo_tpu_torch.workflows:write_results"


def read(record):
    return record.per_call("report_write_s")
