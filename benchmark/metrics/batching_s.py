"""Host seconds a ``findmotif`` call spends batching the regions' runs on
the host: ``runscan.batch_runs``, the pinned C++ of the port's
``native/`` below it."""

WRAPS = "grafimo_tpu_torch.runscan:batch_runs"


def read(record):
    return record.per_call("batching_s")
