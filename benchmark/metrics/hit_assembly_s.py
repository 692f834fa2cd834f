"""Host seconds a ``findmotif`` call spends assembling its hits' report
columns: ``runscan._assemble_columns``, ``assemble.py`` and
``graph/runs.py`` below it."""

WRAPS = "grafimo_tpu_torch.runscan:_assemble_columns"


def read(record):
    return record.per_call("hit_assembly_s")
