"""Host seconds a ``findmotif`` call spends loading its graph:
``workflows._load_graphs``, the port's ``graph/`` below it."""

WRAPS = "grafimo_tpu_torch.workflows:_load_graphs"


def read(record):
    return record.per_call("graph_load_s")
