"""Host seconds a ``findmotif`` call spends reading and processing its
motifs: ``workflows.load_motifs``, the port's ``models/`` below it (PWM
scaling, p-value tables)."""

WRAPS = "grafimo_tpu_torch.workflows:load_motifs"


def read(record):
    return record.per_call("motif_processing_s")
