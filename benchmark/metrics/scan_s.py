"""Host seconds a ``findmotif`` call spends in the scan loop:
``runscan.scan_batches``, host to device and back, ending in the
device's synchronising reads."""

WRAPS = "grafimo_tpu_torch.runscan:scan_batches"


def read(record):
    return record.per_call("scan_s")
