"""The share of the traced calls' time in which no kernel, copy or fill
ran on the card, in percent: one less the device's busy time inside the
``findmotif`` call spans over their length.  Nothing to read in an
untraced run or one whose trace shows no device work."""

WRAPS = None


def read(record):
    calls_s = record.span_seconds("findmotif_call")
    busy_s = record.device_seconds_in("findmotif_call")
    if not calls_s or not busy_s:
        return None
    return 100.0 * (1.0 - busy_s / calls_s)
