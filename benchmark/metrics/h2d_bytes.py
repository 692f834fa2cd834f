"""Bytes a ``findmotif`` call copies from the host to the card: the
program's ``h2d_bytes`` counter (``runscan._put``,
``ops/score_runs.genome_planes_to_device`` and ``pwm_lut_from_kernel``),
read from the record of the window's last call
(``grafimo_tpu_torch.spans.last_call``); every call of a cell does the
same work.  Nothing to read where the program keeps no such record."""

WRAPS = None


def read(record):
    try:
        from grafimo_tpu_torch.spans import last_call
    except ImportError:
        return None
    last = last_call()
    return None if last is None else last["counts"].get("h2d_bytes")
