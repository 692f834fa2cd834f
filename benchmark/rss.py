"""The peak resident memory of another process over a span of time.

    python3 benchmark/rss.py PID INTERVAL_S

Reads the process's resident size from ``/proc/PID/statm`` every
``INTERVAL_S`` seconds, prints ``ready`` once the first reading is in,
and, when its standard input closes, the largest reading in bytes.  It
runs apart from the measured process, so a long call that holds that
process's interpreter lock does not stop the readings.
"""

import os
import select
import sys


def resident_bytes(path: str, page: int) -> int:
    with open(path, "rb") as f:
        return int(f.read().split()[1]) * page


def main(argv=None) -> int:
    pid, interval = (argv or sys.argv[1:])[:2]
    page = os.sysconf("SC_PAGE_SIZE")
    path = f"/proc/{int(pid)}/statm"
    peak = resident_bytes(path, page)
    print("ready", flush=True)
    while not select.select([sys.stdin], [], [], float(interval))[0]:
        peak = max(peak, resident_bytes(path, page))
    peak = max(peak, resident_bytes(path, page))
    print(peak, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
