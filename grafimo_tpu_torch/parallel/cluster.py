"""Multi-host execution on ``torch.distributed``.

Counterpart of ``grafimo_tpu/parallel/cluster.py``.  A multi-host scan is
the same program as a single-host one: every process builds runs for its
own shard of regions (:func:`shard_regions`, round-robin over the sorted
region list) and scans them on its own devices; the integer score
histograms -- the only data the exact statistics need globally -- are
summed over processes (:func:`allreduce_hist`), the per-process report
rows are gathered to every process (:func:`allgather_object`), and rank 0
writes the report (:func:`is_report_host`).

The backend is gloo, on every device type.  The payloads are host data:
the histogram has already been read back once per scan, and the report
rows are Python lists, a few hundred KB in all.  NCCL would move device
tensors, and it refuses two ranks on one GPU, which is how a one-card
host runs a multi-process scan.  The process group has a finite timeout:
when a rank dies or fails before a collective, the others' wait ends in
an error instead of a hang.
"""

import os
from datetime import timedelta
from typing import List, Sequence, Tuple

from grafimo_tpu_torch.errors import GrafimoError

# the longest a rank waits in a collective for the others: ranks reach
# the histogram all-reduce when their own scans end, so this bounds the
# imbalance between the shards' scan times, not a scan's length
COLLECTIVE_TIMEOUT = timedelta(hours=2)
# what ``--coordinator auto`` reads (torchrun sets all four)
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_cluster(
    coordinator: str, num_processes: int = 0, process_id: int = -1,
) -> Tuple[int, int]:
    """Join the process group; returns ``(rank, world size)``.

    ``coordinator`` ``host:port`` rendezvouses over TCP at that address
    and needs ``num_processes`` and ``process_id``.  ``auto`` (or no
    coordinator) reads torchrun's environment (``env://``); explicit
    ``num_processes``/``process_id`` override its world size and rank.
    Missing settings raise: nothing falls back to a single process."""
    import torch.distributed as dist

    if coordinator in ("", "auto"):
        given = {"WORLD_SIZE": num_processes > 0, "RANK": process_id >= 0}
        missing = [v for v in TORCHRUN_ENV
                   if v not in os.environ and not given.get(v)]
        if missing:
            raise GrafimoError(
                f"--coordinator {coordinator or 'auto'}: {', '.join(missing)}"
                " not set; run under torchrun, or pass --coordinator "
                "host:port --num-processes N --process-id I"
            )
        init_method = "env://"
    else:
        if num_processes < 1 or not 0 <= process_id < num_processes:
            raise GrafimoError(
                f"--coordinator {coordinator} needs --num-processes N >= 1 "
                f"and --process-id in [0, N), got {num_processes} and "
                f"{process_id}"
            )
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(
        "gloo", init_method=init_method,
        world_size=num_processes if num_processes > 0 else -1,
        rank=process_id if process_id >= 0 else -1,
        timeout=COLLECTIVE_TIMEOUT,
    )
    return dist.get_rank(), dist.get_world_size()


def rank_and_size() -> Tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown_cluster() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_regions(
    regions: Sequence[Tuple[str, int, int]],
    process_id: int,
    num_processes: int,
) -> List[Tuple[str, int, int]]:
    """Deterministic round-robin region shard for this host."""
    ordered = sorted(regions)
    return [r for i, r in enumerate(ordered) if i % num_processes == process_id]


def is_report_host() -> bool:
    return rank_and_size()[0] == 0


def allreduce_hist(hist):
    """Sum an int64 histogram (numpy) over all processes, exactly, as
    int64."""
    import numpy as np
    import torch
    import torch.distributed as dist

    if rank_and_size()[1] == 1:
        return hist
    t = torch.from_numpy(np.ascontiguousarray(hist, dtype=np.int64)).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def allgather_object(obj) -> List:
    """Gather one picklable object from every process, ordered by rank."""
    import torch.distributed as dist

    n = rank_and_size()[1]
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Gather one byte string from every process, ordered by rank."""
    return allgather_object(bytes(payload))
