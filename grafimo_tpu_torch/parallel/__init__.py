from grafimo_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_mesh,
    sharded_scan_step,
)
