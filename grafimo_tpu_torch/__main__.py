"""Module entry point: ``python -m grafimo_tpu_torch <workflow> ...``."""

import sys

from grafimo_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
