"""Command line interface of the port.

The reference parser (``grafimo_tpu.cli.get_parser``) and its
argument-to-workflow mapping are reused as they are -- both are jax-free
at import -- with one flag added: ``--device {cuda,cpu}``, default
``cuda``.  ``cuda`` without a visible card is an error, never a silent
CPU run.
"""

import argparse
import sys

from grafimo_tpu.cli import args_to_workflow, get_parser as _reference_parser
from grafimo_tpu_torch.device import DEVICES


def get_parser() -> argparse.ArgumentParser:
    parser = _reference_parser()
    parser.prog = "grafimo-tpu-torch"
    parser.description = (
        "GRAFIMO-TPU on PyTorch/CUDA: scan genome variation graphs for DNA "
        "motif occurrences"
    )
    parser.add_argument(
        "--device", choices=DEVICES, default="cuda",
        help="torch device of the findmotif scan; cuda fails when no card "
             "is visible. Default: %(default)s.",
    )
    return parser


def main(argv=None) -> int:
    """Run one workflow with the reference's error discipline
    (``grafimo_tpu/cli.py:242-271``): every uncaught exception prints one
    red line and exits 1 unless ``--debug``; SIGINT exits 2."""
    from grafimo_tpu_torch.device import resolve_device
    from grafimo_tpu_torch.workflows import buildvg, findmotif

    parser = get_parser()
    args = parser.parse_args(argv)
    try:
        workflow = args_to_workflow(args)
        if args.workflow == "buildvg":
            buildvg(workflow)
        else:
            findmotif(workflow, resolve_device(args.device))
    except KeyboardInterrupt:
        sys.stderr.write("\nCaught SIGINT. GRAFIMO-TPU will exit\n")
        return 2
    except Exception as e:  # noqa: BLE001 — excepthook semantics
        if args.debug:
            raise
        sys.stderr.write(f"\033[31m\nERROR: {e}\033[0m\n")
        return 1
    return 0
