"""grafimo_tpu_torch — GRAFIMO-TPU ported to PyTorch and CUDA.

The second package beside ``grafimo_tpu``: the same ``buildvg`` /
``findmotif`` user surface, with the device half written in PyTorch and
the exact score histogram as a hand-written CUDA kernel for Hopper
(``csrc/hist.cu``).  ``grafimo_tpu`` stays the reference every module
here is held against.

The package imports ``torch`` and never ``jax``.  It reuses the jax-free
host layers of ``grafimo_tpu`` (graph, io, models, native C++ engine,
report, utils, config, errors) and carries its own copies of the
jax-free helpers that live in jax-importing reference modules; each copy
cites its origin.
"""

__version__ = "0.1.0"
