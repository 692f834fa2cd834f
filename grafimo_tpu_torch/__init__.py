"""grafimo_tpu_torch — GRAFIMO-TPU ported to PyTorch and CUDA.

The second package beside ``grafimo_tpu``: the same ``buildvg`` /
``findmotif`` user surface, with the device half written in PyTorch and
the exact score histogram and the fused window scoring as hand-written
CUDA kernels for Hopper (``csrc/hist.cu``, ``csrc/scan_packed.cu``).
``grafimo_tpu`` stays the reference every module here is held against.

The package imports ``torch`` and nothing of ``jax`` or ``grafimo_tpu``.
Its host layers (graph, io, models, the native C++ engine, report, utils,
config, errors) are copies of the reference's, identical apart from the
package name in their imports, and ``tests/test_torch_isolation.py`` pins
each copy to its original; the jax-free helpers that live in
jax-importing reference modules are copied too, each citing its origin.
"""

__version__ = "0.1.0"
