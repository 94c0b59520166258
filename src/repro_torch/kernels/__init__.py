"""Hand-written Hopper kernels of the port, each with its plain version.

    sa_update.py        fused SA-Solver state update   (memory-bound)
    sa_fused.py         dual-output predictor+corrector combine (one pass)
                        (both also lane-batched: L lanes of their own
                        operands and coefficients in one launch)
    flash_attention.py  blocked online-softmax attention (compute-bound)
    rwkv6_scan.py       chunked RWKV6 WKV recurrence (state kept on chip)
    graph_gate.py       run_if: a body gated by a device flag (a CUDA-graph
                        conditional node under capture; not a TPU kernel's
                        port: the reference's lax.cond)

The CUDA C++ sources live in ``csrc/`` and are built by ``_build.py`` at
first use; ``ops.py`` dispatches (plain PyTorch on a CPU tensor, the
kernel on a CUDA tensor). Nothing is compiled when this package is
imported.
"""

from . import ops

__all__ = ["ops"]
