"""repro_torch — the PyTorch/CUDA port of the SA-Solver system.

Mirrors the layout of the JAX package ``repro`` (the reference it is held
against) and imports nothing of it. Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA kernel for Hopper
under ``kernels/csrc``, built with nvcc at first use.
"""
