"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Module paths mirror ``repro``'s, so each counterpart is easy to find.
The package imports torch and numpy, never JAX or ``repro``: where it
needs code of a jax-free reference module it keeps its own copy.  The
hand-written CUDA kernels live in ``repro_torch/kernels/csrc`` and are
built with ``nvcc`` at first use.
"""
