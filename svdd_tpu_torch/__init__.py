"""PyTorch/CUDA port of svdd_tpu for one NVIDIA H100.

The JAX package ``svdd_tpu`` stays the reference. This package mirrors
its module names; every Pallas kernel on a ported path is a CUDA C++
kernel under ``csrc/``, built by ``nvcc`` at first use
(``_build.py``). On CPU tensors each kernel wrapper runs its plain
PyTorch version instead.

This package imports torch and numpy only, never jax or svdd_tpu.
"""
