"""seldon-core-tpu on PyTorch and CUDA: the port for an NVIDIA H100.

A second package beside ``seldon_core_tpu`` (the JAX reference), with
the same module layout.  It imports torch, never jax, and nothing of the
JAX package.  Importing this package imports nothing.
"""
