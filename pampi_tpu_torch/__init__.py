"""pampi_tpu_torch: the PyTorch/CUDA port of pampi_tpu for the NVIDIA H100.

The hot path runs hand-written CUDA kernels for Hopper (csrc/, built by
kernels/build.py at first use); every kernel keeps a plain PyTorch version
beside it, which runs on CPU tensors. Entry points take `device=` and
default to "cuda". The package imports neither jax nor pampi_tpu.
"""
