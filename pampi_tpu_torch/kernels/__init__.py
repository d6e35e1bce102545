"""Build and binding of the CUDA kernels in csrc/."""
