"""Kernels (CUDA C++ for sm_90a, each beside its plain PyTorch version)
and the band-matmul pyramid."""
