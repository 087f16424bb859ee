"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

``ops`` holds the public wrappers; ``ref`` the plain versions; ``_build``
compiles the CUDA sources with nvcc at first use and counts launches.
Importing this package neither builds nor loads anything.
"""
