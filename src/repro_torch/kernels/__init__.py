"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built at first use
by ``_build``) with their plain PyTorch versions in ``ref``."""
