"""Hand-written CUDA kernels (``csrc/``), their wrappers (``ops``) and their
plain PyTorch versions (``ref``)."""
