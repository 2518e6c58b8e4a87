"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions,
and the routing between them and the math paths."""
