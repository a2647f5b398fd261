"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions, and the table lookup ``interp``."""
