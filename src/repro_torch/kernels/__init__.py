"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions.  Sources live in ``../csrc``; ``_build`` compiles
them with ``nvcc`` at first CUDA use.  Importing this package touches
no GPU."""
