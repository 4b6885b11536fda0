"""Hand-written CUDA kernels for Hopper: the wrappers with their plain
PyTorch versions (``utils/native.py`` builds and loads the kernels)."""
