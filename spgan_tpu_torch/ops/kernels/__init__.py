"""Hand-written CUDA kernels for Hopper: builder (build.py) and the
wrappers with their plain PyTorch versions."""
