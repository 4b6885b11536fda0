"""The benchmark of spgan_tpu_torch on an NVIDIA GPU: see run.py."""
