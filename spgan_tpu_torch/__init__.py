"""spgan_tpu_torch — the PyTorch/CUDA port of spgan_tpu for NVIDIA Hopper.

Mirrors the JAX package module for module (``spgan_tpu/ops/linear.py`` ->
``spgan_tpu_torch/ops/linear.py`` and so on) and keeps its NHWC layout at
every public function, so each function can be held against its JAX
counterpart on the same inputs.  The JAX package's Pallas kernels become
hand-written CUDA kernels (``csrc/``, bound in ``ops/kernels/``), each with
a plain PyTorch version beside it that runs on the CPU.

Implemented so far: the panorama engine (``infer.engine.PanoramaEngine``,
close-loop and planar lattices) and everything it runs, the inference CLI
(``python -m spgan_tpu_torch.infer``, test.py's counterpart) and the
training CLI (``python -m spgan_tpu_torch.train``, train.py's counterpart:
yaml configs, the synthetic, npy and spr data sources, checkpoints with
resume), and scale-out (``parallel/``: one process per card on
torch.distributed, the sharded and halo engines, data-parallel
training).  This package imports torch and never jax, and nothing of
``spgan_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise (``device.resolve``).
"""

__version__ = "0.1.0"

from spgan_tpu_torch.config import Config  # noqa: F401
