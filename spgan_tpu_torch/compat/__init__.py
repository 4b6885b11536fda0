"""Weights to and from the reference's PyTorch checkpoints and files
(counterpart of spgan_tpu/compat: the same exports)."""
from spgan_tpu_torch.compat.torch_import import (  # noqa: F401
    import_torch_generator,
    export_torch_style_state_dict,
)
from spgan_tpu_torch.compat.load import load_generator_params  # noqa: F401
