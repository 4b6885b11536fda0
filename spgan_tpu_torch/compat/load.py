"""Generator weights to and from files (counterpart of
spgan_tpu/compat/load.py: ``save_params_npz``, ``load_params_npz``,
``load_generator_params``).

``load_generator_params`` reads
  * a directory of the port's training checkpoints (train/checkpoint.py):
    the EMA generator of the newest; an Orbax directory (the JAX package's
    training checkpoints) raises, naming the export that makes an ``.npz``
    of it;
  * ``.npz``: the flat ``a/b/0/c`` keys that ``save_params_npz`` (either
    package's) writes, in the JAX layout;
  * ``.pt``: one checkpoint file of the port (``<step>.pt``), read with
    ``weights_only=True``: its EMA generator;
  * any other file (``.ckpt`` / ``.pth`` / ``.pth.tar``): a reference
    PyTorch checkpoint with a ``g_ema`` entry (or a bare state dict).

The training package is imported only for a checkpoint of the port.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from spgan_tpu_torch.compat.from_jax import (params_from_jax, params_to_jax,
                                             unflatten)
from spgan_tpu_torch.compat.torch_import import import_torch_generator
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.models.generator import _tree_to
from spgan_tpu_torch.tree import flatten


def save_params_npz(path: str, params: Any) -> None:
    """Write the port's parameters as the JAX package's save_params_npz
    does: float32 arrays in the JAX layout under flat ``a/b/0/c`` keys,
    compressed."""
    np.savez_compressed(path, **dict(flatten(params_to_jax(params))))


def load_params_npz(path: str, template: Any, device=None) -> dict:
    """The parameters of `template`'s tree (the port's: generator or
    discriminator) from an ``.npz`` of flat ``a/b/0/c`` keys in the JAX
    layout (either package's save_params_npz), on `device` (default
    cuda); keys the template lacks are not read."""
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k, _ in flatten(template)},
                               device=device)


def _ema_from_checkpoint(tensors: Dict[str, torch.Tensor]) -> dict:
    prefix = "params_g_ema/"
    return unflatten({k[len(prefix):]: v for k, v in tensors.items()
                      if k.startswith(prefix)})


def _check_against(params: dict, template: dict, path: str) -> None:
    """Raise unless `params` has exactly `template`'s keys and shapes."""
    got, want = dict(flatten(params)), dict(flatten(template))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{path}: keys do not match the generator's "
                         f"parameters (missing {missing}, unexpected {extra})")
    bad = [f"{k} {tuple(got[k].shape)} (want {tuple(want[k].shape)})"
           for k in want if got[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"{path}: shapes do not match the generator's "
                         f"parameters: {bad}")


def load_generator_params(path: str, g, device=None) -> dict:
    """The port's generator parameters for Generator `g` from `path`, on
    `device` (default cuda)."""
    dev = resolve(device)
    if os.path.isdir(path):
        from spgan_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      read_checkpoint)

        mgr = CheckpointManager(path)
        step = mgr.latest_step()
        if step is None:
            raise ValueError(
                f"{path} holds no checkpoint of the port; if it is an Orbax "
                "training checkpoint, which only the JAX package reads, "
                "export its EMA generator with "
                "spgan_tpu.compat.load.save_params_npz(path.npz, "
                "load_generator_params(dir, g)) and pass the .npz")
        params = _ema_from_checkpoint(
            read_checkpoint(mgr.path(step))["tensors"])
    elif path.endswith(".npz"):
        with np.load(path) as data:
            params = params_from_jax({k: data[k] for k in data.files},
                                     device="cpu")
    elif path.endswith(".pt"):
        from spgan_tpu_torch.train.checkpoint import read_checkpoint

        params = _ema_from_checkpoint(read_checkpoint(path)["tensors"])
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("g_ema", ckpt) if isinstance(ckpt, dict) else ckpt
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        params = import_torch_generator(sd, g, device="cpu")
    _check_against(params, g.init(torch.Generator().manual_seed(0),
                                  device="cpu"), path)
    return _tree_to(params, dev)
