"""Generator weights from a file (counterpart of spgan_tpu/compat/load.py:
``load_generator_params``).

  * ``.npz``: the flat ``a/b/0/c`` keys that spgan_tpu's
    ``compat.load.save_params_npz`` writes (JAX layout);
  * ``.ckpt`` / ``.pth`` / ``.pth.tar``: a reference PyTorch checkpoint
    with a ``g_ema`` entry (or a bare state dict);
  * a directory is an Orbax training checkpoint, which only JAX reads:
    it raises, naming the export that makes an ``.npz`` of it.
"""
from __future__ import annotations

import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.compat.torch_import import import_torch_generator
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.models.generator import _tree_to


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs with the ``a/b/0/c`` keys of save_params_npz."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


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
        raise ValueError(
            f"{path} is a directory (an Orbax training checkpoint), which "
            "only the JAX package reads: export its EMA generator with "
            "spgan_tpu.compat.load.save_params_npz(path.npz, "
            "load_generator_params(dir, g)) and pass the .npz")
    if path.endswith(".npz"):
        with np.load(path) as data:
            params = params_from_jax({k: data[k] for k in data.files},
                                     device="cpu")
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("g_ema", ckpt) if isinstance(ckpt, dict) else ckpt
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        params = import_torch_generator(sd, g, device="cpu")
    _check_against(params, g.init(torch.Generator().manual_seed(0),
                                  device="cpu"), path)
    return _tree_to(params, dev)
