"""Carry generator parameters across from the JAX package.

Input: the JAX generator's parameter tree as nested dicts/lists of numpy
arrays, or the flat ``a/b/0/c`` keys that spgan_tpu's ``save_params_npz``
writes (an ``np.load``-ed .npz or any mapping).  Output: the port's
parameter tree, same keys, float32 tensors, with the two layout changes
the port's modules expect:

  * 4-D ``weight`` (conv, HWIO)        -> OIHW
  * 2-D ``weight`` (EqualLinear, in x out) -> (out, in)

Every other leaf keeps its shape.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def unflatten(flat: Mapping[str, Any]) -> Any:
    """{'a/b/0/c': v, ...} -> nested dicts, with all-integer key sets as
    lists."""
    root: dict = {}
    for key in flat:
        node = root
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = flat[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        items = {k: listify(v) for k, v in node.items()}
        if items and all(k.isdigit() for k in items):
            return [items[str(i)] for i in range(len(items))]
        return items

    return listify(root)


def _leaf(name: str, value) -> torch.Tensor:
    a = np.asarray(value, np.float32)
    if name == "weight" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    elif name == "weight" and a.ndim == 2:
        a = a.T                              # (in, out) -> (out, in)
    return torch.tensor(a)


def _convert(node, name: str = ""):
    if isinstance(node, Mapping):
        return {k: _convert(v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, name) for v in node]
    return _leaf(name, node)


def params_from_jax(tree_or_flat: Any, device=None) -> dict:
    """The port's generator parameters from the JAX package's (nested or
    flat-keyed), placed on `device` (default cuda)."""
    from spgan_tpu_torch.device import resolve
    from spgan_tpu_torch.models.generator import _tree_to

    tree = tree_or_flat
    if isinstance(tree, Mapping) and any("/" in k for k in tree.keys()):
        tree = unflatten({k: tree[k] for k in tree.keys()})
    return _tree_to(_convert(tree), resolve(device))
