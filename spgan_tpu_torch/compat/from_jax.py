"""Carry parameters and training state across from the JAX package.

Input: a JAX parameter tree (generator or discriminator) as nested
dicts/lists of numpy arrays, or the flat ``a/b/0/c`` keys that spgan_tpu's
``save_params_npz`` writes (an ``np.load``-ed .npz or any mapping); or a
whole JAX TrainState (``train_state_from_jax``).  Output: the port's
parameter tree, same keys, float32 tensors, with the two layout changes
the port's modules expect:

  * 4-D ``weight`` (conv, HWIO)        -> OIHW
  * 2-D ``weight`` (EqualLinear, in x out) -> (out, in)

Every other leaf keeps its shape.  ``params_to_jax`` is the inverse: the
port's parameters in the JAX layout, as numpy.
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


def _leaf_to_jax(name: str, value: torch.Tensor) -> np.ndarray:
    a = value.detach().to("cpu", torch.float32).numpy()
    if name == "weight" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)          # OIHW -> HWIO
    elif name == "weight" and a.ndim == 2:
        a = a.T                              # (out, in) -> (in, out)
    return a.copy(order="C")


def _convert(node, name: str = "", leaf=_leaf):
    if isinstance(node, Mapping):
        return {k: _convert(v, k, leaf) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, name, leaf) for v in node]
    return leaf(name, node)


def params_to_jax(params: Any) -> dict:
    """The JAX package's parameter tree (float32 numpy) of the port's
    `params` (generator or discriminator): the inverse of
    params_from_jax."""
    return _convert(params, leaf=_leaf_to_jax)


def params_from_jax(tree_or_flat: Any, device=None) -> dict:
    """The port's generator parameters from the JAX package's (nested or
    flat-keyed), placed on `device` (default cuda)."""
    from spgan_tpu_torch.device import resolve
    from spgan_tpu_torch.models.generator import _tree_to

    tree = tree_or_flat
    if isinstance(tree, Mapping) and any("/" in k for k in tree.keys()):
        tree = unflatten({k: tree[k] for k in tree.keys()})
    return _tree_to(_convert(tree), resolve(device))


def train_state_from_jax(state: Any, device=None):
    """The port's TrainState from spgan_tpu's (its fields read as
    attributes; leaves anything np.asarray takes): G, D and EMA params and
    both Adam states (mu/nu in the params' layout, per-leaf int32 counts),
    the step and the PPL running mean, on `device` (default cuda)."""
    from spgan_tpu_torch.device import resolve
    from spgan_tpu_torch.models.generator import _tree_to
    from spgan_tpu_torch.train.state import AdamState, TrainState
    from spgan_tpu_torch.tree import tree_map

    dev = resolve(device)

    def params(tree):
        return _tree_to(_convert(tree), dev)

    def adam(opt):
        count = tree_map(lambda c: torch.tensor(np.asarray(c, np.int32)),
                         opt.count)
        return AdamState(mu=params(opt.mu), nu=params(opt.nu),
                         count=_tree_to(count, dev))

    return TrainState(
        step=int(np.asarray(state.step)),
        params_g=params(state.params_g), params_d=params(state.params_d),
        params_g_ema=params(state.params_g_ema),
        opt_g=adam(state.opt_g), opt_d=adam(state.opt_d),
        mean_path_length=torch.tensor(
            np.asarray(state.mean_path_length, np.float32)).to(dev))
