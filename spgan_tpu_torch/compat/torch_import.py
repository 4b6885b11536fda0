"""Reference PyTorch generator checkpoints -> the port's parameter tree
(counterpart of spgan_tpu/compat/torch_import.py: ``import_torch_generator``
only).

The reference ``g_ema`` state dict (models/spgan/spgan.py module tree,
with or without DataParallel's ``module.`` prefix) is first mapped onto
the JAX package's layout (conv weights HWIO, linear weights (in, out)),
key for key as spgan_tpu maps it, and then carried into the port by
``compat.from_jax.params_from_jax``, so there is one layout map per
direction:

  texture_synthesizer.mapping.{1..n}.{weight,bias}   -> ts.mapping[i]
  texture_synthesizer.convs.{i}.conv.{weight,modulation.*},
      .noise.weight, .activate.bias                  -> ts.convs[i]
  texture_synthesizer.to_rgbs.{j}.conv.*, .bias      -> ts.to_rgbs[j]
  texture_synthesizer.sp_convs.{j}.{weight,bias}     -> ts.sp_convs[j]
  structure_synthesizer.implicit_model.conv_stack.{2i}   (sphere block)
      conv.conv.{weight,modulation.*}, sc.{weight,bias}
  structure_synthesizer.implicit_model.conv_stack.{2i+1} (planar block)
      conv.conv.{weight,modulation.*}, conv.activate.bias,
      conv.noise.weight (ss_disable_noise false)
  structure_synthesizer.implicit_model.global_mapping.{1..8}
      (ss_mapping)                                   -> ss.mapping[i]
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.models.generator import SS_MAPPING_LAYERS


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _conv_w(x) -> np.ndarray:
    w = _t(x)
    if w.ndim == 5:  # (1, out, in, k, k) modulated
        w = w[0]
    return w.transpose(2, 3, 1, 0)  # (k, k, in, out)


def _linear(sd, prefix) -> Dict[str, np.ndarray]:
    out = {"weight": _t(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def _modconv(sd, prefix) -> dict:
    return {"weight": _conv_w(sd[prefix + ".weight"]),
            "modulation": _linear(sd, prefix + ".modulation")}


def torch_generator_to_jax_layout(state_dict: Dict, g) -> dict:
    """The reference g_ema state dict as a numpy tree in the JAX package's
    layout and structure (that of its Generator.init)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    ts = "texture_synthesizer"
    conv_specs, to_rgbs, i2j = g.ts.plan()
    convs = []
    for i in range(len(conv_specs)):
        p = f"{ts}.convs.{i}"
        entry = {"conv": _modconv(sd, f"{p}.conv"),
                 "act_bias": _t(sd[f"{p}.activate.bias"])}
        if f"{p}.noise.weight" in sd:
            entry["noise"] = {"weight": _t(sd[f"{p}.noise.weight"]).reshape(())}
        convs.append(entry)
    params = {"ts": {
        # mapping layer 0 is the parameterless PixelNorm
        "mapping": [_linear(sd, f"{ts}.mapping.{i + 1}")
                    for i in range(g.ts.n_mlp)],
        "convs": convs,
        "to_rgbs": [{"conv": _modconv(sd, f"{ts}.to_rgbs.{j}.conv"),
                     "bias": _t(sd[f"{ts}.to_rgbs.{j}.bias"]).reshape(
                         1, 1, 1, 3)}
                    for j in range(len(to_rgbs))],
        "sp_convs": [{"weight": _t(sd[f"{ts}.sp_convs.{j}.weight"])
                      .transpose(2, 3, 1, 0),
                      "bias": _t(sd[f"{ts}.sp_convs.{j}.bias"])}
                     for j in range(len(i2j))],
    }}
    stack = "structure_synthesizer.implicit_model.conv_stack"
    blocks = []
    for i in range(g.ss.n_layers):
        sp, pp = f"{stack}.{2 * i}", f"{stack}.{2 * i + 1}"
        blocks.append({
            "sphere": {"conv": _modconv(sd, f"{sp}.conv.conv")},
            "sc": {"weight": _t(sd[f"{sp}.sc.weight"]).transpose(2, 3, 1, 0),
                   "bias": _t(sd[f"{sp}.sc.bias"])},
            "planar": {"conv": _modconv(sd, f"{pp}.conv.conv"),
                       "act_bias": _t(sd[f"{pp}.conv.activate.bias"])},
        })
        if f"{pp}.conv.noise.weight" in sd:      # ss_disable_noise false
            blocks[-1]["planar"]["noise"] = {
                "weight": _t(sd[f"{pp}.conv.noise.weight"]).reshape(())}
    params["ss"] = {"blocks": blocks}
    if g.ss.use_mapping:
        # Sequential index 0 is the parameterless PixelNorm
        params["ss"]["mapping"] = [
            _linear(sd, f"structure_synthesizer.implicit_model."
                        f"global_mapping.{i + 1}")
            for i in range(SS_MAPPING_LAYERS)]
    return params


def import_torch_generator(state_dict: Dict, g, device=None) -> dict:
    """The port's generator parameters (float32, on `device`, default
    cuda) from the reference g_ema state dict; `g` is the port's
    Generator (only its specs are read)."""
    return params_from_jax(torch_generator_to_jax_layout(state_dict, g),
                           device=device)
