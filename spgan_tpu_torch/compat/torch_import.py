"""Reference PyTorch checkpoints <-> the port's parameter trees
(counterpart of spgan_tpu/compat/torch_import.py): the generator's
``g_ema`` and the StyleGan2Discriminator's state dicts in, the generator's
out (``export_torch_style_state_dict``).

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

A styleGAN2 baseline generator (``g.ss`` None) has no SS keys.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spgan_tpu_torch.compat.from_jax import params_from_jax, params_to_jax
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
    if g.ss is None:  # the styleGAN2 baseline
        return params
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


def import_torch_discriminator(state_dict: Dict, d, device=None) -> dict:
    """The port's discriminator parameters (float32, on `device`, default
    cuda) from the reference StyleGan2Discriminator state dict; `d` is
    the port's Discriminator (only its plan is read).

      convs.0.{0.weight, 1.bias}        stem EqualConv2d + FusedLeakyReLU
      convs.{i}.conv{1,2}.*, .skip.*    ResBlocks (conv2 and skip hold the
                                        blur at index 0, the conv at 1)
      final_conv.{0.weight, 1.bias}
      final_linear.{0,1}.{weight,bias}
      coord_linear.{0,1}.{weight,bias}  (the coord-AC head)"""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}

    def conv_layer(prefix, downsample=False, activate=True):
        # Sequential indices: [Blur,] EqualConv2d [, FusedLeakyReLU]
        ci = 1 if downsample else 0
        out = {"conv": {"weight": _t(sd[f"{prefix}.{ci}.weight"])
                        .transpose(2, 3, 1, 0)}}
        if f"{prefix}.{ci}.bias" in sd:
            out["conv"]["bias"] = _t(sd[f"{prefix}.{ci}.bias"])
        if activate and f"{prefix}.{ci + 1}.bias" in sd:
            out["act_bias"] = _t(sd[f"{prefix}.{ci + 1}.bias"])
        return out

    blocks = d.plan()[1]
    params = {
        "stem": conv_layer("convs.0"),
        "blocks": [{"conv1": conv_layer(f"convs.{i + 1}.conv1"),
                    "conv2": conv_layer(f"convs.{i + 1}.conv2",
                                        downsample=True),
                    "skip": conv_layer(f"convs.{i + 1}.skip",
                                       downsample=True, activate=False)}
                   for i in range(len(blocks))],
        "final_conv": conv_layer("final_conv"),
        "final_linear": [_linear(sd, f"final_linear.{i}") for i in range(2)],
    }
    if d.use_coord_ac and "coord_linear.0.weight" in sd:
        params["coord_linear"] = [_linear(sd, f"coord_linear.{i}")
                                  for i in range(2)]
    return params_from_jax(params, device=device)


def export_torch_style_state_dict(params: dict, g=None
                                  ) -> Dict[str, np.ndarray]:
    """The port's generator parameters as the reference g_ema state dict
    (numpy arrays): the inverse of import_torch_generator.  `g` is not
    read (the JAX package's signature)."""
    p = params_to_jax(params)
    sd: Dict[str, np.ndarray] = {}

    def put_linear(prefix, lin):
        sd[prefix + ".weight"] = lin["weight"].T
        if "bias" in lin:
            sd[prefix + ".bias"] = lin["bias"]

    def put_modconv(prefix, conv):
        sd[prefix + ".weight"] = conv["weight"].transpose(3, 2, 0, 1)[None]
        put_linear(prefix + ".modulation", conv["modulation"])

    ts = "texture_synthesizer"
    for i, lin in enumerate(p["ts"]["mapping"]):
        put_linear(f"{ts}.mapping.{i + 1}", lin)
    for i, c in enumerate(p["ts"]["convs"]):
        put_modconv(f"{ts}.convs.{i}.conv", c["conv"])
        sd[f"{ts}.convs.{i}.activate.bias"] = c["act_bias"]
        if "noise" in c:
            sd[f"{ts}.convs.{i}.noise.weight"] = \
                c["noise"]["weight"].reshape(1)
    for j, r in enumerate(p["ts"]["to_rgbs"]):
        put_modconv(f"{ts}.to_rgbs.{j}.conv", r["conv"])
        sd[f"{ts}.to_rgbs.{j}.bias"] = r["bias"].reshape(1, 3, 1, 1)
    for j, c in enumerate(p["ts"]["sp_convs"]):
        sd[f"{ts}.sp_convs.{j}.weight"] = c["weight"].transpose(3, 2, 0, 1)
        sd[f"{ts}.sp_convs.{j}.bias"] = c["bias"]
    if "ss" not in p:  # the styleGAN2 baseline
        return sd
    stack = "structure_synthesizer.implicit_model.conv_stack"
    for i, blk in enumerate(p["ss"]["blocks"]):
        sp, pp = f"{stack}.{2 * i}", f"{stack}.{2 * i + 1}"
        put_modconv(sp + ".conv.conv", blk["sphere"]["conv"])
        sd[sp + ".sc.weight"] = blk["sc"]["weight"].transpose(3, 2, 0, 1)
        sd[sp + ".sc.bias"] = blk["sc"]["bias"]
        put_modconv(pp + ".conv.conv", blk["planar"]["conv"])
        sd[pp + ".conv.activate.bias"] = blk["planar"]["act_bias"]
        if "noise" in blk["planar"]:
            sd[pp + ".conv.noise.weight"] = \
                blk["planar"]["noise"]["weight"].reshape(1)
    for i, lin in enumerate(p["ss"].get("mapping", [])):
        put_linear("structure_synthesizer.implicit_model."
                   f"global_mapping.{i + 1}", lin)
    return sd
