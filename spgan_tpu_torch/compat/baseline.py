"""Transfer learning from an InfinityGAN "baseline" checkpoint (counterpart
of spgan_tpu/compat/baseline.py).

A planar baseline generator stores its SS styled convs at
``implicit_model.conv_stack.{0..3}``; in the SP-GAN layout those planar
convs sit at the odd slots {1,3,5,7} (the sphere blocks take the even
ones).  The import renames those four key groups, loads every key the
target model has, leaves the rest (sphere convs, sphere skip convs) at
their fresh init, and returns the loaded set as a boolean mask per leaf:
the freeze mask when ``train_params.freeze`` is set (the discriminator is
then frozen whole).

The mapping runs in the JAX package's layout (``compat.torch_import``'s
helpers, then ``compat.from_jax`` back into the port's), so it is the JAX
package's map key for key.
"""
from __future__ import annotations

from typing import Dict, Tuple

from spgan_tpu_torch.compat.from_jax import params_from_jax, params_to_jax
from spgan_tpu_torch.compat.torch_import import _conv_w, _linear, _t
from spgan_tpu_torch.tree import tree_leaves, tree_map


def remap_baseline_ss_keys(sd: Dict) -> Dict:
    """conv_stack.{i} -> conv_stack.{2i+1} for the four planar styled-conv
    parameter groups."""
    out = {}
    for k, v in sd.items():
        nk = k
        for i in range(4):
            pre = f"structure_synthesizer.implicit_model.conv_stack.{i}."
            if k.startswith(pre) and (
                    ".conv.conv." in k or ".conv.activate." in k):
                nk = k.replace(
                    pre,
                    f"structure_synthesizer.implicit_model.conv_stack."
                    f"{2 * i + 1}.", 1)
                break
        out[nk] = v
    return out


def import_torch_baseline_generator(state_dict: Dict, g,
                                    params_template: dict
                                    ) -> Tuple[dict, dict]:
    """Partial import: every leaf whose torch key is in the (remapped)
    state dict is filled from it, every other keeps the template's value.
    Returns (params on the template's device, mask) with mask a tree of
    python bools, True exactly on the loaded leaves."""
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    sd = remap_baseline_ss_keys(sd)

    params = params_to_jax(params_template)
    mask = tree_map(lambda _: False, params)

    def put(path_keys, value):
        p, m = params, mask
        for k in path_keys[:-1]:
            p, m = p[k], m[k]
        p[path_keys[-1]] = value
        m[path_keys[-1]] = True

    def try_linear(path_keys, prefix):
        if f"{prefix}.weight" in sd:
            lin = _linear(sd, prefix)
            put(path_keys + ["weight"], lin["weight"])
            put(path_keys + ["bias"], lin["bias"])

    def try_modconv(path_keys, prefix):
        if f"{prefix}.weight" in sd:
            put(path_keys + ["weight"], _conv_w(sd[f"{prefix}.weight"]))
            try_linear(path_keys + ["modulation"], f"{prefix}.modulation")

    # ---- TS -----------------------------------------------------------
    for i in range(g.ts.n_mlp):
        try_linear(["ts", "mapping", i], f"texture_synthesizer.mapping.{i+1}")
    for i in range(len(params["ts"]["convs"])):
        p = f"texture_synthesizer.convs.{i}"
        try_modconv(["ts", "convs", i, "conv"], f"{p}.conv")
        if f"{p}.activate.bias" in sd:
            put(["ts", "convs", i, "act_bias"], _t(sd[f"{p}.activate.bias"]))
        if f"{p}.noise.weight" in sd and "noise" in params["ts"]["convs"][i]:
            put(["ts", "convs", i, "noise", "weight"],
                _t(sd[f"{p}.noise.weight"]).reshape(()))
    for j in range(len(params["ts"]["to_rgbs"])):
        p = f"texture_synthesizer.to_rgbs.{j}"
        try_modconv(["ts", "to_rgbs", j, "conv"], f"{p}.conv")
        if f"{p}.bias" in sd:
            put(["ts", "to_rgbs", j, "bias"],
                _t(sd[f"{p}.bias"]).reshape(1, 1, 1, 3))
    for j in range(len(params["ts"].get("sp_convs", []))):
        p = f"texture_synthesizer.sp_convs.{j}"
        if f"{p}.weight" in sd:
            put(["ts", "sp_convs", j, "weight"],
                _t(sd[f"{p}.weight"]).transpose(2, 3, 1, 0))
            put(["ts", "sp_convs", j, "bias"], _t(sd[f"{p}.bias"]))

    # ---- SS (planar slots 1,3,5,7 after the remap; sphere slots if any) -
    for i in range(0 if g.ss is None else g.ss.n_layers):
        sp = f"structure_synthesizer.implicit_model.conv_stack.{2 * i}"
        pp = f"structure_synthesizer.implicit_model.conv_stack.{2 * i + 1}"
        try_modconv(["ss", "blocks", i, "sphere", "conv"], f"{sp}.conv.conv")
        if f"{sp}.sc.weight" in sd:
            put(["ss", "blocks", i, "sc", "weight"],
                _t(sd[f"{sp}.sc.weight"]).transpose(2, 3, 1, 0))
            put(["ss", "blocks", i, "sc", "bias"], _t(sd[f"{sp}.sc.bias"]))
        try_modconv(["ss", "blocks", i, "planar", "conv"], f"{pp}.conv.conv")
        if f"{pp}.conv.activate.bias" in sd:
            put(["ss", "blocks", i, "planar", "act_bias"],
                _t(sd[f"{pp}.conv.activate.bias"]))

    device = tree_leaves(params_template)[0].device
    return params_from_jax(params, device=device), mask
