"""The benchmark's count of StyleGAN3's work in one image, from the layer
schedule of the configuration's ``stylegan3`` section
(reference.stylegan3.schedule), by flops.py's conventions: one
multiply-accumulate is 2 FLOPs; every convolution and linear layer is
counted (the mapping, the input's affine and its channel mixing, each
layer's affine and its modulated conv at its output size, in_size + k -
1); the filtered LeakyReLU's FIR work, the Fourier features' sines and
elementwise work are not.

The filtered LeakyReLU's least traffic a layer, its byte bound: the conv
output read once and the layer output written once, at the layer's dtype
(2 bytes in the layers num_fp16_res runs in float16, 4 in the float32
ones), L0 .. L13; the ToRGB layer has none.  It counts the op's
work whatever implements it.
"""
from __future__ import annotations

from typing import Dict

from portbench.reference import stylegan3 as ref


def layer_macs(sg: dict) -> Dict[str, float]:
    """Multiply-accumulates of one image by part."""
    sched = ref.schedule(sg)
    z, w = sg["z_dim"], sg["w_dim"]
    n_map = sg["mapping_kwargs"]["num_layers"]
    inp = sched["input"]
    out = {"mapping": float(z * w + (n_map - 1) * w * w),
           "input": float(w * 4 + inp["size"] ** 2 * (
               2 * inp["channels"] + inp["channels"] ** 2)),
           "affine": 0.0, "convs": 0.0}
    for L in sched["layers"]:
        k = L["conv_kernel"]
        side = L["in_size"] + k - 1
        out["affine"] += w * L["in_channels"]
        out["convs"] += (side * side * k * k * L["in_channels"]
                         * L["out_channels"])
    return out


def image_flops(sg: dict) -> float:
    return 2 * sum(layer_macs(sg).values())


def filtered_lrelu_bytes(sg: dict) -> float:
    """The filtered LeakyReLU's byte bound in one image, L0 .. L13."""
    total = 0
    for L in ref.schedule(sg)["layers"]:
        if L["is_torgb"]:
            continue
        side = L["in_size"] + L["conv_kernel"] - 1
        elem = 2 if L["use_fp16"] else 4
        total += (side * side + L["out_size"] ** 2) * L["out_channels"] * elem
    return float(total)
