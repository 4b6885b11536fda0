"""The benchmark's count of the SP-GAN generator's work at any of the
texture synthesizer's patch plans (out_res 101, 197, 389, 773, 1541 on an
11x11 structure latent), by flops.py's conventions: one multiply-
accumulate is 2 FLOPs; every convolution and linear layer is counted, the
transposed (upsampling) convs at their input size; the blurs, the sphere
taps' resampling and elementwise work are not.

flops.py counts the 101-pixel plan alone (`ts_macs`, and `image_flops`,
which does not read patch_size); this file reads `patch_size`.
"""
from __future__ import annotations

from typing import Dict, List

from portbench import flops

# TS convs of each plan (ts_input_size 11)
LAYERS = {101: 8, 197: 10, 389: 12, 773: 14, 1541: 16}
# the sphere skip convs: before the ToRGB of these convs (the reference
# defines them for the 101 and 197 plans only)
SPHERE_SKIPS = {101: (3, 5, 7), 197: (3, 5, 7, 9)}


def ts_plan_channels(out_res: int, cm: int) -> List[int]:
    """Output widths of the TS convs of a plan: six of 512, two of 256*cm
    (the 101 plan), then pairs of 128*cm, 64*cm, 32*cm, 16*cm."""
    ext = [128 * cm, 64 * cm, 32 * cm, 16 * cm]
    chans = [512] * 6 + [256 * cm] * 2
    for i in range((LAYERS[out_res] - 8) // 2):
        chans += [ext[i], ext[i]]
    return chans


def ts_plan_macs(local: int, glob: int, cm: int, ts_input: int,
                 out_res: int) -> Dict[str, float]:
    """Multiply-accumulates of one TS forward of one patch of the plan."""
    chans = ts_plan_channels(out_res, cm)
    n = len(chans)
    ups = [i % 2 == 0 for i in range(n)]
    sizes = flops._conv_chain(ts_input, ups)
    out = {"convs": 0.0, "to_rgb": 0.0, "sphere_skip": 0.0,
           "modulation": 0.0}
    cin = local
    for (hin, hout), cout, up in zip(sizes, chans, ups):
        out["convs"] += (hin * hin if up else hout * hout) * 9 * cin * cout
        out["modulation"] += glob * cin + cin * cout
        cin = cout
    # ToRGB (1x1 to 3 channels, modulated) after every odd conv; the
    # sphere skip convs (3x3, 3 -> 3) on the running RGB skip, at the size
    # of the previous ToRGB's output
    for src in range(1, n, 2):
        h, c = sizes[src][1], chans[src]
        out["to_rgb"] += h * h * c * 3
        out["modulation"] += glob * c
    for src in SPHERE_SKIPS.get(out_res, ()):
        h = sizes[src - 2][1]
        out["sphere_skip"] += h * h * 9 * 3 * 3
    return out


def patch_flops(cfg_json: dict) -> Dict[str, float]:
    """FLOPs of one generator patch by part (SS, TS) at the configuration's
    patch_size, no mapping."""
    tp = flops._tp(cfg_json)
    ss = flops.patch_flops(cfg_json)["ss"]
    ts = ts_plan_macs(tp["local_latent_dim"], tp["global_latent_dim"],
                      tp["channel_multiplier"], tp["ts_input_size"],
                      tp["patch_size"])
    return {"ss": ss, "ts": 2 * sum(ts.values())}


def image_flops(cfg_json: dict, patches: int) -> float:
    """FLOPs of one rendered panorama: `patches` distinct patches at the
    configuration's plan and one mapping of its global latent."""
    tp = flops._tp(cfg_json)
    p = patch_flops(cfg_json)
    return (patches * (p["ss"] + p["ts"])
            + 2 * flops.mapping_macs(tp["global_latent_dim"], tp["n_mlp"]))

