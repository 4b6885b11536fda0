"""The benchmark's own count of the work: convolution and matmul FLOPs of
the SP-GAN generator and discriminator, from the configuration's shapes,
and the work of each hand-written kernel launch from its operand shapes.

One multiply-accumulate is 2 FLOPs.  Counted: every convolution and
linear layer of the algorithm (the SS sphere 3x3 convs on the latent and
the coordinate channels, its 1x1 residual projections and k7 planar
convs; the TS 3x3 convs, the transposed ones at their input size; ToRGB,
the sphere skip convs; the modulation linears and the demodulation
products; the mapping MLP).  Not counted: the depthwise blurs, the
resampling of the sphere taps, activations and other elementwise work.

Training (`train_cycle_flops`) counts each backward by convention: a
backward to the parameters is twice its forward (input and weight
gradients), a backward to an input alone once its forward, and a
backward through a graph that already holds a backward (R1, PPL) twice
the forward and first backward it runs through.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence


def _conv_chain(ts_input: int, upsample: Sequence[bool]) -> List[tuple]:
    """(input size, output size) of each TS conv of the no-padding chain:
    h -> 2h - 3 through an upsampling conv and its blur, h -> h - 2
    through a plain 3x3 conv (11 -> 19, 17, 31, 29, 55, 53, 103, 101)."""
    sizes, h = [], ts_input
    for up in upsample:
        out = 2 * h - 3 if up else h - 2
        sizes.append((h, out))
        h = out
    return sizes


def ts_channels(cm: int, n: int = 8) -> List[int]:
    """The shipped plan's widths at out_res 101 (ts_input_size 11)."""
    return ([512] * 6 + [256 * cm] * 2)[:n]


def ss_macs(local: int, glob: int, coord: int, n_layers: int, radius: int,
            window: int) -> Dict[str, float]:
    """Multiply-accumulates of one SS forward of one patch."""
    k = 2 * radius + 1
    out = {"sphere_latent": 0.0, "sphere_coords": 0.0, "sc": 0.0,
           "planar": 0.0, "modulation": 0.0}
    for i in range(n_layers):
        h = window - 2 * radius * i
        out["sphere_latent"] += h * h * 9 * local * local
        out["sphere_coords"] += h * h * 9 * coord * local
        out["sc"] += h * h * local * local
        out["planar"] += (h - 2 * radius) ** 2 * k * k * (local + coord) * local
        # the sphere and planar convs' modulation and demodulation
        out["modulation"] += 2 * (glob * (local + coord)
                                  + (local + coord) * local)
    return out


def ts_macs(local: int, glob: int, cm: int, ts_input: int) -> Dict[str, float]:
    """Multiply-accumulates of one TS forward of one patch (out_res 101)."""
    chans = ts_channels(cm)
    ups = [i % 2 == 0 for i in range(len(chans))]
    out = {"convs": 0.0, "to_rgb": 0.0, "sphere_skip": 0.0,
           "modulation": 0.0}
    cin = local
    sizes = _conv_chain(ts_input, ups)
    for (hin, hout), cout, up in zip(sizes, chans, ups):
        out["convs"] += (hin * hin if up else hout * hout) * 9 * cin * cout
        out["modulation"] += glob * cin + cin * cout
        cin = cout
    # ToRGB after convs 1, 3, 5, 7 (1x1 to 3 channels, modulated, no
    # demodulation); the sphere skip convs (3x3, 3 -> 3) on the running
    # RGB skip before ToRGB of convs 3, 5, 7, at the size of the skip
    for src in (1, 3, 5, 7):
        h, c = sizes[src][1], chans[src]
        out["to_rgb"] += h * h * c * 3
        out["modulation"] += glob * c
    for src in (3, 5, 7):
        h = sizes[src - 2][1]
        out["sphere_skip"] += h * h * 9 * 3 * 3
    return out


def mapping_macs(glob: int, n_mlp: int) -> float:
    return n_mlp * glob * glob


def _tp(cfg_json: dict) -> dict:
    tp = {"local_latent_dim": 256, "global_latent_dim": 512,
          "coord_num_dir": 3, "ss_n_layers": 4, "ss_unfold_radius": 3,
          "ts_input_size": 11, "channel_multiplier": 2, "n_mlp": 8,
          "batch_size": 16, "path_batch_shrink": 2, "patch_size": 101,
          "d_reg_every": 16, "g_reg_every": 4}
    tp.update(cfg_json.get("train_params", {}))
    return tp


def patch_flops(cfg_json: dict) -> Dict[str, float]:
    """FLOPs of one generator patch by part (SS, TS), no mapping."""
    tp = _tp(cfg_json)
    window = tp["ts_input_size"] + 2 * tp["ss_n_layers"] * tp["ss_unfold_radius"]
    ss = ss_macs(tp["local_latent_dim"], tp["global_latent_dim"],
                 tp["coord_num_dir"], tp["ss_n_layers"],
                 tp["ss_unfold_radius"], window)
    ts = ts_macs(tp["local_latent_dim"], tp["global_latent_dim"],
                 tp["channel_multiplier"], tp["ts_input_size"])
    return {"ss": 2 * sum(ss.values()), "ts": 2 * sum(ts.values())}


def image_flops(cfg_json: dict, patches: int) -> float:
    """FLOPs of one rendered panorama: `patches` distinct patches and one
    mapping of its global latent."""
    tp = _tp(cfg_json)
    p = patch_flops(cfg_json)
    return (patches * (p["ss"] + p["ts"])
            + 2 * mapping_macs(tp["global_latent_dim"], tp["n_mlp"]))


def d_macs(patch: int, cm: int, linear_ch: int = 512,
           ac_out: int = 3) -> float:
    """Multiply-accumulates of one discriminator forward of one patch."""
    ch = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
          256: 64 * cm, 512: 32 * cm}
    log_size = int(round(math.log(patch, 2)))
    cin = ch[2 ** log_size]
    macs = patch * patch * 3 * cin
    size = patch
    for i in range(log_size, 2, -1):
        cout = ch[2 ** (i - 1)]
        out = size // 2
        macs += size * size * 9 * cin * cin          # conv1, same size
        macs += out * out * 9 * cin * cout           # conv2, stride 2
        macs += out * out * cin * cout               # skip 1x1, stride 2
        cin, size = cout, out
    macs += size * size * 9 * (cin + 1) * linear_ch  # final conv
    flat = linear_ch * size * size
    macs += flat * linear_ch + linear_ch * 1         # d_patch head
    macs += flat * linear_ch + linear_ch * ac_out    # coordinate AC head
    return macs


def train_cycle_flops(cfg_json: dict) -> Dict[str, float]:
    """FLOPs of one cycle of the lazy schedule (d_reg_every iterations
    from g_path_start on: one R1, d_reg_every / g_reg_every PPL), by the
    convention in the module docstring.  Returns the parts and "total"."""
    tp = _tp(cfg_json)
    b = tp["batch_size"]
    pb = max(1, b // tp["path_batch_shrink"])
    p = patch_flops(cfg_json)
    styles = 2 * 2 * mapping_macs(tp["global_latent_dim"], tp["n_mlp"])
    fg = p["ss"] + p["ts"] + styles            # one G forward of a sample
    fts = p["ts"] + styles                     # the TS and styles alone
    fd = 2 * d_macs(tp["patch_size"], tp["channel_multiplier"])
    n = tp["d_reg_every"]
    plain = 4 * b * fg + 8 * b * fd
    r1 = 6 * b * fd
    ppl = 3 * pb * fg + 3 * pb * fts
    parts = {"plain": n * plain, "r1": r1,
             "ppl": (n // tp["g_reg_every"]) * ppl}
    parts["total"] = sum(parts.values())
    return parts


def sphere_conv_flops(launches: Sequence[tuple]) -> float:
    """2 * B * H * W * K2 * C * Cout over the recorded launches
    (B, H, W, C, Cout, K2) of the sphere-conv kernel."""
    return float(sum(2 * B * H * W * K2 * C * Cout
                     for B, H, W, C, Cout, K2 in launches))


def sphere_sample_bytes(launches: Sequence[tuple]) -> float:
    """Bytes of the tap sampler's launches (B, H, W, C, K2, element bytes):
    each input element read once, each output element (B,K2,H,W,C)
    written once, and the five (B,H,K2) 4-byte row-offset tables read
    once."""
    return float(sum(e * (B * H * W * C + B * K2 * H * W * C)
                     + 5 * 4 * B * H * K2
                     for B, H, W, C, K2, e in launches))
