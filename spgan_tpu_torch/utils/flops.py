"""Analytic per-sample FLOPs of the generator, from its static specs
(counterpart of spgan_tpu/utils/flops.py): flops_ss / flops_ts /
flops_all, as the reference reports them (base_test_manager.py:166-178).
"""
from __future__ import annotations

from typing import Dict

from spgan_tpu_torch.ops.spatial import ConvSpec


def _modconv_flops(in_ch, out_ch, k, style_dim, out_h, out_w,
                   demodulate=True, blur_positions=0, blur_k=3):
    w = out_ch * in_ch * k * k
    f = 2 * style_dim * in_ch + 2 * in_ch     # modulation linear
    f += w + w * style_dim                    # weight modulation
    if demodulate:
        f += w + w * in_ch
    f += w * out_h * out_w                    # the conv itself
    f += blur_positions * blur_k * blur_k     # depthwise FIR blur
    return f


def _sampler_flops(channels, out_h, out_w, k):
    # bilinear gather: 4 taps * (3 mul + 3 add) per channel per sample
    return channels * (out_h * k) * (out_w * k) * 24


def generator_flops(g, batch: int = 1) -> Dict[str, int]:
    """`g`: the port's Generator (only its specs are read)."""
    style = g.ts.global_dim
    ss = g.ss
    flops_ss = 0
    if ss is not None:  # the styleGAN2 baseline has no SS
        cin = ss.local_dim + ss.coord_dim
        for s in ss.layer_sizes(ss.coord_grid.ss_spatial_size):
            # sphere conv (k=3 over the 3x-resampled map, size preserving)
            flops_ss += _sampler_flops(cin, s, s, 3)
            flops_ss += _modconv_flops(cin, ss.local_dim, 3, style, s, s)
            # residual 1x1 + lrelu
            flops_ss += (ss.local_dim * ss.local_dim * s * s
                         + ss.local_dim * s * s)
            # planar k7 (shrinks by 2 * unfold_radius)
            so = s - 2 * ss.unfold_radius
            flops_ss += _modconv_flops(cin, ss.local_dim,
                                       2 * ss.unfold_radius + 1, style, so,
                                       so)

    flops_ts = g.ts.n_mlp * (2 * style * style + 2 * style)  # mapping MLP
    convs, to_rgbs, i2j = g.ts.plan()
    in_ch = g.ts.local_dim
    h = g.ts.ts_input_size
    sizes = []
    for c in convs:
        ho = ConvSpec(upsample=c["upsample"]).out_size(h)
        blur_pos = (c["out_ch"] * (2 * h + 1 - 2) ** 2) if c["upsample"] else 0
        flops_ts += _modconv_flops(in_ch, c["out_ch"], 3, style, ho, ho,
                                   blur_positions=blur_pos)
        in_ch = c["out_ch"]
        h = ho
        sizes.append(ho)
    for t in to_rgbs:
        s = sizes[t["src"]]
        flops_ts += _modconv_flops(convs[t["src"]]["out_ch"], 3, 1, style,
                                   s, s, demodulate=False)
        flops_ts += 3 * (2 * s - 1) ** 2 * 9   # skip upsample blur
    for src in i2j:
        s = sizes[src - 2] if src >= 2 else g.ts.ts_input_size
        flops_ts += _sampler_flops(3, s, s, 3)
        flops_ts += 3 * 3 * 9 * s * s

    return {"flops_ss": int(flops_ss) * batch,
            "flops_ts": int(flops_ts) * batch,
            "flops_all": int(flops_ss + flops_ts) * batch}


def pretty(flops: float) -> str:
    """(reference base_test_manager.py:166-178)"""
    out = []
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if flops >= div:
            out.append(f"{int(flops // div) % 1000:03d}{unit}")
    return " ".join(out) if out else str(int(flops))
