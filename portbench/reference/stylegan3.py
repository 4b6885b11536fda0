"""The plain reference of StyleGAN3's generator: NVlabs stylegan3's
``training/networks_stylegan3.py`` (Generator, MappingNetwork,
SynthesisNetwork, SynthesisInput, SynthesisLayer, modulated_conv2d) with
``torch_utils/ops/filtered_lrelu.py::_filtered_lrelu_ref``,
``upfirdn2d.py::_upfirdn2d_ref`` and ``bias_act.py::_bias_act_ref`` as the
ops, written once more in plain ``torch`` on NCHW tensors, one image at a
time.  It imports nothing of the program and nothing of JAX.

Departures from NVlabs' code, none of which changes a value:

  * parameters are a flat dict under NVlabs' state-dict keys
    (``mapping.fc0.weight``, ``synthesis.L0_36_512.affine.bias``, ...)
    read by functions, not torch.nn.Modules; the filters are designed from
    the schedule at each call instead of held as buffers;
  * scipy's ``firwin(numtaps, cutoff, width=..., fs=...)`` is written out
    with numpy's Kaiser window and sinc (``firwin`` below);
  * the conditioning label (c_dim 0), noise_mode, update_emas and
    truncation are left out (the generator has no label and no noise,
    nothing trains here, and the cell samples at psi 1);
  * every layer computes in float32 for the comparison; the precision
    controls pass another dtype to ``synthesis`` for the layers NVlabs
    runs in float16 (``dtype_low``) or for those it runs in float32
    (``dtype_high``).

The init is NVlabs': per-layer affine bias 1, the input's affine weight 0
and bias [1, 0, 0, 0], random frequencies in a disc and phases, every
``magnitude_ema`` 1, which ``calibrate_magnitudes`` then sets to the mean
square of each layer's input over a calibration batch.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


# --------------------------------------------------------------- filters

def firwin(numtaps: int, cutoff: float, width: float, fs: float
           ) -> np.ndarray:
    """scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs) for one
    low-pass band: the sinc of the cutoff, a Kaiser window whose beta
    follows kaiser_beta(kaiser_atten(numtaps, width / nyq)), scaled to a
    DC gain of 1."""
    nyq = 0.5 * fs
    c = cutoff / nyq
    a = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    if a > 50:
        beta = 0.1102 * (a - 8.7)
    elif a > 21:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = c * np.sinc(c * m)
    h = h * np.kaiser(numtaps, beta)
    return h / np.sum(h)


def design_lowpass_filter(numtaps, cutoff, width, fs):
    if numtaps == 1:
        return None
    return torch.as_tensor(firwin(numtaps, cutoff, width, fs),
                           dtype=torch.float32)


# ------------------------------------------------------------------- ops

def bias_act(x, b=None, act="linear", alpha=0.2, gain=None, clamp=None):
    """_bias_act_ref for 'linear' and 'lrelu' (NCHW, bias on dim 1)."""
    if b is not None:
        x = x + b.reshape([1, -1] + [1] * (x.ndim - 2))
    if act == "lrelu":
        x = F.leaky_relu(x, alpha)
        gain = SQRT2 if gain is None else gain
    else:
        gain = 1.0 if gain is None else gain
    if gain != 1:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def upfirdn2d(x, f, up=1, down=1, padding=(0, 0, 0, 0), gain=1):
    """_upfirdn2d_ref (flip_filter False) for a 1-D (separable) filter or
    None: zero insertion, pad or crop, the filter along W then along H,
    every `down`-th sample."""
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    b, c, h, w = x.shape
    px0, px1, py0, py1 = padding
    x = x.reshape([b, c, h, 1, w, 1])
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape([b, c, h * up, w * up])
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0),
          max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f = f * (gain ** (f.ndim / 2))
    f = f.to(x.dtype).flip(list(range(f.ndim)))
    f = f[None, None].repeat([c, 1] + [1] * f.ndim)
    if f.ndim == 4:
        x = F.conv2d(x, f, groups=c)
    else:
        x = F.conv2d(x, f.unsqueeze(2), groups=c)
        x = F.conv2d(x, f.unsqueeze(3), groups=c)
    return x[:, :, ::down, ::down]


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1,
                   padding=(0, 0, 0, 0), gain=SQRT2, slope=0.2, clamp=None):
    """_filtered_lrelu_ref: bias, upsample (gain up**2), LeakyReLU * gain
    and clamp, downsample."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down)


def modulated_conv2d(x, w, s, demodulate=True, padding=0, input_gain=None):
    """modulated_conv2d: the weight and the style prenormalized (demodulate
    only), the weights modulated and demodulated per sample, the input
    gain, one grouped conv."""
    batch = x.shape[0]
    out_ch, in_ch, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    if demodulate:
        d = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        w = w * d.unsqueeze(2).unsqueeze(3).unsqueeze(4)
    if input_gain is not None:
        g = input_gain.expand(batch, in_ch)
        w = w * g.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    x = x.reshape(1, -1, *x.shape[2:])
    w = w.reshape(-1, in_ch, kh, kw)
    x = F.conv2d(x, w.to(x.dtype), padding=padding, groups=batch)
    return x.reshape(batch, -1, *x.shape[2:])


def fully_connected(params, prefix, x, activation="linear", lr_mul=1.0):
    """FullyConnectedLayer.forward."""
    w = params[prefix + ".weight"].to(x.dtype) * (lr_mul / np.sqrt(
        params[prefix + ".weight"].shape[1]))
    b = params.get(prefix + ".bias")
    if b is not None:
        b = b.to(x.dtype) * lr_mul
    if activation == "linear" and b is not None:
        return torch.addmm(b.unsqueeze(0), x, w.t())
    return bias_act(x.matmul(w.t()), b, act=activation)


# -------------------------------------------------------------- schedule

def schedule(sg: dict) -> dict:
    """SynthesisNetwork.__init__ and SynthesisLayer.__init__'s numbers for
    the configuration's ``stylegan3`` section (NVlabs' argument names)."""
    res = sg["img_resolution"]
    n = sg["num_layers"]
    last_cutoff = res / 2
    last_stopband = last_cutoff * sg["last_stopband_rel"]
    exponents = np.minimum(np.arange(n + 1) / (n - sg["num_critical"]), 1)
    cutoffs = sg["first_cutoff"] * (last_cutoff / sg["first_cutoff"]) \
        ** exponents
    stopbands = sg["first_stopband"] * (
        last_stopband / sg["first_stopband"]) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + sg["margin_size"] * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((sg["channel_base"] / 2) / cutoffs,
                                  sg["channel_max"]))
    channels[-1] = sg["img_channels"]
    layers = []
    for idx in range(n + 1):
        prev = max(idx - 1, 0)
        torgb = idx == n
        in_sr, out_sr = int(rates[prev]), int(rates[idx])
        tmp = max(in_sr, out_sr) * (1 if torgb else sg["lrelu_upsampling"])
        up, down = int(np.rint(tmp / in_sr)), int(np.rint(tmp / out_sr))
        assert in_sr * up == tmp and out_sr * down == tmp
        up_taps = sg["filter_size"] * up if up > 1 and not torgb else 1
        down_taps = sg["filter_size"] * down if down > 1 and not torgb else 1
        k = 1 if torgb else sg["conv_kernel"]
        pad_total = (int(sizes[idx]) - 1) * down + 1
        pad_total -= (int(sizes[prev]) + k - 1) * up
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        pad_hi = pad_total - pad_lo
        layers.append({
            "name": f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}",
            "is_torgb": torgb,
            "use_fp16": bool(rates[idx] * 2 ** sg["num_fp16_res"] > res),
            "in_channels": int(channels[prev]),
            "out_channels": int(channels[idx]),
            "in_size": int(sizes[prev]), "out_size": int(sizes[idx]),
            "in_sampling_rate": in_sr, "out_sampling_rate": out_sr,
            "tmp_sampling_rate": tmp, "conv_kernel": k, "up": up,
            "down": down, "up_taps": up_taps, "down_taps": down_taps,
            "up_filter": (up_taps, float(cutoffs[prev]),
                          float(half_widths[prev]) * 2, tmp),
            "down_filter": (down_taps, float(cutoffs[idx]),
                            float(half_widths[idx]) * 2, tmp),
            "padding": [int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)]})
    return {"input": {"channels": int(channels[0]), "size": int(sizes[0]),
                      "sampling_rate": float(rates[0]),
                      "bandwidth": float(cutoffs[0])},
            "layers": layers, "num_ws": n + 2}


# ------------------------------------------------------------------ init

def init(sg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """NVlabs' init of every parameter and buffer, drawn from `gen` (a
    generator on `device`): the state dict of Generator (c_dim 0) without
    the filter buffers."""
    sched = schedule(sg)
    z_dim, w_dim = sg["z_dim"], sg["w_dim"]
    p: Dict[str, torch.Tensor] = {}
    kw = dict(generator=gen, device=device)
    inp = sched["input"]
    c = inp["channels"]
    freqs = torch.randn([c, 2], **kw)
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    freqs = freqs / (radii * radii.square().exp().pow(0.25))
    freqs = freqs * inp["bandwidth"]
    p["synthesis.input.freqs"] = freqs
    p["synthesis.input.phases"] = torch.rand([c], **kw) - 0.5
    p["synthesis.input.weight"] = torch.randn([c, c], **kw)
    p["synthesis.input.affine.weight"] = torch.zeros([4, w_dim],
                                                     device=device)
    p["synthesis.input.affine.bias"] = torch.tensor([1.0, 0.0, 0.0, 0.0],
                                                    device=device)
    p["synthesis.input.transform"] = torch.eye(3, device=device)
    for L in sched["layers"]:
        pre = "synthesis." + L["name"]
        k = L["conv_kernel"]
        p[pre + ".affine.weight"] = torch.randn([L["in_channels"], w_dim],
                                                **kw)
        p[pre + ".affine.bias"] = torch.ones([L["in_channels"]],
                                             device=device)
        p[pre + ".weight"] = torch.randn(
            [L["out_channels"], L["in_channels"], k, k], **kw)
        p[pre + ".bias"] = torch.zeros([L["out_channels"]], device=device)
        p[pre + ".magnitude_ema"] = torch.ones([], device=device)
    lr_mul = 0.01
    feats = [z_dim] + [w_dim] * sg["mapping_kwargs"]["num_layers"]
    for i, (fi, fo) in enumerate(zip(feats[:-1], feats[1:])):
        p[f"mapping.fc{i}.weight"] = torch.randn([fo, fi], **kw) / lr_mul
        p[f"mapping.fc{i}.bias"] = torch.zeros([fo], device=device)
    p["mapping.w_avg"] = torch.zeros([w_dim], device=device)
    return p


# --------------------------------------------------------------- forward

def mapping(sg: dict, params, z):
    """MappingNetwork.forward (c_dim 0): (B, z_dim) -> (B, num_ws, w_dim)."""
    x = z.to(torch.float32)
    x = x * (x.square().mean(1, keepdim=True) + 1e-8).rsqrt()
    for i in range(sg["mapping_kwargs"]["num_layers"]):
        x = fully_connected(params, f"mapping.fc{i}", x, activation="lrelu",
                            lr_mul=0.01)
    x = x.unsqueeze(1).repeat([1, schedule(sg)["num_ws"], 1])
    return x


def synthesis_input(inp: dict, params, w):
    """SynthesisInput.forward: (B, w_dim) -> (B, C, size, size)."""
    pre = "synthesis.input."
    transforms = params[pre + "transform"].unsqueeze(0)
    freqs = params[pre + "freqs"].unsqueeze(0)
    phases = params[pre + "phases"].unsqueeze(0)
    t = fully_connected(params, pre + "affine", w)
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat(
        [w.shape[0], 1, 1])
    m_r[:, 0, 0] = t[:, 0]
    m_r[:, 0, 1] = -t[:, 1]
    m_r[:, 1, 0] = t[:, 1]
    m_r[:, 1, 1] = t[:, 0]
    m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat(
        [w.shape[0], 1, 1])
    m_t[:, 0, 2] = -t[:, 2]
    m_t[:, 1, 2] = -t[:, 3]
    transforms = m_r @ m_t @ transforms
    phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
    freqs = freqs @ transforms[:, :2, :2]
    amplitudes = (1 - (freqs.norm(dim=2) - inp["bandwidth"])
                  / (inp["sampling_rate"] / 2 - inp["bandwidth"])).clamp(0, 1)
    size, sr = inp["size"], inp["sampling_rate"]
    theta = torch.eye(2, 3, device=w.device)
    theta[0, 0] = 0.5 * size / sr
    theta[1, 1] = 0.5 * size / sr
    grids = F.affine_grid(theta.unsqueeze(0), [1, 1, size, size],
                          align_corners=False)
    x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1)
         .unsqueeze(2)).squeeze(3)
    x = x + phases.unsqueeze(1).unsqueeze(2)
    x = torch.sin(x * (np.pi * 2))
    x = x * amplitudes.unsqueeze(1).unsqueeze(2)
    weight = params[pre + "weight"] / np.sqrt(inp["channels"])
    x = x @ weight.t()
    return x.permute(0, 3, 1, 2)


def synthesis_layer(L: dict, sg: dict, params, x, w, dtype):
    """SynthesisLayer.forward with the layer computing in `dtype`."""
    pre = "synthesis." + L["name"] + "."
    input_gain = params[pre + "magnitude_ema"].rsqrt()
    styles = fully_connected(params, pre + "affine", w)
    if L["is_torgb"]:
        styles = styles * (1 / np.sqrt(L["in_channels"]
                                       * L["conv_kernel"] ** 2))
    x = modulated_conv2d(x.to(dtype), params[pre + "weight"], styles,
                         demodulate=not L["is_torgb"],
                         padding=L["conv_kernel"] - 1, input_gain=input_gain)
    fu = design_lowpass_filter(*L["up_filter"])
    fd = design_lowpass_filter(*L["down_filter"])
    fu = None if fu is None else fu.to(x.device)
    fd = None if fd is None else fd.to(x.device)
    gain = 1 if L["is_torgb"] else SQRT2
    slope = 1 if L["is_torgb"] else 0.2
    x = filtered_lrelu(x, fu, fd, params[pre + "bias"].to(x.dtype),
                       up=L["up"], down=L["down"], padding=L["padding"],
                       gain=gain, slope=slope, clamp=sg["conv_clamp"])
    assert x.shape[1:] == (L["out_channels"], L["out_size"], L["out_size"])
    return x


def synthesis(sg: dict, params, ws, dtype_low=torch.float32,
              dtype_high=torch.float32):
    """SynthesisNetwork.forward: (B, num_ws, w_dim) -> (B, 3, R, R)
    float32; the layers NVlabs runs in float16 compute in `dtype_low`,
    the others in `dtype_high`."""
    sched = schedule(sg)
    ws = ws.to(torch.float32).unbind(dim=1)
    x = synthesis_input(sched["input"], params, ws[0])
    for L, w in zip(sched["layers"], ws[1:]):
        dtype = dtype_low if L["use_fp16"] else dtype_high
        x = synthesis_layer(L, sg, params, x, w, dtype)
    if sg["output_scale"] != 1:
        x = x * sg["output_scale"]
    return x.to(torch.float32)


def generate(sg: dict, params, z, dtype_low=torch.float32,
             dtype_high=torch.float32):
    """Generator.forward (c_dim 0, truncation_psi 1): (B,
    z_dim) -> (B, R, R, 3) float32 NHWC, one image at a time."""
    out = []
    for i in range(z.shape[0]):
        ws = mapping(sg, params, z[i:i + 1])
        out.append(synthesis(sg, params, ws, dtype_low, dtype_high)
                   .permute(0, 2, 3, 1))
    return torch.cat(out)


@torch.no_grad()
def calibrate_magnitudes(sg: dict, params, z) -> List[float]:
    """Set each layer's magnitude_ema, in order, to the mean square of its
    input over the batch z (float32, each layer's input computed with the
    gains set before it): the value training's moving average
    (magnitude_ema_beta) settles at for these weights.  Returns them."""
    sched = schedule(sg)
    ws = mapping(sg, params, z).unbind(dim=1)
    x = synthesis_input(sched["input"], params, ws[0])
    out = []
    for L, w in zip(sched["layers"], ws[1:]):
        m = x.float().square().mean()
        params["synthesis." + L["name"] + ".magnitude_ema"].copy_(m)
        out.append(float(m))
        x = synthesis_layer(L, sg, params, x, w, torch.float32)
    return out
