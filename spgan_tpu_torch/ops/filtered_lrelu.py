"""StyleGAN3's filtered leaky ReLU and the low-pass filters it runs with
(NVlabs stylegan3 ``torch_utils/ops/filtered_lrelu.py``,
``_filtered_lrelu_ref``, and ``SynthesisLayer.design_lowpass_filter``).

One layer's nonlinearity, in ``_filtered_lrelu_ref``'s order:

    x + b  ->  zero-insert upsample by `up`, pad, FIR with fu (gain up**2)
           ->  LeakyReLU(slope) * gain, clamp to [-clamp, clamp]
           ->  FIR with fd, keep every `down`-th sample

The filters are 1-D and separable (applied along W, then along H).

``filtered_lrelu`` runs a CUDA tensor through one hand-written kernel
(ops/kernels/filtered_lrelu.py, csrc/filtered_lrelu.cu), or raises, and
a CPU tensor through the plain version, ``filtered_lrelu_plain``, where
every step is a PyTorch op on the NCHW view of an NHWC tensor:

  * the upsample is polyphase, per axis: one depthwise convolution with
    `up` outputs a channel and one interleave copy, so the zero-inserted
    tensor is never built (``_up_axis``); the batch runs in chunks, as
    PyTorch's depthwise kernel indexes with 32 bits;
  * the downsample is a depthwise convolution of stride `down` per axis,
    so the dropped samples are never computed;
  * ``gain`` is folded into fd (the clamp runs at clamp / gain before it):
    gain * clamp(lrelu(v), +-clamp / gain) = clamp(gain * lrelu(v), +-clamp)
    and fd is linear, which saves one pass over the largest intermediate;
  * ``scale`` (B, C) multiplies x before the bias in the same pass (the
    modulated conv's demodulation, ops/modulated.py).

The plain version keeps its intermediates in x's dtype, as
``_filtered_lrelu_ref`` does; the kernel computes in float32 and rounds
once.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spgan_tpu_torch.ops.kernels import filtered_lrelu as kernel


def kaiser_beta(atten: float) -> float:
    """scipy.signal.kaiser_beta: the Kaiser window's beta for a stopband
    attenuation in dB."""
    if atten > 50:
        return 0.1102 * (atten - 8.7)
    if atten > 21:
        return 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    return 0.0


def firwin(numtaps: int, cutoff: float, width: float, fs: float
           ) -> np.ndarray:
    """scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs): a
    Kaiser-windowed sinc low-pass, its DC gain scaled to 1 (float64)."""
    nyq = 0.5 * fs
    c = cutoff / nyq
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = c * np.sinc(c * m) * np.kaiser(numtaps, kaiser_beta(atten))
    return h / h.sum()


def design_lowpass_filter(numtaps: int, cutoff: float, width: float,
                          fs: float) -> Optional[np.ndarray]:
    """SynthesisLayer.design_lowpass_filter without the radial branch:
    None for one tap (the identity), else the separable Kaiser low-pass
    as float32."""
    if numtaps < 1:
        raise ValueError(f"numtaps {numtaps} < 1")
    if numtaps == 1:
        return None
    return firwin(numtaps, cutoff, width, fs).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _phase_weights(f: Tuple[float, ...], up: int, s: int, c: int,
                   dtype: torch.dtype, device: str) -> torch.Tensor:
    """_up_axis's depthwise weights (c * up, T + 1): phase r of channel c
    at row c * up + r, its taps shifted to the common input offset; made
    once a layer, on the host, as one copy."""
    k, t_ = len(f), len(f) // up
    o = s // up - t_ + 1
    taps = np.zeros((up, t_ + 1), np.float32)
    for r in range(up):
        for t in range(t_ + 1):
            i = r + s - (t + o) * up
            if 0 <= i < k:
                taps[r, t] = f[i]
    return torch.as_tensor(np.tile(taps, (c, 1))).to(device=device,
                                                     dtype=dtype)


@functools.lru_cache(maxsize=None)
def _down_weights(f: Tuple[float, ...], c: int, dtype: torch.dtype,
                  device: str) -> torch.Tensor:
    """_down_axis's depthwise weights (c, k): f flipped (a correlation)."""
    taps = np.asarray(f[::-1], np.float32)
    return torch.as_tensor(np.tile(taps, (c, 1))).to(device=device,
                                                     dtype=dtype)


def _up_axis(x: torch.Tensor, f: Tuple[float, ...], up: int,
             pad: Tuple[int, int], axis: int) -> Tuple[torch.Tensor, int]:
    """upfirdn along one axis (2: H, 3: W) of NCHW x, n samples long:
    zero-insert by `up`, pad (p0, p1) (negative crops), full convolution
    with f (len(f) a multiple of `up`), the valid part, of length L =
    n*up + p0 + p1 - len(f) + 1.

    Polyphase: output sample q*up + r is phase r's correlation of x with
    every up-th tap of f, so the up phases are one depthwise convolution
    with `up` output channels a channel (T + 1 taps, T = len(f) / up,
    each phase's taps shifted to a common input offset), interleaved
    along the axis by one copy.  Returns (y, L): y holds the L valid
    samples along the axis and up to up - 1 more after them, which the
    caller carries to the end (filtered_lrelu drops them there)."""
    k, c, n = len(f), x.shape[1], x.shape[axis]
    t_ = k // up
    s = k - 1 - pad[0]                 # the window's start in the full conv
    length = n * up + pad[0] + pad[1] - k + 1
    o = s // up - t_ + 1               # input offset of tap 0 of every phase
    q = -(-length // up)               # samples a phase
    # symmetric zero padding that covers input indices o .. q - 1 + o + t_
    p = max(0, -o, q + o + t_ - n)
    w = _phase_weights(f, up, s, c, x.dtype, str(x.device))
    if axis == 3:
        y = F.conv2d(x, w.view(c * up, 1, 1, t_ + 1), padding=(0, p),
                     groups=c).narrow(3, o + p, q)
        b, _, h, _ = y.shape
        y = y.view(b, c, up, h, q).permute(0, 1, 3, 4, 2)
        return y.reshape(b, c, h, q * up), length
    y = F.conv2d(x, w.view(c * up, 1, t_ + 1, 1), padding=(p, 0),
                 groups=c).narrow(2, o + p, q)
    b, _, _, wd = y.shape
    y = y.view(b, c, up, q, wd).permute(0, 1, 3, 2, 4)
    return y.reshape(b, c, q * up, wd), length


def _down_axis(x: torch.Tensor, f: Tuple[float, ...], down: int, axis: int,
               n: int) -> Tuple[torch.Tensor, int]:
    """Valid FIR with f along one axis of NCHW x whose first n samples are
    valid, then every `down`-th sample: a strided depthwise correlation.
    Returns (y, valid outputs); the outputs past them read the invalid
    tail and are dropped at the end."""
    k, c = len(f), x.shape[1]
    w = _down_weights(f, c, x.dtype, str(x.device))
    if axis == 2:
        y = F.conv2d(x, w.view(c, 1, k, 1), stride=(down, 1), groups=c)
    else:
        y = F.conv2d(x, w.view(c, 1, 1, k), stride=(1, down), groups=c)
    return y, (n - k) // down + 1


# PyTorch's depthwise convolutions index with 32 bits
MAX_ELEMENTS = 2 ** 31 - 1


def filtered_lrelu(x: torch.Tensor, fu: Sequence[float],
                   fd: Sequence[float], b: torch.Tensor,
                   scale: torch.Tensor, up: int, down: int,
                   padding: Sequence[int], gain: float = math.sqrt(2),
                   slope: float = 0.2,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """x (B, H, W, C) -> (B, H', W', C) in x's dtype, contiguous, as
    ``_filtered_lrelu_ref(x * scale, fu, fd, b, up, down, padding, gain,
    slope, clamp)`` computes it on the NCHW tensor: fu and fd the 1-D
    filters' taps on the host, scale (B, C), padding (px0, px1, py0, py1)
    (module docstring).  A CUDA tensor launches the kernel or the call
    raises; a CPU tensor takes filtered_lrelu_plain."""
    if x.device.type == "cpu":
        return filtered_lrelu_plain(x, fu, fd, b, scale, up, down, padding,
                                    gain, slope, clamp)
    return kernel.filtered_lrelu(x, fu, fd, b, scale, up, down, padding,
                                 gain, slope, clamp)


def filtered_lrelu_plain(x: torch.Tensor, fu: Sequence[float],
                         fd: Sequence[float], b: torch.Tensor,
                         scale: torch.Tensor, up: int, down: int,
                         padding: Sequence[int], gain: float = math.sqrt(2),
                         slope: float = 0.2,
                         clamp: Optional[float] = None) -> torch.Tensor:
    """filtered_lrelu composed of PyTorch ops, on any device.  Outside
    autograd: it works in place on its own intermediates.

    The batch runs in chunks whose largest intermediate, the upsampled
    tensor before its interleave, stays under MAX_ELEMENTS."""
    bsz, h, w, c = x.shape
    k = len(fu)
    per_sample = c * (h * up + 2 * k + 2 * up) * (w * up + 2 * k + 2 * up)
    n = max(1, MAX_ELEMENTS // per_sample)
    args = (fu, fd, b, up, down, padding, gain, slope, clamp)
    if n >= bsz:
        return _filtered_lrelu(x, scale, *args)
    out = None
    for i in range(0, bsz, n):
        y = _filtered_lrelu(x[i:i + n], scale[i:i + n], *args)
        if out is None:
            out = torch.empty((bsz,) + y.shape[1:], dtype=y.dtype,
                              device=y.device)
        out[i:i + n] = y
    return out


def _filtered_lrelu(x, scale, fu, fd, b, up, down, padding, gain, slope,
                    clamp) -> torch.Tensor:
    """filtered_lrelu on a batch small enough for 32-bit indexing."""
    px0, px1, py0, py1 = padding
    bsz, h, w, c = x.shape
    # bias and scale in one pass into an NCHW tensor, where the depthwise
    # convolutions below run on PyTorch's own kernels
    y = torch.empty((bsz, c, h, w), dtype=x.dtype, device=x.device)
    torch.addcmul(b.to(x.dtype), x, scale.to(x.dtype)[:, None, None, :],
                  out=y.permute(0, 2, 3, 1))
    fu = tuple(float(v) * up for v in fu)     # gain up**2 over the two axes
    y, nw = _up_axis(y, fu, up, (px0, px1), 3)
    y, nh = _up_axis(y, fu, up, (py0, py1), 2)
    # gain folded into fd (module docstring)
    y = F.leaky_relu(y, slope, inplace=True)
    if clamp is not None:
        y = y.clamp_(-clamp / gain, clamp / gain)
    fd = tuple(float(v) * math.sqrt(gain) for v in fd)
    y, nh = _down_axis(y, fd, down, 2, nh)
    y, nw = _down_axis(y, fd, down, 3, nw)
    return y[:, :, :nh, :nw].permute(0, 2, 3, 1).contiguous()
