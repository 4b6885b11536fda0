"""upfirdn2d: the CUDA kernel ``csrc/upfirdn2d.cu``, its plain PyTorch
version, and the autograd Function that makes each derivative the same op.

Zero-insert upsample by ``up``, pad (or crop) by (py0, py1, px0, px1),
FIR filter with a stencil of at most 4x4 (taken as a convolution: the
stencil is flipped), keep every ``down``-th sample; NHWC in and out.  The
padding follows the reference's CUDA upfirdn2d: zero insertion makes up*H
samples, so the output has (up*H + py0 + py1 - kh) // down + 1 rows.

Replaces no TPU kernel (the JAX package's upfirdn2d is XLA's depthwise
convolution, spgan_tpu/ops/upfirdn.py); it stands where the reference
has models/custom_ops/upfirdn2d_kernel.cu.  The op is linear in x and its
stencil is a constant, so the gradient of x is upfirdn2d of the
cotangent with the flipped stencil, up and down swapped and the adjoint
pads.  ``UpFirDn2d.backward`` calls the Function itself: a first, second
or later derivative is one more launch of the kernel (PyTorch's double
backward of a depthwise convolution runs one convolution per channel),
and nothing of x is saved.

Dispatch: a CPU tensor takes the plain version (a depthwise F.conv2d)
inside the same Function, so CPU tests exercise the adjoint; a CUDA
tensor launches the kernel or the call raises.  Each kernel launch adds
one to the tracer's counter ``spgan.upfirdn.launches`` (utils/trace.py).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spgan_tpu_torch.utils import trace

MAX_TAPS = 4  # the kernel's largest stencil side


@functools.lru_cache(maxsize=None)
def _fir_weight(flat: Tuple[float, ...], kh: int, channels: int,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Depthwise conv weight (C,1,kh,kw) of the flipped FIR kernel, made
    once per (kernel, width, dtype, device) instead of copied to the
    device at every call.  Made outside inference mode even when the first
    call is inside it, so the cached tensor also serves autograd."""
    with torch.inference_mode(False):
        k = torch.tensor(flat, dtype=torch.float32).reshape(kh, -1).flip(0, 1)
        return k[None, None].expand(channels, 1, *k.shape).contiguous().to(
            device=device, dtype=dtype)


def _depthwise(x: torch.Tensor, k2d: np.ndarray, *, lhs_dilation: int = 1,
               padding=((0, 0), (0, 0)), stride: int = 1) -> torch.Tensor:
    """NHWC depthwise correlation with the *flipped* FIR kernel over the
    input dilated by ``lhs_dilation`` (zeros between samples: size
    up*H-(up-1)) and padded by ``padding`` ((lo,hi) per spatial dim,
    negative = crop)."""
    b, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor
    up = lhs_dilation
    if up > 1:
        z = xc.new_zeros((b, c, up * h - (up - 1), up * w - (up - 1)))
        z[:, :, ::up, ::up] = xc
        xc = z
    (ph0, ph1), (pw0, pw1) = padding
    if ph0 or ph1 or pw0 or pw1:
        xc = F.pad(xc, (pw0, pw1, ph0, ph1))
    wt = _fir_weight(tuple(np.asarray(k2d, np.float32).ravel().tolist()),
                     k2d.shape[0], c, x.dtype, x.device)
    y = F.conv2d(xc, wt, stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)


def out_size(n: int, k: int, up: int, down: int, p0: int, p1: int) -> int:
    """Output length along one axis of n samples."""
    return (up * n + p0 + p1 - k) // down + 1


def upfirdn2d_plain(x: torch.Tensor, taps: Tuple[float, ...], kh: int,
                    up: int, down: int, pad: Tuple[int, int, int, int]
                    ) -> torch.Tensor:
    """The op in PyTorch ops: zero insertion, padding and a depthwise
    F.conv2d with the flipped stencil and stride ``down``."""
    py0, py1, px0, px1 = pad
    k2d = np.asarray(taps, np.float32).reshape(kh, -1)
    return _depthwise(x, k2d, lhs_dilation=up,
                      padding=((py0, py1 + up - 1), (px0, px1 + up - 1)),
                      stride=down)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/upfirdn2d.cu, built at first use, argument types set once."""
    from spgan_tpu_torch.utils import native

    lib = native.load_cuda("upfirdn2d")
    lib.upfirdn2d_launch.argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.POINTER(ctypes.c_float)]
                                     + [ctypes.c_int] * 13
                                     + [ctypes.c_void_p])
    lib.upfirdn2d_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _flipped_taps(taps: Tuple[float, ...]):
    """The stencil flipped in both axes (the reversed row-major list), as
    the float array the launch reads."""
    return (ctypes.c_float * len(taps))(*reversed(taps))


def _launch(x: torch.Tensor, taps: Tuple[float, ...], kh: int, up: int,
            down: int, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Check the operands and launch csrc/upfirdn2d.cu on the current
    stream; raises on anything the kernel does not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    kw = len(taps) // kh
    if kh > MAX_TAPS or kw > MAX_TAPS:
        raise ValueError(f"a {kh}x{kw} stencil: the kernel takes at most "
                         f"{MAX_TAPS}x{MAX_TAPS}")
    if up not in (1, 2) or down not in (1, 2):
        raise ValueError(f"up {up}, down {down}: the kernel takes 1 or 2")
    x = x.contiguous()
    B, H, W, C = x.shape
    py0, py1, px0, px1 = pad
    oh = out_size(H, kh, up, down, py0, py1)
    ow = out_size(W, kw, up, down, px0, px1)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"upfirdn2d of {tuple(x.shape)} with a {kh}x{kw} "
                         f"stencil, up {up}, down {down}, pad {pad}: "
                         f"empty output")
    out = torch.empty((B, oh, ow, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    dev = x.get_device()
    # the launch reads the current device: switch only when x lies elsewhere
    on_x = (contextlib.nullcontext() if dev == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with on_x:
        err = _lib().upfirdn2d_launch(
            x.data_ptr(), out.data_ptr(), _flipped_taps(taps), B, H, W, C,
            oh, ow, up, down, kh, kw, py0, px0,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"upfirdn2d_launch failed: cudaError {err}")
    trace.count("spgan.upfirdn.launches")
    return out


def _run(x, taps, kh, up, down, pad):
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, taps, kh, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d needs CPU or CUDA tensors, got {x.device}")
    return _launch(x, taps, kh, up, down, pad)


def adjoint(taps: Tuple[float, ...], kh: int, up: int, down: int,
            pad: Tuple[int, int, int, int], in_hw: Tuple[int, int],
            out_hw: Tuple[int, int]):
    """(taps, kh, up, down, pad) of the op that maps the cotangent of an
    (out_hw) output to the gradient of its (in_hw) input: the stencil
    flipped, up and down swapped, the low pads k-1-p0 and the high pads
    that give back in_hw samples."""
    kw = len(taps) // kh
    py0, _, px0, _ = pad
    (h, w), (oh, ow) = in_hw, out_hw
    qy0, qx0 = kh - 1 - py0, kw - 1 - px0
    qy1 = up * (h - 1) + kh - qy0 - down * oh
    qx1 = up * (w - 1) + kw - qx0 - down * ow
    return tuple(reversed(taps)), kh, down, up, (qy0, qy1, qx0, qx1)


class UpFirDn2d(torch.autograd.Function):
    """upfirdn2d whose backward is itself with the adjoint parameters."""

    @staticmethod
    def forward(ctx, x, taps, kh, up, down, pad):
        y = _run(x, taps, kh, up, down, pad)
        ctx.op = (taps, kh, up, down, pad, (x.shape[1], x.shape[2]),
                  (y.shape[1], y.shape[2]))
        return y

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        taps, kh, up, down, pad, in_hw, out_hw = ctx.op
        dx = UpFirDn2d.apply(dy, *adjoint(taps, kh, up, down, pad, in_hw,
                                          out_hw))
        return dx, None, None, None, None, None


def upfirdn2d(x: torch.Tensor, taps: Tuple[float, ...], kh: int, up: int = 1,
              down: int = 1, pad: Tuple[int, int, int, int] = (0, 0, 0, 0)
              ) -> torch.Tensor:
    """x (B,H,W,C); taps the (kh, kw) stencil row-major, as a tuple of
    floats (unflipped: the op convolves); pad (py0, py1, px0, px1)."""
    return UpFirDn2d.apply(x, taps, kh, up, down, tuple(pad))
