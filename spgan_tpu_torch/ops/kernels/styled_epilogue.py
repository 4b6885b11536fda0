"""The styled conv's epilogue: the CUDA kernel ``csrc/styled_epilogue.cu``
and its plain PyTorch version.

    out = gain * lrelu(y * demod[b, c] + nw * noise[b, h, w] + bias[c], slope)

y is a styled conv's NHWC output before demodulation, demod its (B, C)
demodulation factors, noise a (B, H, W, 1) map or None, nw the noise
injection's weight (a one-element tensor), bias the activation's (C,)
bias.  Both versions compute in float32 and round once to y's dtype; in
float32 each step rounds as StyledConv's composed ops do
(ops/modulated.py), so the two give the same bits.

Dispatch: a CPU tensor takes the plain version (a new tensor); a CUDA
tensor launches the kernel, which writes the result over y and returns
y, or the call raises.  The kernel takes float32 and bf16 with C a
multiple of its 16-byte vector (``takes``).  It reads demod, bias and nw
from the device, launches on PyTorch's current stream, allocates nothing
and does not synchronise.  Each launch adds one to the tracer's counter
``spgan.styled_epilogue.launches`` (utils/trace.py).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from spgan_tpu_torch.ops.linear import SQRT2
from spgan_tpu_torch.utils import trace

SLOPE = 0.2
VECTOR_BYTES = 16  # the kernel's loads and stores
MAX_VECTORS = 1024  # C / vector width: one block's threads at most
DTYPES = (torch.float32, torch.bfloat16)


def takes(dtype: torch.dtype, channels: int) -> bool:
    """Whether the kernel takes activations of `dtype` with `channels`."""
    if dtype not in DTYPES:
        return False
    per = VECTOR_BYTES // torch.empty((), dtype=dtype).element_size()
    return channels % per == 0 and channels // per <= MAX_VECTORS


def styled_epilogue_plain(y: torch.Tensor, demod: torch.Tensor,
                          bias: torch.Tensor,
                          noise: Optional[torch.Tensor] = None,
                          noise_weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The epilogue in PyTorch ops, in float32, rounded once to y's dtype."""
    t = y.float() * demod.float()[:, None, None, :]
    if noise is not None:
        t = t + noise_weight.float() * noise.float()
    t = t + bias.float()
    return (F.leaky_relu(t, SLOPE) * SQRT2).to(y.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/styled_epilogue.cu, built at first use, argument types set
    once."""
    from spgan_tpu_torch.utils import native

    lib = native.load_cuda("styled_epilogue")
    lib.styled_epilogue_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
        + [ctypes.c_void_p])
    lib.styled_epilogue_launch.restype = ctypes.c_int
    return lib


def _small(t: torch.Tensor, name: str, numel: int, dev) -> torch.Tensor:
    """A float32, contiguous (B, C), (C,) or one-element operand on `dev`
    (a no-op for the float32 tensors StyledConv passes)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, y on {dev}")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, want {numel}")
    return t.float().contiguous()


def _launch(y: torch.Tensor, demod: torch.Tensor, bias: torch.Tensor,
            noise: Optional[torch.Tensor],
            noise_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Check the operands and launch csrc/styled_epilogue.cu over y on the
    current stream; raises on anything the kernel does not take."""
    if y.ndim != 4:
        raise ValueError(f"y must be (B,H,W,C), got {tuple(y.shape)}")
    B, H, W, C = y.shape
    if not takes(y.dtype, C):
        raise ValueError(f"y of {y.dtype} with {C} channels: the kernel takes "
                         f"float32 or bfloat16 with C a multiple of its "
                         f"{VECTOR_BYTES}-byte vector")
    if not y.is_contiguous() or y.data_ptr() % VECTOR_BYTES:
        raise ValueError("y must be contiguous and 16-byte aligned")
    if (noise is None) != (noise_weight is None):
        raise ValueError("noise and noise_weight come together")
    if demod.shape != (B, C):
        raise ValueError(f"demod must be {(B, C)}, got {tuple(demod.shape)}")
    dev = y.device
    demod = _small(demod, "demod", B * C, dev)
    bias = _small(bias, "bias", C, dev)
    if noise is not None:
        if noise.shape not in ((B, H, W, 1), (B, H, W)):
            raise ValueError(f"noise must be {(B, H, W, 1)}, got "
                             f"{tuple(noise.shape)}")
        if noise.device != dev or noise.dtype != y.dtype or \
                not noise.is_contiguous():
            raise ValueError(f"noise must be contiguous {y.dtype} on {dev}")
        noise_weight = _small(noise_weight, "noise_weight", 1, dev)
    if y.numel() == 0:
        return y
    # the launch reads the current device: switch only when y lies elsewhere
    on_y = (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with on_y:
        err = _lib().styled_epilogue_launch(
            y.data_ptr(), y.data_ptr(), demod.data_ptr(), bias.data_ptr(),
            None if noise is None else noise.data_ptr(),
            None if noise is None else noise_weight.data_ptr(),
            B, H * W, C, int(y.dtype == torch.bfloat16), SLOPE, SQRT2,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"styled_epilogue_launch failed: cudaError {err}")
    trace.count("spgan.styled_epilogue.launches")
    return y


def styled_epilogue(y: torch.Tensor, demod: torch.Tensor, bias: torch.Tensor,
                    noise: Optional[torch.Tensor] = None,
                    noise_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The epilogue of y (B,H,W,C): the kernel over y itself on a CUDA
    tensor, the plain version on a CPU one.  Not differentiable: callers
    under autograd compose the ops."""
    if y.device.type == "cpu":
        return styled_epilogue_plain(y, demod, bias, noise, noise_weight)
    if y.device.type != "cuda":
        raise ValueError(f"styled_epilogue needs CPU or CUDA tensors, got "
                         f"{y.device}")
    return _launch(y, demod, bias, noise, noise_weight)
