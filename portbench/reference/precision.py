"""The controls' lower precisions: the operands of every convolution and
matrix product rounded, as a lower-precision path would round them, while
products and sums stay in float32.

  fp8   float8 e4m3 with one scale per tensor (its largest magnitude at
        448), the step below bfloat16
  tf32  TF32, the step below float32 with TF32 off: on a CUDA device the
        card's own TF32 (cuDNN and matmuls, forward and backward); on the
        CPU, which has none, the operands rounded to TF32's 10 mantissa
        bits (to nearest)

The rounding is straight-through (its gradient is the identity), so a
graph through it still differentiates; backward products are not
rounded.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ROUNDINGS = ("float32", "fp8", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-30) / 448.0
    q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


_GEMMS = {F.conv2d, F.conv_transpose2d, torch.conv2d, torch.conv_transpose2d,
          F.linear, torch.matmul, torch.mm,
          torch.bmm, torch.einsum, torch.Tensor.__matmul__,
          torch.Tensor.matmul}


class _Rounded(TorchFunctionMode):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def _q(self, a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            q = self.fn(a.detach())
            return a + (q - a).detach() if a.requires_grad else q
        if isinstance(a, (list, tuple)):
            return type(a)(self._q(v) for v in a)
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _GEMMS:
            if func is torch.einsum:
                args = (args[0],) + tuple(self._q(a) for a in args[1:])
            else:
                # the two operands; a bias stays as it is
                args = tuple(self._q(a) if i < 2 else a
                             for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextlib.contextmanager
def rounded(rounding: str, device):
    """Run the inside in `rounding` (ROUNDINGS) on `device`."""
    if rounding == "float32":
        yield
    elif rounding == "tf32" and torch.device(device).type == "cuda":
        old = (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = old
    else:
        fn = {"fp8": round_fp8, "tf32": round_tf32}[rounding]
        with _Rounded(fn):
            yield
