"""Fused spherical resample + stride-k conv: the CUDA kernel
``csrc/sphere_conv.cu`` behind the JAX package's two entry points, and its
plain PyTorch version.

Replaces spgan_tpu/ops/pallas/sphere_kernel.py::fused_sphere_conv_grouped
and ::fused_sphere_conv.  Every output row r, tap t samples the input at a
uniform translation (r + dy(r,t), c + dx(r,t)) described by the row-offset
tables of geometry/sphere_grid.sphere_offset_tables, so the op is an
implicit GEMM (M = B*H*W pixels, K = 9*C, N = Cout) whose A tile is built on
the fly from two input rows.  Compute-bound on an H100 at the engine's
shapes (see the source's note).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises.  Each wrapper counts its kernel launches in
the tracer's counters (utils/trace.py): ``spgan.sphere_conv.grouped.launches``
and ``spgan.sphere_conv.launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from spgan_tpu_torch.ops.kernels.taps import TABLE_DTYPES, sample_tap
from spgan_tpu_torch.utils import trace


def fused_sphere_conv_plain(x: torch.Tensor, tables: dict, w9: torch.Tensor,
                            groups: int, margin: int = 6) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: both lerps in float32, the
    staged tap rounded once to bf16 when x and w9 are bf16, products and
    tap sums in float32, output cast to x's dtype."""
    B, H, W, C = x.shape
    K2, _, Cout = w9.shape
    mxu_bf16 = x.dtype == torch.bfloat16 and w9.dtype == torch.bfloat16
    xg = x.reshape(groups, B // groups, H, W, C)
    acc = torch.zeros((B * H * W, Cout), dtype=torch.float32, device=x.device)
    for t in range(K2):
        tap = sample_tap(xg, tables, t, margin)
        if mxu_bf16:
            tap = tap.to(torch.bfloat16).float()
        acc = acc + tap.reshape(-1, C) @ w9[t].float()
    return acc.reshape(B, H, W, Cout).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """csrc/sphere_conv.cu's launch function, built at first use."""
    from spgan_tpu_torch.utils import native

    fn = native.load_cuda("sphere_conv").sphere_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, tables: dict, w9: torch.Tensor, groups: int,
            margin: int) -> torch.Tensor:
    """Check the operands and launch csrc/sphere_conv.cu on the current
    stream; raises on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"sphere conv kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w9.dtype != x.dtype:
        raise ValueError(f"x/w9 must both be float32 or bfloat16, got "
                         f"{x.dtype}/{w9.dtype}")
    if x.ndim != 4 or w9.ndim != 3 or w9.shape[1] != x.shape[3]:
        raise ValueError(f"shapes x {tuple(x.shape)} w9 {tuple(w9.shape)}")
    B, H, W, C = x.shape
    K2, _, Cout = w9.shape
    if groups <= 0 or B % groups:
        raise ValueError(f"batch {B} is not a multiple of groups {groups}")
    if C % 8 or Cout % 8:
        raise ValueError(f"C={C} and Cout={Cout} must be multiples of 8")
    if margin < 1:
        raise ValueError(f"margin {margin} < 1")
    if x.dtype == torch.bfloat16 and (W < 4 or x.numel() >= 2 ** 31):
        raise ValueError(f"the bf16 kernel takes W >= 4 (a strip of 4 "
                         f"pixels crosses at most one image row) and fewer "
                         f"than 2^31 elements of x (32-bit offsets); got W="
                         f"{W}, {x.numel()} elements")
    # device indices, not device objects: at the engine's small shapes the
    # card finishes a launch in about the time these checks take
    dev = x.get_device()
    args = []
    for k, dt in TABLE_DTYPES.items():
        t = tables[k]
        if (t.dtype != dt or t.shape != (groups, H, K2) or t.get_device() != dev
                or not t.is_contiguous()):
            raise ValueError(f"table {k}: need contiguous {dt} "
                             f"{(groups, H, K2)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.data_ptr())
    for name, t in (("x", x), ("w9", w9)):
        if t.get_device() != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned, on "
                             f"{x.device}")
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    # the launch reads the current device: switch only when x lies elsewhere
    on_x = (contextlib.nullcontext() if dev == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with on_x:
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), *args,
                        w9.data_ptr(), out.data_ptr(), B, H, W, C, Cout, K2,
                        B // groups, margin,
                        1 if x.dtype == torch.bfloat16 else 0, stream)
    if err != 0:
        raise RuntimeError(f"sphere_conv_launch failed: cudaError {err}")
    return out


def fused_sphere_conv_grouped(x: torch.Tensor, tables: dict, w9: torch.Tensor,
                              groups: int, margin: int = 6) -> torch.Tensor:
    """x: (B,H,W,C) [pre-scaled by the per-sample style] with B = groups*Bg;
    tables: dict of (groups, H, K2), each shared by Bg consecutive samples
    (all panoramas folded at one lattice position); w9: (K2,C,Cout).
    Returns (B,H,W,Cout) before demodulation, in x's dtype."""
    if x.device.type == "cpu":
        return fused_sphere_conv_plain(x, tables, w9, groups, margin)
    out = _launch(x, tables, w9, groups, margin)
    trace.count("spgan.sphere_conv.grouped.launches")
    return out


def fused_sphere_conv(x: torch.Tensor, tables: dict, w9: torch.Tensor,
                      margin: int = 6) -> torch.Tensor:
    """Per-sample tables: dict of (B,H,K2).  Otherwise as
    fused_sphere_conv_grouped."""
    if x.device.type == "cpu":
        return fused_sphere_conv_plain(x, tables, w9, x.shape[0], margin)
    out = _launch(x, tables, w9, x.shape[0], margin)
    trace.count("spgan.sphere_conv.launches")
    return out
