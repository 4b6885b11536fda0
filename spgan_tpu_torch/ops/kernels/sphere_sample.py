"""Spherical tap sampler: the CUDA kernel ``csrc/sphere_sample.cu`` behind
the JAX package's training-time sampler, its plain PyTorch version, and the
straight-through wrapper the sphere convs train through.

Replaces spgan_tpu/ops/pallas/sphere_sample.py::sphere_sample_taps.  For
every sample b, tap t and output row r, the taps are a uniformly
translated bilinear resample of the input described by the row-offset
tables of geometry/sphere_grid.sphere_offset_tables: mix input rows y0/y1
by wy, then columns clamp(c+sx) and clamp(c+sx+1) by fx, with sx clipped
to [-margin, margin-1] (the TPU kernel's edge padding).  Output is
tap-major (B, K2, H, W, C).  Write-bound on an H100: the kernel stages
the input rows of each tap row of the 3x3 kernel in shared memory once and
streams the output with 16-byte stores (see the source's note).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises.  The wrapper counts its kernel launches in the
tracer's counter ``spgan.sphere_sample.launches`` (utils/trace.py).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from spgan_tpu_torch.ops.kernels.taps import TABLE_DTYPES, sample_tap
from spgan_tpu_torch.utils import trace


def sphere_sample_taps_plain(x: torch.Tensor, tables: dict,
                             margin: int = 6) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: per-sample tables (B,H,K2);
    each tap in float32, cast once to x's dtype.  Returns (B,K2,H,W,C)."""
    B = x.shape[0]
    K2 = tables["y0"].shape[-1]
    xg = x.reshape(B, 1, *x.shape[1:])
    return torch.stack([sample_tap(xg, tables, t, margin)[:, 0].to(x.dtype)
                        for t in range(K2)], dim=1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/sphere_sample.cu, built at first use, argument types set once."""
    from spgan_tpu_torch.utils import native

    lib = native.load_cuda("sphere_sample")
    lib.sphere_sample_launch.argtypes = ([ctypes.c_void_p] * 7
                                         + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p])
    lib.sphere_sample_launch.restype = ctypes.c_int
    lib.sphere_sample_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.sphere_sample_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def staging_plan(dev: int, W: int, C: int, bf16: bool) -> tuple:
    """(row slots, dynamic shared-memory bytes, resident blocks per SM) of
    a launch on CUDA device `dev` whose input rows hold W*C elements.  The
    slots are 0 when two rows do not fit in a block's shared memory."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(dev):
        err = _lib().sphere_sample_plan(W, C, int(bf16),
                                        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"sphere_sample_plan failed: cudaError {err}")
    return tuple(v.value for v in vals)


def _launch(x: torch.Tensor, tables: dict, margin: int) -> torch.Tensor:
    """Check the operands and launch csrc/sphere_sample.cu on the current
    stream; raises on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"sphere sample kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B,H,W,C) tensor, got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    K2 = tables["y0"].shape[-1]
    if margin < 1:
        raise ValueError(f"margin {margin} < 1")
    # device indices, not device objects: at the smaller training shapes
    # the card finishes a launch in about the time these checks take
    dev = x.get_device()
    args = []
    for k, dt in TABLE_DTYPES.items():
        t = tables[k]
        if (t.dtype != dt or t.shape != (B, H, K2) or t.get_device() != dev
                or not t.is_contiguous()):
            raise ValueError(f"table {k}: need contiguous {dt} {(B, H, K2)} "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        args.append(t.data_ptr())
    if B * K2 * H * W * C >= 2 ** 31:
        raise ValueError(f"output of {B * K2 * H * W * C} elements: the "
                         f"kernel's 32-bit offsets take fewer than 2^31")
    bf16 = x.dtype == torch.bfloat16
    if staging_plan(dev, W, C, bf16)[0] == 0:
        raise ValueError(f"an input row of W*C = {W * C} elements does not "
                         f"fit twice in a block's shared memory")
    out = torch.empty((B, K2, H, W, C), dtype=x.dtype, device=x.device)
    # the launch reads the current device: switch only when x lies elsewhere
    on_x = (contextlib.nullcontext() if dev == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with on_x:
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().sphere_sample_launch(
            x.data_ptr(), *args, out.data_ptr(), B, H, W, C, K2, margin,
            int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"sphere_sample_launch failed: cudaError {err}")
    return out


def sphere_sample_taps(x: torch.Tensor, tables: dict,
                       margin: int = 6) -> torch.Tensor:
    """x: (B,H,W,C); tables: per-sample dict of (B,H,K2).  Returns the
    sampled taps (B,K2,H,W,C) in x's dtype (primal only: wrap with
    st_sample_taps to train through it)."""
    if x.device.type == "cpu":
        return sphere_sample_taps_plain(x, tables, margin)
    out = _launch(x, tables, margin)
    trace.count("spgan.sphere_sample.launches")
    return out


def st_sample_taps(z: torch.Tensor, tables: dict) -> torch.Tensor:
    """Straight-through tap sampler: forward == sphere_sample_taps; the
    gradient w.r.t. z is 0.1 * the mean over taps of the cotangent (the
    reference's 3x3 block-mean backward in the tap-major layout), and
    nothing flows to the tables.  Plain tensor algebra, so it stays twice
    differentiable (R1 and PPL)."""
    k2 = tables["y0"].shape[-1]
    primal = sphere_sample_taps(z.detach(), tables)
    lin = (0.1 / k2) * z[:, None].expand(z.shape[0], k2, *z.shape[1:])
    return primal + lin - lin.detach()
