"""StyleGAN3's filtered LeakyReLU as one CUDA kernel
(``csrc/filtered_lrelu.cu``): a layer's conv output read once, its output
written once, no intermediate in device memory.

It computes what ``ops/filtered_lrelu.py::filtered_lrelu_plain`` does
(the plain version: the same op composed of PyTorch calls), in float32
throughout, rounded once to x's dtype: x (B, H, W, C) times scale (B, C)
plus bias (C,), upsampled by `up` with fu, LeakyReLU times gain and the
clamp, downsampled by 2 with fd, the output (B, H', W', C) contiguous.

``ops/filtered_lrelu.py::filtered_lrelu`` sends a CUDA tensor here and a
CPU tensor to the plain version.  Here a CUDA tensor launches the kernel
or the call raises.  The kernel takes float32 and float16, up 2 or 4
with at most 6 taps a phase, down 2 with at most 12 taps, any padding
and any C (``check``).  It launches on PyTorch's current stream and does
not synchronise; the wrapper allocates the output.  Each launch adds one
to the tracer's counter ``spgan.filtered_lrelu.launches``
(utils/trace.py).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from spgan_tpu_torch.utils import trace

DTYPES = (torch.float32, torch.float16)
UPS = (2, 4)
DOWN = 2
TAPS_A_PHASE = 6    # up taps at most: 6 * up
DOWN_TAPS = 12      # down taps at most
TILE = 26           # output samples a block's tile side (csrc: TO)
COUNTER = "spgan.filtered_lrelu.launches"


def out_size(n: int, up: int, pad: Tuple[int, int], up_taps: int,
             down_taps: int) -> int:
    """Output samples along an axis of n input samples: the up FIR's valid
    length n * up + p0 + p1 - up_taps + 1, then the down FIR's kept
    samples (the plain version's arithmetic)."""
    length = n * up + pad[0] + pad[1] - up_taps + 1
    return (length - down_taps) // DOWN + 1


def tile_plan(n_out: int, pad0: int, up: int) -> Tuple[int, int, int, int]:
    """The kernel's tiles along one axis: (o0, i0, rb, tiles).  Tile t
    covers output samples o0 + t * TILE .. + TILE - 1; its up-domain
    samples start at DOWN * o0 - pad0 + DOWN * TILE * t in the
    zero-inserted input, which is up * (i0 + DOWN * TILE / up * t) + rb.
    o0 is 0, or -1 where that makes the up FIR's phase rb 0 or 1 (up 4,
    an even pad0), the two phases the kernel is built for."""
    for o0 in (0, -1):
        start = DOWN * o0 - pad0
        rb = start % up
        if rb <= 1:
            return o0, (start - rb) // up, rb, -(-(n_out - o0) // TILE)
    raise AssertionError(f"no phase 0 or 1 for pad {pad0}, up {up}")


def check(x: torch.Tensor, fu: Sequence[float], fd: Sequence[float],
          up: int, down: int, padding: Sequence[int]) -> Tuple[int, int]:
    """The output's (H', W'), or ValueError naming what the kernel does
    not take."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B,H,W,C), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x of {x.dtype}: the kernel takes float32 or "
                         f"float16")
    if up not in UPS or down != DOWN:
        raise ValueError(f"up {up}, down {down}: the kernel takes up 2 or "
                         f"4 and down 2")
    if not 1 <= len(fu) <= TAPS_A_PHASE * up or \
            not 1 <= len(fd) <= DOWN_TAPS:
        raise ValueError(f"{len(fu)} up and {len(fd)} down taps: the kernel "
                         f"takes at most {TAPS_A_PHASE * up} and {DOWN_TAPS}")
    if len(padding) != 4:
        raise ValueError(f"padding must be (px0, px1, py0, py1), got "
                         f"{padding}")
    B, H, W, _ = x.shape
    px0, px1, py0, py1 = (int(p) for p in padding)
    ho = out_size(H, up, (py0, py1), len(fu), len(fd))
    wo = out_size(W, up, (px0, px1), len(fu), len(fd))
    if ho <= 0 or wo <= 0:
        raise ValueError(f"an output of {ho}x{wo} from {H}x{W}")
    tiles = (tile_plan(ho, py0, up)[3] * tile_plan(wo, px0, up)[3])
    if not 1 <= B <= 65535 or tiles > 65535:
        raise ValueError(f"batch {B} and {tiles} tiles: the grid takes "
                         f"65535 of each")
    return ho, wo


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/filtered_lrelu.cu, built at first use, argument types set
    once."""
    from spgan_tpu_torch.utils import native

    lib = native.load_cuda("filtered_lrelu")
    lib.filtered_lrelu_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.filtered_lrelu_launch.restype = ctypes.c_int
    return lib


def _small(t: torch.Tensor, name: str, shape: Tuple[int, ...], dev
           ) -> torch.Tensor:
    """A float32, contiguous (B, C) or (C,) operand on `dev` (a no-op for
    the float32 tensors StyleGAN3's layers pass)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return t.float().contiguous()


def _taps(f: Sequence[float], factor: float):
    """f flipped (the kernel correlates) times `factor`, as a C array."""
    vals = [float(v) * factor for v in reversed(list(f))]
    return (ctypes.c_float * len(vals))(*vals)


def _launch(x: torch.Tensor, fu: Sequence[float], fd: Sequence[float],
            b: torch.Tensor, scale: torch.Tensor, up: int, down: int,
            padding: Sequence[int], gain: float, slope: float,
            clamp: Optional[float]) -> torch.Tensor:
    """Check the operands and launch csrc/filtered_lrelu.cu on the current
    stream into a new output; raises on anything the kernel does not
    take."""
    ho, wo = check(x, fu, fd, up, down, padding)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, H, W, C = x.shape
    dev = x.device
    scale = _small(scale, "scale", (B, C), dev)
    b = _small(b, "b", (C,), dev)
    px0, _, py0, _ = (int(p) for p in padding)
    oy0, iy0, rby, tiles_y = tile_plan(ho, py0, up)
    ox0, ix0, rbx, tiles_x = tile_plan(wo, px0, up)
    out = torch.empty((B, ho, wo, C), dtype=x.dtype, device=dev)
    # the gain folded into fd (sqrt(gain) an axis) and the clamp, as the
    # plain version folds it; fu's gain up**2 is up an axis
    fu_c, fd_c = _taps(fu, float(up)), _taps(fd, math.sqrt(gain))
    lim = math.inf if clamp is None else float(clamp) / gain
    # the launch reads the current device: switch only when x lies elsewhere
    on_x = (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with on_x:
        err = _lib().filtered_lrelu_launch(
            x.data_ptr(), out.data_ptr(), scale.data_ptr(), b.data_ptr(),
            B, H, W, C, ho, wo, int(x.dtype == torch.float16), up,
            fu_c, len(fu_c), fd_c, len(fd_c),
            oy0, iy0, rby, tiles_y, ox0, ix0, rbx, tiles_x,
            float(slope), lim, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu_launch failed: cudaError {err}")
    trace.count(COUNTER)
    return out


def filtered_lrelu(x: torch.Tensor, fu: Sequence[float],
                   fd: Sequence[float], b: torch.Tensor,
                   scale: torch.Tensor, up: int, down: int,
                   padding: Sequence[int], gain: float = math.sqrt(2),
                   slope: float = 0.2,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """The kernel on a CUDA tensor x (B, H, W, C); raises on any other.
    Not differentiable (StyleGAN3 here is inference only)."""
    if x.device.type != "cuda":
        raise ValueError(f"the filtered_lrelu kernel takes CUDA tensors, got "
                         f"{x.device}; ops/filtered_lrelu.py dispatches")
    return _launch(x, fu, fd, b, scale, up, down, padding, gain, slope,
                   clamp)
