"""StyleGAN3's filtered LeakyReLU kernel wrapper on the CPU
(ops/kernels/filtered_lrelu.py): the module imports without a card, a CPU
tensor takes the plain version bit for bit and counts no launch, the
checks refuse what the kernel does not take and take every layer of the
1024^2 schedule, and the kernel's tile plan, emulated in numpy pass for
pass (csrc/filtered_lrelu.cu's passes A, B and C as matrices), gives the
plain version's values.  The kernel itself runs in
tests/test_torch_filtered_lrelu_card.py.

Small shapes and torch at 2 threads: the file runs in a few seconds."""
import math

import numpy as np
import pytest
import torch

from spgan_tpu_torch.config import StyleGAN3Params
from spgan_tpu_torch.models import stylegan3 as sg3
from spgan_tpu_torch.ops import filtered_lrelu as fl
from spgan_tpu_torch.ops.kernels import filtered_lrelu as kfl
from spgan_tpu_torch.utils import trace

torch.set_num_threads(2)

# the layers' paddings, an uneven one and one whose W phase differs
PADS = [(2, (9, 8, 9, 8)), (4, (-6, -9, -6, -9)), (2, (-11, -12, -11, -12)),
        (4, (3, 1, 2, 5)), (4, (-5, -3, -6, -9))]


def _operands(up, size, seed, batch=2, channels=5):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, size, size + 3, channels), generator=gen) * 4
    b = torch.randn((channels,), generator=gen)
    scale = torch.rand((batch, channels), generator=gen) + 0.5
    fu = fl.design_lowpass_filter(6 * up, 3.0, 4.0, 8.0 * up)
    fd = fl.design_lowpass_filter(12, 4.0, 3.0, 16.0)
    return x, fu, fd, b, scale


def test_a_cpu_tensor_takes_the_plain_version():
    """The dispatcher on a CPU tensor: filtered_lrelu_plain's bits, no
    launch counted; the kernel's own entry refuses a CPU tensor."""
    x, fu, fd, b, scale = _operands(4, 12, 0)
    kw = dict(up=4, down=2, padding=(-6, -9, -6, -9), clamp=4.0)
    before = trace.counters().get(kfl.COUNTER, 0)
    got = fl.filtered_lrelu(x, fu, fd, b, scale, **kw)
    assert torch.equal(got, fl.filtered_lrelu_plain(x, fu, fd, b, scale,
                                                    **kw))
    assert trace.counters().get(kfl.COUNTER, 0) == before
    with pytest.raises(ValueError, match="CUDA"):
        kfl.filtered_lrelu(x, fu, fd, b, scale, **kw)


@pytest.mark.parametrize("what, change", [
    ("bfloat16", dict(dtype=torch.bfloat16)),
    ("float64", dict(dtype=torch.float64)),
    ("up 3", dict(up=3)), ("up 1", dict(up=1)), ("down 1", dict(down=1)),
    ("25 up taps", dict(fu=(0.04,) * 25)), ("13 down taps",
                                            dict(fd=(0.1,) * 13)),
    ("3-d x", dict(shape=(8, 8, 4))), ("two pads", dict(padding=(1, 1))),
    ("empty output", dict(shape=(1, 2, 2, 4), padding=(-9, -9, -9, -9)))])
def test_check_refuses_what_the_kernel_does_not_take(what, change):
    """check raises ValueError before any launch (meta tensors: no data)."""
    args = dict(shape=(2, 20, 20, 4), dtype=torch.float16, fu=(0.1,) * 24,
                fd=(0.1,) * 12, up=4, down=2, padding=(-6, -9, -6, -9))
    args.update(change)
    x = torch.empty(args["shape"], dtype=args["dtype"], device="meta")
    with pytest.raises(ValueError):
        kfl.check(x, args["fu"], args["fd"], args["up"], args["down"],
                  args["padding"])


def test_check_takes_every_layer_at_1024():
    """L0-L13 of the 1024^2 schedule at batch 16, in the dtype each runs
    in on the card: taken, with the schedule's output size."""
    _, specs = sg3.schedule(StyleGAN3Params())
    for s in specs[:-1]:
        side = s.in_size + s.conv_kernel - 1
        dtype = torch.float16 if s.use_fp16 else torch.float32
        x = torch.empty((16, side, side, s.out_channels), dtype=dtype,
                        device="meta")
        fu, fd = (0.0,) * s.up_taps, (0.0,) * s.down_taps
        assert kfl.check(x, fu, fd, s.up_factor, s.down_factor,
                         s.padding) == (s.out_size, s.out_size), s.name


@pytest.mark.parametrize("up", [2, 4])
def test_tile_plan_keeps_phase_and_covers(up):
    """Every tile's up-domain start is up * (its first input sample) + rb
    with rb 0 or 1, and the tiles cover the output from o0 in {0, -1}."""
    step = kfl.DOWN * kfl.TILE // up
    for pad0 in range(-13, 14):
        for n_out in (1, 25, 26, 27, 52, 53, 1044):
            o0, i0, rb, tiles = kfl.tile_plan(n_out, pad0, up)
            assert o0 in (0, -1) and rb in (0, 1)
            assert o0 + tiles * kfl.TILE >= n_out
            assert o0 + (tiles - 1) * kfl.TILE < n_out
            for t in range(tiles):
                start = kfl.DOWN * (o0 + kfl.TILE * t) - pad0
                assert start == up * (i0 + step * t) + rb


def _phase_matrix(ffu, up, rb, n_up, n_in):
    """Pass A/B's polyphase up FIR as an (n_up, n_in) matrix: up-domain
    sample j of the tile takes input k with tap up * k - rb - j."""
    m = np.zeros((n_up, n_in))
    for j in range(n_up):
        for k in range(n_in):
            t = up * k - rb - j
            if 0 <= t < len(ffu):
                m[j, k] = ffu[t]
    return m


def _tiled(x, fu, fd, b, scale, up, padding, gain, slope, clamp):
    """The kernel's algorithm in float64 numpy: the tile plan, the input
    tile with halo (zero outside x), pass A along W, pass B along H with
    the LeakyReLU and clamp and the down FIR, pass C along W."""
    ho, wo = kfl.check(x, fu, fd, up, 2, padding)
    B, H, W, C = x.shape
    ku = kfl.TAPS_A_PHASE * up
    n_up = kfl.DOWN * (kfl.TILE - 1) + kfl.DOWN_TAPS
    n_in = (n_up + ku - 1) // up + 1
    ffu = np.zeros(ku)
    ffu[:len(fu)] = np.asarray(fu, np.float64)[::-1] * up
    ffd = np.zeros(kfl.DOWN_TAPS)
    ffd[:len(fd)] = np.asarray(fd, np.float64)[::-1] * math.sqrt(gain)
    down = np.zeros((kfl.TILE, n_up))
    for o in range(kfl.TILE):
        down[o, 2 * o:2 * o + kfl.DOWN_TAPS] = ffd
    lim = math.inf if clamp is None else clamp / gain
    v = (x.double() * scale.double()[:, None, None, :]
         + b.double()).numpy()
    px0, _, py0, _ = padding
    oy0, iy0, rby, tiles_y = kfl.tile_plan(ho, py0, up)
    ox0, ix0, rbx, tiles_x = kfl.tile_plan(wo, px0, up)
    up_y = _phase_matrix(ffu, up, rby, n_up, n_in)
    up_x = _phase_matrix(ffu, up, rbx, n_up, n_in)
    step = kfl.DOWN * kfl.TILE // up
    out = np.full((B, ho, wo, C), np.nan)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            iy, ix = iy0 + ty * step, ix0 + tx * step
            tile = np.zeros((B, n_in, n_in, C))
            ys = [k for k in range(n_in) if 0 <= iy + k < H]
            xs = [k for k in range(n_in) if 0 <= ix + k < W]
            tile[:, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = \
                v[:, iy + ys[0]:iy + ys[-1] + 1, ix + xs[0]:ix + xs[-1] + 1]
            s1 = np.einsum("jk,bikc->bijc", up_x, tile)          # pass A
            u = np.einsum("jk,bkwc->bjwc", up_y, s1)             # pass B
            u = np.clip(np.where(u > 0, u, u * slope), -lim, lim)
            s2 = np.einsum("oj,bjwc->bowc", down, u)
            res = np.einsum("qj,bojc->boqc", down, s2)           # pass C
            oy, ox = oy0 + ty * kfl.TILE, ox0 + tx * kfl.TILE
            ra = [o for o in range(kfl.TILE) if 0 <= oy + o < ho]
            ca = [q for q in range(kfl.TILE) if 0 <= ox + q < wo]
            out[:, oy + ra[0]:oy + ra[-1] + 1, ox + ca[0]:ox + ca[-1] + 1] = \
                res[:, ra[0]:ra[-1] + 1, ca[0]:ca[-1] + 1]
    return out


@pytest.mark.parametrize("up, pad", PADS)
def test_tile_plan_emulated_is_the_plain_version(up, pad):
    """The kernel's tiling, emulated in float64, against the plain version
    in float32 on outputs of two to three tiles a side with ragged edges:
    every output sample written once (no NaN left), within 2e-5 of values
    ~8 (float32 rounding of the plain version's four FIR passes)."""
    x, fu, fd, b, scale = _operands(up, 50 if up == 2 else 30, up + pad[0])
    want = fl.filtered_lrelu_plain(x, fu, fd, b, scale, up=up, down=2,
                                   padding=pad, clamp=4.0)
    got = _tiled(x, fu, fd, b, scale, up, pad, math.sqrt(2), 0.2, 4.0)
    assert got.shape == tuple(want.shape)
    assert want.shape[1] > kfl.TILE and want.shape[2] > kfl.TILE
    assert not np.isnan(got).any()
    assert np.abs(got - want.double().numpy()).max() < 2e-5
