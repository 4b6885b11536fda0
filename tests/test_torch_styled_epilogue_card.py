"""csrc/styled_epilogue.cu on the card: the kernel against its plain
PyTorch version at the TS's shapes, StyledConv.apply through it against
the composed ops on the CPU, and the operands it refuses.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_styled_epilogue_card.py

Skips without a CUDA device.  The kernel and the plain version both
compute in float32 with the same roundings and round once to y's dtype,
so they agree bit for bit in float32 and in bf16."""
import pytest
import torch

from helpers.card import Launches, assert_close, needs_card, no_tf32, only
from spgan_tpu_torch.ops.kernels import styled_epilogue as ep
from spgan_tpu_torch.ops.modulated import ModulatedConv2d, StyledConv


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


def _randn(*shape, seed, dtype=torch.float32):
    return torch.randn(*shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed)) \
        .to(dtype)


def _operands(B, H, C, dtype, seed):
    """y, demod (float32, around the shipped 0.05-1), bias, a noise map and
    its weight."""
    y = _randn(B, H, H, C, seed=seed, dtype=dtype) * 4
    demod = _randn(B, C, seed=seed + 1).abs() + 0.05
    bias = _randn(C, seed=seed + 2)
    noise = _randn(B, H, H, 1, seed=seed + 3, dtype=dtype)
    nw = torch.tensor(0.37, device="cuda")
    return y, demod, bias, noise, nw


# (B, H, C): the TS's first upsample conv (19^2 after its blur) and plain
# conv (17^2) at the render cells' 64 patches a chunk, the 101 plan's
# last conv, and the 197 plan's convs 9-10 (256 channels) at a batch of 4
SHAPES = [(64, 19, 512), (64, 17, 512), (8, 101, 512), (4, 199, 256),
          (4, 197, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_noise", [True, False], ids=["noise", "none"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,C", SHAPES)
def test_kernel_matches_plain(B, H, C, dtype, with_noise):
    y, demod, bias, noise, nw = _operands(B, H, C, dtype, seed=H + C)
    if not with_noise:
        noise = nw = None
    want = ep.styled_epilogue_plain(y, demod, bias, noise, nw)
    y_in = y.clone()
    with Launches() as n:
        got = ep.styled_epilogue(y, demod, bias, noise, nw)
    assert n.got == only(styled_epilogue=1)
    assert got.data_ptr() == y.data_ptr()  # written over y
    assert got.dtype == dtype and got.shape == y_in.shape
    assert torch.equal(got, want)
    assert not torch.equal(got, y_in)


@pytest.mark.gpu
def test_kernel_odd_widths_and_tiles():
    """Channel vectors that leave a block's threads unused (C = 24 bf16:
    3 vectors), one pixel, a 1x1 batch and B*H*W not a multiple of any
    tile."""
    for B, H, W, C, dtype in [(3, 5, 7, 24, torch.bfloat16),
                              (1, 1, 1, 8, torch.bfloat16),
                              (5, 13, 11, 12, torch.float32),
                              (2, 3, 3, 4096, torch.float32)]:
        y = _randn(B, H, W, C, seed=C, dtype=dtype)
        demod = _randn(B, C, seed=1).abs()
        bias = _randn(C, seed=2)
        noise = _randn(B, H, W, 1, seed=3, dtype=dtype)
        nw = torch.tensor([-1.5], device="cuda")
        want = ep.styled_epilogue_plain(y, demod, bias, noise, nw)
        assert torch.equal(ep.styled_epilogue(y, demod, bias, noise, nw),
                           want), (B, H, W, C, dtype)


def _spec(upsample, no_zero_pad, out_ch=16):
    return StyledConv(conv=ModulatedConv2d(
        in_ch=12, out_ch=out_ch, kernel_size=3, style_dim=8,
        upsample=upsample, no_zero_pad=no_zero_pad))


def _conv_operands(spec, size=9):
    gen = torch.Generator().manual_seed(5)
    params = spec.init(gen)
    params["act_bias"] = torch.randn(params["act_bias"].shape, generator=gen)
    params["noise"]["weight"] = torch.tensor(0.3)
    x = torch.randn((2, size, size, 12), generator=gen)
    style = torch.randn((2, 8), generator=gen)
    with torch.no_grad():
        h = spec.conv.apply(params["conv"], x, style).shape[1]
    noise = torch.randn((2, h, h, 1), generator=gen)
    return params, x, style, noise


def _to(tree, dev, dtype=None):
    if torch.is_tensor(tree):
        return tree.to(dev) if dtype is None else tree.to(dev, dtype)
    return {k: _to(v, dev, dtype) for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("no_zero_pad", [True, False],
                         ids=["no_zero_pad", "zero_pad"])
@pytest.mark.parametrize("upsample", [True, False], ids=["up", "plain"])
def test_styled_conv_on_card_matches_cpu(upsample, no_zero_pad):
    """StyledConv.apply under inference_mode: one epilogue launch on cuda
    (after the upsample's blur), the composed ops on cpu; float32 within the convolutions' own
    difference, and bf16 activations within 2% of the largest value."""
    spec = _spec(upsample, no_zero_pad)
    params, x, style, noise = _conv_operands(spec)
    with torch.inference_mode():
        want = spec.apply(params, x, style, noise=noise)
        for dtype in (torch.float32, torch.bfloat16):
            xc, sc, nc = (t.to("cuda", dtype) for t in (x, style, noise))
            assert spec.uses_epilogue(xc, sc)
            with Launches() as n:
                got = spec.apply(_to(params, "cuda"), xc, sc, noise=nc)
            assert n.got == only(styled_epilogue=1, upfirdn=int(upsample))
            assert got.dtype == dtype
            if dtype == torch.float32:
                assert_close(got, want, atol=1e-4, rtol=1e-4)
            else:
                assert_close(got, want, atol=0.02 * float(want.abs().max()))


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take():
    """ValueError, and no launch, on each operand the kernel refuses."""
    y, demod, bias, noise, nw = _operands(2, 5, 16, torch.bfloat16, seed=1)
    bad = {
        "float16": dict(y=y.half(), noise=noise.half()),
        "C not a whole vector": dict(y=y[..., :12].contiguous(),
                                     demod=demod[:, :12].contiguous(),
                                     bias=bias[:12].contiguous()),
        "not contiguous": dict(y=y.permute(0, 2, 1, 3)),
        "unaligned": dict(y=torch.empty(2 * 5 * 5 * 16 + 1, dtype=y.dtype,
                                        device="cuda")[1:].view(2, 5, 5, 16)),
        "noise dtype": dict(noise=noise.float()),
        "noise shape": dict(noise=noise[:, :4]),
        "demod shape": dict(demod=demod[:1]),
        "noise without weight": dict(nw=None),
        "3-d y": dict(y=y[0]),
        "bias size": dict(bias=bias[:8]),
    }
    for what, change in bad.items():
        args = dict(y=y.clone(), demod=demod, bias=bias, noise=noise, nw=nw)
        args.update(change)
        with Launches() as n, pytest.raises(ValueError):
            ep.styled_epilogue(args["y"], args["demod"], args["bias"],
                               args["noise"], args["nw"])
        assert n.got == only(), what


@pytest.mark.gpu
def test_composed_path_where_the_epilogue_does_not_serve():
    """A bf16 width of 12 channels (not a whole 16-byte vector) and a call
    under autograd compose the ops on the card: no launch."""
    spec = _spec(False, True, out_ch=12)
    params, x, style, noise = _conv_operands(spec)
    bf = torch.bfloat16
    with torch.inference_mode():
        want = spec.apply(params, x, style, noise=noise)
        xc, sc, nc = (t.to("cuda", bf) for t in (x, style, noise))
        assert not spec.uses_epilogue(xc, sc)
        with Launches() as n:
            got = spec.apply(_to(params, "cuda"), xc, sc, noise=nc)
    assert n.got == only()
    assert_close(got, want, atol=0.02 * float(want.abs().max()))
    spec = _spec(True, True)
    params, x, style, noise = _conv_operands(spec)
    xc = x.cuda().requires_grad_(True)
    with Launches() as n:
        out = spec.apply(_to(params, "cuda"), xc, style.cuda(),
                         noise=noise.cuda())
        out.sum().backward()
    assert n.got["styled_epilogue"] == 0
    assert xc.grad is not None
