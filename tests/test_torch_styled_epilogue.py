"""The styled conv's epilogue (ops/kernels/styled_epilogue.py) on the CPU:
StyledConv through ModulatedConv2d.apply_undemodulated and the plain
epilogue (the demodulation after an upsample's blur, the no_zero_pad crop
folded into the blur's pads) against the composed ops StyledConv.apply
runs on the CPU, in float32; which calls take the epilogue; and that no
CPU or grad-enabled call counts a kernel launch.

Small shapes and torch at 2 threads: the file runs in a few seconds."""
import types

import pytest
import torch

from spgan_tpu_torch.ops import upfirdn as tu
from spgan_tpu_torch.ops.kernels import styled_epilogue as ep
from spgan_tpu_torch.ops.modulated import ModulatedConv2d, StyledConv
from spgan_tpu_torch.utils import trace

torch.set_num_threads(2)

COUNTER = "spgan.styled_epilogue.launches"


def _spec(upsample, no_zero_pad, out_ch=16, activation="fused_lrelu",
          disable_noise=False):
    return StyledConv(
        conv=ModulatedConv2d(in_ch=12, out_ch=out_ch, kernel_size=3,
                             style_dim=8, upsample=upsample,
                             no_zero_pad=no_zero_pad),
        disable_noise=disable_noise, activation=activation)


def _operands(spec, seed=0, batch=2, size=9):
    """Parameters with a non-zero bias and noise weight, an input, a
    style and one noise map of the conv's output size."""
    gen = torch.Generator().manual_seed(seed)
    params = spec.init(gen)
    params["act_bias"] = torch.randn(params["act_bias"].shape, generator=gen)
    if "noise" in params:
        params["noise"]["weight"] = torch.tensor(0.3)
    x = torch.randn((batch, size, size, spec.conv.in_ch), generator=gen)
    style = torch.randn((batch, spec.conv.style_dim), generator=gen)
    with torch.no_grad():
        h = spec.conv.apply(params["conv"], x, style).shape[1]
    noise = torch.randn((batch, h, h, 1), generator=gen)
    return params, x, style, noise


def _launches():
    return trace.counters().get(COUNTER, 0)


@pytest.mark.parametrize("with_noise", [True, False], ids=["noise", "none"])
@pytest.mark.parametrize("no_zero_pad", [True, False],
                         ids=["no_zero_pad", "zero_pad"])
@pytest.mark.parametrize("upsample", [True, False], ids=["up", "plain"])
def test_epilogue_path_matches_composed_apply(upsample, no_zero_pad,
                                              with_noise):
    """apply_epilogue on the CPU (the plain epilogue) against the composed
    StyledConv.apply: the same bits on a plain conv, within 1e-5 on an
    upsample (demodulation after the blur: another order of roundings)."""
    spec = _spec(upsample, no_zero_pad)
    params, x, style, noise = _operands(spec)
    noise = noise if with_noise else None
    with torch.inference_mode():
        assert not spec.uses_epilogue(x, style)  # a CPU tensor composes
        before = _launches()
        want = spec.apply(params, x, style, noise=noise)
        got = spec.apply_epilogue(params, x, style, noise=noise)
    assert _launches() == before
    assert got.shape == want.shape and got.dtype == want.dtype
    if upsample:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        assert torch.equal(got, want)
    if with_noise:  # the noise map reached the result
        with torch.inference_mode():
            quiet = spec.apply(params, x, style, noise=None)
        assert not torch.allclose(quiet, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_epilogue_rounds_once(dtype):
    """The plain epilogue is the five steps in float32, rounded once to
    y's dtype; in float32 the composed ops' bits."""
    gen = torch.Generator().manual_seed(1)
    y = torch.randn((3, 5, 7, 16), generator=gen).to(dtype)
    demod = torch.rand((3, 16), generator=gen) + 0.5
    bias = torch.randn((16,), generator=gen)
    noise = torch.randn((3, 5, 7, 1), generator=gen).to(dtype)
    nw = torch.tensor(-0.7)
    got = ep.styled_epilogue_plain(y, demod, bias, noise, nw)
    t = (y.float() * demod[:, None, None, :] + nw * noise.float()
         + bias)
    want = (torch.nn.functional.leaky_relu(t, 0.2) * 2.0 ** 0.5).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    # the CPU dispatch is the plain version, and counts no launch
    before = _launches()
    assert torch.equal(ep.styled_epilogue(y, demod, bias, noise, nw), got)
    assert _launches() == before


def test_blur_pads_fold_the_crop():
    """Blur with pads (-1, -1) on the whole upsample output equals the
    blur with pads (0, 0) of its one-pixel crop."""
    gen = torch.Generator().manual_seed(2)
    y = torch.randn((2, 13, 13, 8), generator=gen)
    spec = ModulatedConv2d(in_ch=8, out_ch=8, kernel_size=3, style_dim=4,
                           upsample=True, no_zero_pad=True)
    assert spec._blur(crop=1) == tu.Blur((1.0, 2.0, 1.0), pad=(-1, -1),
                                         upsample_factor=2)
    torch.testing.assert_close(spec._blur(crop=1)(y),
                               spec._blur()(y[:, 1:-1, 1:-1, :]),
                               atol=0, rtol=0)


def test_uses_epilogue_only_where_the_kernel_serves():
    """The fused path needs a CUDA tensor outside autograd, fused_lrelu, a
    per-sample style and a width the kernel's 16-byte vectors divide."""
    on_card = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    f32_card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    style = torch.zeros((2, 8))
    spec = _spec(True, True)
    with torch.no_grad():
        assert spec.uses_epilogue(on_card, style)
        assert spec.uses_epilogue(f32_card, style)
        assert not spec.uses_epilogue(torch.zeros((2, 9, 9, 12)), style)
        assert not spec.uses_epilogue(on_card, torch.zeros((2, 5, 5, 8)))
        assert not _spec(False, True, activation="lrelu_plain") \
            .uses_epilogue(on_card, style)
        # 12 channels: three float32 vectors, not a whole bf16 vector
        assert _spec(False, True, out_ch=12).uses_epilogue(f32_card, style)
        assert not _spec(False, True, out_ch=12).uses_epilogue(on_card,
                                                               style)
        half = types.SimpleNamespace(is_cuda=True, dtype=torch.float16)
        assert not spec.uses_epilogue(half, style)
    with torch.inference_mode():
        assert spec.uses_epilogue(on_card, style)
    with torch.enable_grad():
        assert not spec.uses_epilogue(on_card, style)


def test_takes():
    assert ep.takes(torch.bfloat16, 256) and ep.takes(torch.float32, 4)
    assert not ep.takes(torch.bfloat16, 12)
    assert not ep.takes(torch.float32, 3)
    assert not ep.takes(torch.float16, 256)
    assert not ep.takes(torch.float32, 4 * 1025)


def test_grad_enabled_calls_compose_and_count_nothing():
    """Under autograd StyledConv composes its ops (gradients reach x and
    the bias) and no launch is counted; a disabled noise is ignored."""
    spec = _spec(True, True, disable_noise=True)
    params, x, style, noise = _operands(spec, seed=3)
    x.requires_grad_(True)
    params["act_bias"].requires_grad_(True)
    before = _launches()
    out = spec.apply(params, x, style, noise=noise)
    out.square().sum().backward()
    assert _launches() == before
    assert x.grad is not None and params["act_bias"].grad is not None
    with torch.no_grad():
        fused = spec.apply_epilogue(params, x, style, noise=noise)
    torch.testing.assert_close(fused, out.detach(), atol=1e-5, rtol=0)


def test_wrapper_refuses_other_devices():
    y = torch.zeros((1, 2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ep.styled_epilogue(y, torch.zeros((1, 8), device="meta"),
                           torch.zeros((8,), device="meta"))
