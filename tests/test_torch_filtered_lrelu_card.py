"""StyleGAN3's filtered LeakyReLU kernel (csrc/filtered_lrelu.cu through
ops/kernels/filtered_lrelu.py) on the card: every layer L0-L13 of the
1024^2 schedule at its own up, taps, padding, channels, dtype and input
size against the plain version (ops/filtered_lrelu.py::
filtered_lrelu_plain) run in float32 on the same inputs; L10 at a batch
of 16, whose output passes 2^31 bytes; the clamp, no clamp and other
paddings; the launches and spans of a 1024^2 generate; and the dtypes
the kernel does not take raise rather than fall back.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_filtered_lrelu_card.py

Skips without a CUDA device."""
import math

import pytest
import torch

from helpers.card import needs_card, no_tf32
from spgan_tpu_torch.config import Config, StyleGAN3Params
from spgan_tpu_torch.infer.image_engine import ImageEngine
from spgan_tpu_torch.models import stylegan3 as sg3
from spgan_tpu_torch.ops import filtered_lrelu as fl
from spgan_tpu_torch.ops.kernels import filtered_lrelu as kfl
from spgan_tpu_torch.utils import trace

LAYERS = [sg3.SynthesisLayer.build(s, 512, 256.0)
          for s in sg3.schedule(StyleGAN3Params())[1][:-1]]


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


def _ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of `dtype`'s values at |v| (float32 tensor), subnormal
    spacing below the smallest normal."""
    fi = torch.finfo(dtype)
    return torch.exp2(torch.floor(torch.log2(
        v.abs().clamp_min(fi.tiny)))) * fi.eps


def _assert_ulps(got: torch.Tensor, want: torch.Tensor):
    """got (the kernel, in its dtype) within one ULP of its dtype at each
    value of want (the plain version, float32) plus 16 float32 ULPs at
    want's largest value.  The kernel rounds once to its dtype (half an
    ULP; the other half covers want's own float32 rounding); both compute
    the four FIR passes (up to 24 terms a sum) in float32 in other
    orders, which the second term bounds."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = _ulp(want, got.dtype) + 16 * _ulp(want.abs().max(), torch.float32)
    worst = float((err / tol).max())
    assert bool(got.isfinite().all())
    assert worst <= 1.0, f"max error {worst:.3f} of the tolerance"


def _operands(layer, batch, seed, dtype=None):
    sp = layer.spec
    side = sp.in_size + sp.conv_kernel - 1
    gen = torch.Generator("cuda").manual_seed(seed)
    dtype = dtype or (torch.float16 if sp.use_fp16 else torch.float32)
    x = torch.randn((batch, side, side, sp.out_channels), generator=gen,
                    device="cuda").to(dtype)
    scale = torch.rand((batch, sp.out_channels), generator=gen,
                       device="cuda") + 0.5
    b = torch.randn((sp.out_channels,), generator=gen, device="cuda")
    return x, scale, b


def _args(layer, clamp="layer"):
    sp = layer.spec
    return dict(fu=layer.up_filter, fd=layer.down_filter, up=sp.up_factor,
                down=sp.down_factor, padding=sp.padding, gain=math.sqrt(2),
                slope=0.2, clamp=layer.conv_clamp if clamp == "layer"
                else clamp)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", LAYERS, ids=[l.spec.name for l in LAYERS])
def test_every_layer_is_the_plain_version(layer):
    """Batch 2 at the layer's full input size and dtype."""
    x, scale, b = _operands(layer, 2, 1)
    kw = _args(layer)
    before = trace.counters().get(kfl.COUNTER, 0)
    got = fl.filtered_lrelu(x, b=b, scale=scale, **kw)
    torch.cuda.synchronize()
    assert trace.counters().get(kfl.COUNTER, 0) == before + 1
    want = fl.filtered_lrelu_plain(x.float(), b=b, scale=scale, **kw)
    assert got.dtype == x.dtype and got.is_contiguous()
    assert got.shape == want.shape == (2, layer.spec.out_size,
                                       layer.spec.out_size, x.shape[3])
    _assert_ulps(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name, clamp, dtype, pad", [
    ("L2_52_512", 0.5, torch.float32, None),
    ("L11_1044_51", 0.5, torch.float16, None),
    ("L7_276_323", None, torch.float16, None),
    ("L4_84_512", None, torch.float16, (3, 1, 2, 5)),
    ("L8_276_203", 1.0, torch.float32, (-5, -3, 0, -1))])
def test_clamp_no_clamp_and_other_paddings(name, clamp, dtype, pad):
    """A clamp that bites on most values, none, the other dtype and
    paddings whose phases differ between the axes."""
    layer = next(l for l in LAYERS if l.spec.name == name)
    x, scale, b = _operands(layer, 2, 2, dtype)
    kw = _args(layer, clamp)
    if pad is not None:
        kw["padding"] = pad
    got = fl.filtered_lrelu(x, b=b, scale=scale, **kw)
    want = fl.filtered_lrelu_plain(x.float(), b=b, scale=scale, **kw)
    _assert_ulps(got, want)
    if clamp is not None:  # the clamp bit
        unclamped = fl.filtered_lrelu_plain(x.float(), b=b, scale=scale,
                                            **{**kw, "clamp": None})
        assert float((unclamped - want).abs().max()) > 0.1


@pytest.mark.gpu
def test_l10_at_a_batch_of_16():
    """L10 at batch 16 (2.8 GB of float16 output, offsets past 2^31
    bytes): samples 0 and 15 against the plain version."""
    layer = next(l for l in LAYERS if l.spec.name == "L10_1044_81")
    x, scale, b = _operands(layer, 16, 3)
    kw = _args(layer)
    got = fl.filtered_lrelu(x, b=b, scale=scale, **kw)
    assert got.numel() * got.element_size() > 2 ** 31
    for i in (0, 15):
        want = fl.filtered_lrelu_plain(x[i:i + 1].float(), b=b,
                                       scale=scale[i:i + 1], **kw)
        _assert_ulps(got[i:i + 1], want)


@pytest.mark.gpu
def test_a_generate_launches_it_fourteen_times():
    """A 1024^2 ImageEngine generate (batch 2): 14 launches, one a layer
    L0-L13, and 14 spgan.sg3.filtered_lrelu spans."""
    g = sg3.Generator.from_config(Config())
    params = g.init(torch.Generator().manual_seed(0), device="cuda")
    engine = ImageEngine(g=g, batch=2, device="cuda")
    trace.reset()
    trace.enable()
    try:
        engine.generate(params, torch.Generator("cuda").manual_seed(1))
        torch.cuda.synchronize()
    finally:
        trace.disable()
    assert trace.counters()[kfl.COUNTER] == 14
    names = [r["name"] for r in trace.records()]
    assert names.count("spgan.sg3.filtered_lrelu") == 14
    trace.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_an_untaken_dtype_raises(dtype):
    """A CUDA tensor the kernel does not take raises; nothing composed
    runs in its place and no launch is counted."""
    layer = LAYERS[0]
    x, scale, b = _operands(layer, 1, 4, dtype)
    before = trace.counters().get(kfl.COUNTER, 0)
    with pytest.raises(ValueError, match="float32 or float16"):
        fl.filtered_lrelu(x, b=b, scale=scale, **_args(layer))
    assert trace.counters().get(kfl.COUNTER, 0) == before
