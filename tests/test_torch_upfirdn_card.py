"""csrc/upfirdn2d.cu against its plain PyTorch version on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_upfirdn_card.py -m gpu

Skips without a CUDA device.  The plain version is a depthwise cuDNN
convolution, run with TF32 off.  float32 agrees within 1e-5 (sums of at
most 16 products in another order); bf16 within one unit in the last
place (both sum in float32 and round once, so only a sum that straddles a
rounding boundary can differ)."""
import numpy as np
import pytest
import torch

from helpers.card import Launches, needs_card, no_tf32
from spgan_tpu_torch.ops import upfirdn as tu
from spgan_tpu_torch.ops.kernels import upfirdn as ku

K121, K1331 = (1.0, 2.0, 1.0), (1.0, 3.0, 3.0, 1.0)


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


def _randn(*shape, seed):
    return torch.randn(*shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed))


def _taps(kernel, gain=1.0):
    k = tu.make_kernel(np.asarray(kernel, np.float32)) * gain
    return tuple(k.astype(np.float32).ravel().tolist()), k.shape[0]


def _within_one_ulp(got, ref):
    """bf16 results within one unit in the last place of the larger."""
    got, ref = got.float(), ref.float()
    _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e.int() - 8)
    return bool(((got - ref).abs() <= ulp).all())


# (B, H, W, C, stencil, gain, up, down, pads (py0, py1, px0, px1)): the
# cells' calls at their own batches (the render cells' TS blur, 64 x
# 105^2 x 512; the training step's TS blur at 16 x 105^2 x 512 and its
# adjoint at 103^2; D's first blur and first skip blur at 16 x 101^2 x
# 256), the same at a batch of 2 or 3 (and the TS blur at 21^2), the ToRGB
# skip's Upsample (C = 3) and its adjoint, the zero-pad Upsample,
# Downsample at odd widths, crops (negative pads) and odd C (5, 36: no
# 16-byte vector in bf16 at 36).
CASES = [
    (64, 105, 105, 512, K121, 4.0, 1, 1, (0, 0, 0, 0)),
    (16, 105, 105, 512, K121, 4.0, 1, 1, (0, 0, 0, 0)),
    (16, 103, 103, 512, K121, 4.0, 1, 1, (2, 2, 2, 2)),
    (16, 101, 101, 256, K1331, 1.0, 1, 1, (2, 2, 2, 2)),
    (16, 101, 101, 256, K1331, 1.0, 1, 1, (1, 1, 1, 1)),
    (2, 105, 105, 512, K121, 4.0, 1, 1, (0, 0, 0, 0)),
    (3, 21, 21, 512, K121, 4.0, 1, 1, (0, 0, 0, 0)),
    (3, 19, 19, 512, K121, 4.0, 1, 1, (2, 2, 2, 2)),
    (2, 101, 101, 256, K1331, 1.0, 1, 1, (2, 2, 2, 2)),
    (2, 101, 101, 256, K1331, 1.0, 1, 1, (1, 1, 1, 1)),
    (2, 17, 17, 3, K121, 4.0, 2, 1, (1, 0, 1, 0)),
    (2, 33, 33, 3, K121, 4.0, 1, 2, (1, 1, 1, 1)),
    (2, 13, 11, 36, K1331, 4.0, 2, 1, (2, 1, 2, 1)),
    (2, 12, 13, 5, K1331, 1.0, 1, 2, (1, 1, 1, 1)),
    (1, 9, 14, 40, K121, 1.0, 2, 2, (1, -1, 2, 0)),
    (2, 10, 7, 8, K1331, 1.0, 1, 1, (-1, 2, 3, -2)),
]


def _ids(c):
    return "B{}H{}W{}C{}k{}up{}down{}pad{}".format(
        *c[:4], len(c[4]), c[6], c[7], "_".join(map(str, c[8])))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype, case):
    B, H, W, C, kernel, gain, up, down, pad = case
    taps, kh = _taps(kernel, gain)
    x = _randn(B, H, W, C, seed=B * H * W + C).to(dtype)
    ref = ku.upfirdn2d_plain(x.float(), taps, kh, up, down, pad)
    with Launches() as n:
        got = ku.upfirdn2d(x, taps, kh, up, down, pad)
    assert n.got["upfirdn"] == 1
    assert got.dtype == dtype and got.shape == ref.shape
    assert got.is_contiguous()
    if dtype == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-5
    else:
        assert _within_one_ulp(got, ref.to(dtype))


@pytest.mark.gpu
def test_unaligned_and_strided_inputs_on_card():
    """An input 4 bytes off a 16-byte boundary takes the one-element path;
    a strided view is made contiguous; both equal the plain version."""
    taps, kh = _taps(K1331)
    flat = torch.randn(1 + 2 * 9 * 10 * 32, device="cuda")
    x = flat[1:].view(2, 9, 10, 32)
    assert x.data_ptr() % 16 == 4
    strided = torch.randn(2, 10, 9, 32, device="cuda").transpose(1, 2)
    for inp in (x, strided):
        ref = ku.upfirdn2d_plain(inp, taps, kh, 1, 1, (2, 1, 2, 1))
        got = ku.upfirdn2d(inp, taps, kh, 1, 1, (2, 1, 2, 1))
        assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,gain,up,down,pad,shape", [
    (K1331, 1.0, 1, 1, (2, 2, 2, 2), (2, 25, 25, 64)),  # D's blur
    (K1331, 1.0, 1, 1, (2, 2, 2, 2), (16, 101, 101, 256)),  # at its batch
    (K121, 4.0, 1, 1, (0, 0, 0, 0), (2, 21, 21, 64)),   # the TS blur
    (K121, 4.0, 2, 1, (1, 0, 1, 0), (2, 17, 17, 3)),    # the ToRGB skip
    (K1331, 1.0, 1, 2, (1, 1, 1, 1), (2, 18, 18, 8)),   # Downsample
], ids=["d_blur", "d_blur_16x101x256", "ts_blur", "skip_upsample",
         "downsample"])
def test_first_and_second_derivatives_on_card(kernel, gain, up, down, pad,
                                              shape):
    """An R1-style double backward through the op on the kernel equals the
    same through the plain version's autograd (cuDNN, TF32 off); the
    kernel launches once for the forward, once for the gradient and twice
    in the second backward."""
    taps, kh = _taps(kernel, gain)
    x0 = _randn(*shape, seed=kh + up + down)
    w0 = _randn(shape[-1], seed=kh + up + down + 1)

    def second(fn):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        y = torch.tanh(fn(x * w, taps, kh, up, down, pad))
        g, = torch.autograd.grad((y * y).sum(), x, create_graph=True)
        (g * g).sum().backward()
        return g.detach(), w.grad

    with Launches() as n:
        got = second(ku.upfirdn2d)
    assert n.got["upfirdn"] == 4
    want = second(ku.upfirdn2d_plain)
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1.0)


@pytest.mark.gpu
def test_counter_counts_each_launch_on_card():
    """spgan.upfirdn.launches: one a forward call of Blur, Upsample and
    Downsample; none for a CPU tensor or a refused call."""
    x = torch.randn(2, 12, 12, 16, device="cuda")
    with Launches() as n:
        for op in (tu.Blur(K1331, pad=(2, 2)),
                   tu.Upsample(K121, no_zero_pad=True),
                   tu.Upsample(K1331), tu.Downsample(K1331)):
            op(x)
    assert n.got["upfirdn"] == 4
    with Launches() as n:
        tu.Blur(K1331, pad=(2, 2))(x.cpu())
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tu.Blur(K1331, pad=(2, 2))(x.half())
        with pytest.raises(ValueError, match="at most 4x4"):
            tu.blur(x, tu.gaussian_kernel(5), (2, 2))
    assert n.got["upfirdn"] == 0
