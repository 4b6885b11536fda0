"""The upfirdn2d Function (ops/kernels/upfirdn.py) on the CPU: its plain
path against the depthwise convolution it wraps and the JAX package at
every (stencil, up, down, pad) the port calls, its adjoint by gradcheck
and gradgradcheck in float64, and no per-channel convolution in the
double backward of Blur, Upsample and Downsample.

Small shapes and torch at 2 threads: the file runs in a few seconds."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.profiler import ProfilerActivity, profile

from spgan_tpu.ops import upfirdn as ju
from spgan_tpu_torch.ops import upfirdn as tu
from spgan_tpu_torch.ops.kernels import upfirdn as ku

torch.set_num_threads(2)

K121, K1331 = (1.0, 2.0, 1.0), (1.0, 3.0, 3.0, 1.0)

# Every call the port makes, by the class that makes it:
#   the TS blur after each transposed conv (no_zero_pad), the baseline
#   family's zero-pad TS blur, the ToRGB skip's Upsample with and without
#   no_zero_pad, D's downsampling blur and its 1x1 skip's, Downsample.
CALLS = {
    "ts_blur": tu.Blur(K121, pad=(0, 0), upsample_factor=2),
    "ts_blur_zero_pad": tu.Blur(K1331, pad=(1, 1), upsample_factor=2),
    "skip_upsample_no_zero_pad": tu.Upsample(K121, no_zero_pad=True),
    "skip_upsample": tu.Upsample(K1331),
    "d_blur": tu.Blur(K1331, pad=(2, 2)),
    "d_skip_blur": tu.Blur(K1331, pad=(1, 1)),
    "downsample": tu.Downsample(K1331),
}
JAX_CALLS = {
    "ts_blur": ju.Blur(K121, pad=(0, 0), upsample_factor=2),
    "ts_blur_zero_pad": ju.Blur(K1331, pad=(1, 1), upsample_factor=2),
    "skip_upsample_no_zero_pad": ju.Upsample(K121, no_zero_pad=True),
    "skip_upsample": ju.Upsample(K1331),
    "d_blur": ju.Blur(K1331, pad=(2, 2)),
    "d_skip_blur": ju.Blur(K1331, pad=(1, 1)),
    "downsample": ju.Downsample(K1331),
}


def _old_path(name, x):
    """The depthwise convolution each call ran before the Function: zero
    insertion, padding, a grouped F.conv2d (and the no_zero_pad crop)."""
    op = CALLS[name]
    if isinstance(op, tu.Blur):
        p = op.pad
        return ku._depthwise(x, op.k2d(), padding=(p, p))
    if isinstance(op, tu.Downsample):
        k = tu.make_kernel(K1331)
        return ku._depthwise(x, k, padding=((1, 1), (1, 1)), stride=2)
    k = tu.make_kernel(np.asarray(op.kernel, np.float32)) * 4
    kh = k.shape[0]
    if op.no_zero_pad:
        y = ku._depthwise(x, k, lhs_dilation=2,
                          padding=((kh - 1, kh - 1), (kh - 1, kh - 1)))
        return y[:, 1:-1, 1:-1, :]
    return ku._depthwise(x, k, lhs_dilation=2, padding=((2, 2), (2, 2)))


@pytest.mark.parametrize("name", list(CALLS))
def test_function_matches_depthwise_and_jax(name):
    """The Function's plain path equals the old depthwise path and the JAX
    package's op, at odd sizes (H != W) and C = 3 and 5."""
    rng = np.random.RandomState(len(name))
    for shape in ((2, 9, 11, 5), (1, 7, 6, 3)):
        x = rng.randn(*shape).astype(np.float32)
        got = CALLS[name](torch.tensor(x))
        old = _old_path(name, torch.tensor(x))
        want = np.asarray(jax.jit(JAX_CALLS[name])(jnp.asarray(x)))
        assert tuple(got.shape) == tuple(old.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), old.numpy(), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# (stencil side rows, cols, up, down, pads (py0, py1, px0, px1)): the
# port's calls and their adjoints, crops (negative pads) on either side,
# non-square stencils and every (up, down).
ADJOINT_CASES = [
    (3, 3, 1, 1, (0, 0, 0, 0)),
    (3, 3, 1, 1, (2, 2, 2, 2)),
    (4, 4, 1, 1, (2, 2, 1, 1)),
    (3, 3, 2, 1, (1, 0, 1, 0)),
    (4, 4, 2, 1, (2, 1, 2, 1)),
    (4, 4, 1, 2, (1, 1, 1, 1)),
    (3, 3, 2, 2, (1, -1, 2, 0)),
    (2, 3, 1, 1, (-1, 1, 0, 2)),
]


@pytest.mark.parametrize("kh,kw,up,down,pad", ADJOINT_CASES)
def test_gradcheck_and_gradgradcheck(kh, kw, up, down, pad):
    """First and second derivatives in float64: the backward (the Function
    with the adjoint parameters) and its own backward."""
    rng = np.random.RandomState(kh * 7 + kw + up + down)
    taps = tuple(rng.randn(kh * kw).astype(np.float32).tolist())
    x = torch.tensor(rng.randn(1, 5, 6, 2), requires_grad=True)

    def f(x):
        return ku.upfirdn2d(x, taps, kh, up, down, pad)

    y = f(x)
    assert tuple(y.shape[1:3]) == (
        ku.out_size(5, kh, up, down, pad[0], pad[1]),
        ku.out_size(6, kw, up, down, pad[2], pad[3]))
    assert torch.autograd.gradcheck(f, (x,))
    assert torch.autograd.gradgradcheck(f, (x,))


def _ops(prof):
    return {e.key: e.count for e in prof.key_averages()}


@pytest.mark.parametrize("name", ["d_blur", "ts_blur",
                                  "skip_upsample_no_zero_pad", "downsample"])
def test_double_backward_runs_no_per_channel_convolution(name):
    """An R1-style double backward (the gradient of a nonlinear function of
    the op's output w.r.t. its input, with create_graph, then backward to
    the parameters) through Blur, Upsample and Downsample issues no
    aten::_convolution_double_backward, and its values equal the depthwise
    convolution's autograd, which does."""
    rng = np.random.RandomState(5)
    x0 = rng.randn(2, 9, 9, 16).astype(np.float32)
    w0 = rng.randn(16).astype(np.float32)
    op = CALLS[name]

    def second(fn):
        x = torch.tensor(x0, requires_grad=True)
        w = torch.tensor(w0, requires_grad=True)
        y = torch.tanh(fn(x * w))
        g, = torch.autograd.grad((y * y).sum(), x, create_graph=True)
        (g * g).sum().backward()
        return g.detach(), w.grad

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = second(op)
    ops = _ops(prof)
    assert ops.get("aten::_convolution_double_backward", 0) == 0
    # one convolution a Function call: the forward, its backward (in the
    # gradient), and in the second backward the backward of each of those
    # two (tanh' reads the forward's output)
    assert ops.get("aten::convolution", 0) == 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        want = second(lambda x: _old_path(name, x))
    assert _ops(prof).get("aten::_convolution_double_backward", 0) >= 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_backward_saves_no_input():
    """The Function is linear with a constant stencil: its graph holds no
    tensor of x, and a stencil never gets a gradient."""
    x = torch.randn(1, 6, 6, 4, requires_grad=True)
    y = ku.upfirdn2d(x, tuple([0.25] * 4), 2, 1, 1, (1, 1, 1, 1))
    assert y.grad_fn.saved_tensors == ()
    y.sum().backward()
    assert torch.allclose(x.grad, torch.ones_like(x))


def test_kernel_limits_are_checked_before_any_launch():
    """The CUDA path refuses what the kernel does not take, before it
    allocates or builds anything (meta tensors reach the checks)."""
    x = torch.empty((1, 8, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ku.upfirdn2d(x, (1.0,) * 4, 2)
    with pytest.raises(ValueError, match="at most 4x4"):
        ku._launch(x, (1.0,) * 25, 5, 1, 1, (0, 0, 0, 0))
    with pytest.raises(ValueError, match="1 or 2"):
        ku._launch(x, (1.0,) * 4, 2, 3, 1, (0, 0, 0, 0))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ku._launch(x.half(), (1.0,) * 4, 2, 1, 1, (0, 0, 0, 0))
    with pytest.raises(ValueError, match="empty output"):
        ku._launch(x, (1.0,) * 16, 4, 1, 1, (-3, -3, 0, 0))
