"""The port's op library (spgan_tpu_torch/ops) against the JAX package on
the same random inputs (numpy, seeded) and the same weights (carried
across by compat/from_jax.py).

Tolerances: elementwise ops 1e-5 (float32, one rounding apart); convs
1e-4 absolute on O(1) outputs (float32 sums of up to a few thousand
products in another order)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.ops import linear as jl
from spgan_tpu.ops import modulated as jm
from spgan_tpu.ops import spatial as jsp
from spgan_tpu.ops import upfirdn as ju
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.ops import linear as tl
from spgan_tpu_torch.ops import modulated as tm
from spgan_tpu_torch.ops import spatial as tsp
from spgan_tpu_torch.ops import upfirdn as tu


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


def _port(params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_pixel_norm_and_fused_leaky_relu():
    rng = np.random.RandomState(1)
    xj, xt = _both(rng.randn(3, 5, 5, 8).astype(np.float32))
    bj, bt = _both(rng.randn(8).astype(np.float32))
    _close(tl.pixel_norm(xt), jl.pixel_norm(xj), 1e-5)
    _close(tl.fused_leaky_relu(xt, bt), jl.fused_leaky_relu(xj, bj), 1e-5)
    # the bias is cast to the activation dtype (no bf16 -> f32 promotion)
    assert tl.fused_leaky_relu(xt.bfloat16(), bt).dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [
    dict(), dict(bias_init=1.0),
    dict(lr_mul=0.01, activation="fused_lrelu")])
def test_equal_linear(kw):
    rng = np.random.RandomState(2)
    spec_j = jl.EqualLinear(16, 12, **kw)
    spec_t = tl.EqualLinear(16, 12, **kw)
    p = spec_j.init(jax.random.PRNGKey(0))
    p["bias"] = p["bias"] + jnp.asarray(rng.randn(12).astype(np.float32))
    xj, xt = _both(rng.randn(4, 16).astype(np.float32))
    _close(spec_t.apply(_port(p), xt), spec_j.apply(p, xj), 1e-4)


@pytest.mark.parametrize("pad,up", [((0, 0), 2), ((1, 1), 1), ((2, 1), 2)])
def test_blur(pad, up):
    rng = np.random.RandomState(3)
    xj, xt = _both(rng.randn(2, 9, 9, 4).astype(np.float32))
    want = ju.Blur((1.0, 2.0, 1.0), pad=pad, upsample_factor=up)(xj)
    got = tu.Blur((1.0, 2.0, 1.0), pad=pad, upsample_factor=up)(xt)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("no_zero_pad,kernel", [
    (True, (1.0, 2.0, 1.0)), (False, (1.0, 3.0, 3.0, 1.0))])
def test_upsample(no_zero_pad, kernel):
    rng = np.random.RandomState(4)
    xj, xt = _both(rng.randn(2, 7, 7, 3).astype(np.float32))
    want = ju.Upsample(kernel, no_zero_pad=no_zero_pad)(xj)
    got = tu.Upsample(kernel, no_zero_pad=no_zero_pad)(xt)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("in_ch,out_ch,k,hw,kw", [
    (16, 8, 3, 9, dict(no_zero_pad=True)),                 # TS plain conv
    (131, 8, 7, 11, dict(no_zero_pad=True)),               # SS planar k7;
    # in_ch 131 = 128 + 3 takes the JAX package's lane-split branch
    (16, 8, 3, 7, dict(no_zero_pad=True, upsample=True)),  # TS upsample
    (16, 8, 3, 7, dict(upsample=True)),                    # zero-pad upsample
    (16, 3, 1, 9, dict(demodulate=False, no_zero_pad=True)),  # ToRGB conv
    (16, 8, 3, 9, dict()),                                 # zero-padded
])
def test_modulated_conv(in_ch, out_ch, k, hw, kw):
    rng = np.random.RandomState(5)
    spec_j = jm.ModulatedConv2d(in_ch, out_ch, k, style_dim=12, **kw)
    spec_t = tm.ModulatedConv2d(in_ch, out_ch, k, style_dim=12, **kw)
    p = spec_j.init(jax.random.PRNGKey(1))
    xj, xt = _both(rng.randn(2, hw, hw, in_ch).astype(np.float32))
    sj, st = _both(rng.randn(2, 12).astype(np.float32))
    want = spec_j.apply(p, xj, sj)
    got = spec_t.apply(_port(p), xt, st)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-4)


def test_styled_conv_with_noise():
    rng = np.random.RandomState(6)
    conv = dict(in_ch=16, out_ch=8, kernel_size=3, style_dim=12,
                upsample=True, no_zero_pad=True)
    spec_j = jm.StyledConv(jm.ModulatedConv2d(**conv))
    spec_t = tm.StyledConv(tm.ModulatedConv2d(**conv))
    p = spec_j.init(jax.random.PRNGKey(2))
    p["noise"]["weight"] = jnp.asarray(0.7)
    p["act_bias"] = jnp.asarray(rng.randn(8).astype(np.float32))
    xj, xt = _both(rng.randn(2, 7, 7, 16).astype(np.float32))
    sj, st = _both(rng.randn(2, 12).astype(np.float32))
    nj, nt = _both(rng.randn(2, 11, 11, 1).astype(np.float32))
    want = spec_j.apply(p, xj, sj, noise=nj)
    _close(spec_t.apply(_port(p), xt, st, noise=nt), want, 1e-4)


def test_to_rgb_with_skip():
    rng = np.random.RandomState(7)
    spec_j = jm.ToRGB(16, 12, no_zero_pad=True)
    spec_t = tm.ToRGB(16, 12, no_zero_pad=True)
    p = spec_j.init(jax.random.PRNGKey(3))
    p["bias"] = jnp.asarray(rng.randn(1, 1, 1, 3).astype(np.float32))
    xj, xt = _both(rng.randn(2, 17, 17, 16).astype(np.float32))
    sj, st = _both(rng.randn(2, 12).astype(np.float32))
    kj, kt = _both(rng.randn(2, 11, 11, 3).astype(np.float32))
    want = spec_j.apply(p, xj, sj, skip=kj)
    _close(spec_t.apply(_port(p), xt, st, skip=kt), want, 1e-4)


def test_spatial_chain_and_steps():
    specs_t = [tsp.ConvSpec(upsample=(i % 2 == 0)) for i in range(8)]
    specs_j = [jsp.ConvSpec(upsample=(i % 2 == 0)) for i in range(8)]
    assert tsp.out_size_chain(specs_t, 11) == [19, 17, 31, 29, 55, 53, 103, 101]
    geom = tsp.derive_stitch_geometry(specs_t, 11)
    assert (geom.pixelspace_step, geom.latentspace_step) == (96, 6)
    assert geom == tsp.StitchGeometry(
        **vars(jsp.derive_stitch_geometry(specs_j, 11)))
    assert tsp.in_size_chain(specs_t, 101) == jsp.in_size_chain(specs_j, 101)
