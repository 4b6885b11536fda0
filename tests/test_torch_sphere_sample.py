"""The tap sampler's plain PyTorch version (spgan_tpu_torch/ops/kernels/
sphere_sample.py) against the JAX package's Pallas kernel (interpret mode
on the CPU, as tests/test_pallas_sample.py runs it), the straight-through
VJP, the sample-mode sphere conv with its gradients, and the wrapper's
dispatch (a CPU tensor takes the plain version, anything else the CUDA
kernel or an error).

Tolerances: the taps are the same two float32 lerps on both sides, so
1e-5 (float32) and one bf16 rounding of O(1) values (bf16: atol 1e-2,
rtol 2^-7).  The sphere conv: the tolerances of test_pallas_sample.py
(forward atol 4e-4 / rtol 2e-3, gradients < 2e-4 relative to scale:
einsums over ~1e3 products reduced in another order)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.geometry.coords import CoordsPartial as JCP
from spgan_tpu.geometry.sphere_conv import SphereStyledConv as JSphere
from spgan_tpu.geometry.sphere_grid import sphere_offset_tables_batch as jtab
from spgan_tpu.ops.pallas import sphere_sample as js
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.geometry.sphere_conv import SphereStyledConv
from spgan_tpu_torch.ops.kernels import sphere_sample as ts
from spgan_tpu_torch.utils import trace

C_TRAIN = 259   # 256 latent + 3 coordinate channels on the training path


def _launches(kernel: str) -> int:
    """The wrapper's launch counter (utils/trace.py)."""
    return trace.counters().get(f"spgan.{kernel}.launches", 0)


def _jcp(rng, b):
    st = rng.rand(b).astype(np.float32) * 0.3
    yst = rng.rand(b).astype(np.float32) * 0.5
    return JCP(p_x_st=jnp.asarray(st), p_x_ed=jnp.asarray(st + 0.5),
               p_y_st=jnp.asarray(yst), p_y_ed=jnp.asarray(yst + 0.4),
               circular=jnp.zeros((b,)), x_total=65, y_total=48,
               grid_partial=0.8)


def _tables(tabs):
    return {k: torch.tensor(np.asarray(v)) for k, v in tabs.items()}


@pytest.mark.parametrize("hw,dtype", [(35, "float32"), (17, "float32"),
                                      (17, "bfloat16")])
def test_plain_matches_jax_kernel(hw, dtype):
    rng = np.random.RandomState(hw)
    B = 2
    tabs = jtab(_jcp(rng, B), hw, hw, 3)
    # a wide shift at one row exercises the [-6, 5] clip (edge padding)
    tabs = dict(tabs, sx=tabs["sx"].at[:, 0, 0].set(-9).at[:, 1, 2].set(8))
    x = rng.randn(B, hw, hw, C_TRAIN).astype(np.float32)
    dt = jnp.dtype(dtype)
    want = js.sphere_sample_taps(jnp.asarray(x).astype(dt), tabs,
                                 interpret=True)
    xt = torch.tensor(x).to(getattr(torch, dtype))
    got = ts.sphere_sample_taps(xt, _tables(tabs))
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=1e-2, rtol=2 ** -7))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_st_sample_taps_vjp_matches_jax():
    """The straight-through gradient: 0.1 * mean over taps of the
    cotangent, nothing to the tables."""
    rng = np.random.RandomState(1)
    B, H, C = 2, 17, 5
    tabs = jtab(_jcp(rng, B), H, H, 3)
    x = rng.randn(B, H, H, C).astype(np.float32)
    cot = rng.randn(B, 9, H, H, C).astype(np.float32)
    _, vjp = jax.vjp(lambda z: js.st_sample_taps(z, tabs), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    xt = torch.tensor(x, requires_grad=True)
    y = ts.st_sample_taps(xt, _tables(tabs))
    (got,) = torch.autograd.grad((y * torch.tensor(cot)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_sphere_conv_sample_mode_fwd_and_grads():
    """tables_mode "sample" of the port against the JAX package's (Pallas
    sampler in interpret mode + einsum): forward and the gradients w.r.t.
    input, weight and style."""
    rng = np.random.RandomState(2)
    B, H = 2, 23
    local, coord, out, sd = 8, 3, 8, 16
    jconv = JSphere(local_dim=local, coord_dim=coord, out_ch=out, style_dim=sd)
    tconv = SphereStyledConv(local_dim=local, coord_dim=coord, out_ch=out,
                             style_dim=sd)
    jp = jconv.init(jax.random.PRNGKey(0))
    jp["conv"]["weight"] = jp["conv"]["weight"] + 0.05 * jnp.asarray(
        rng.randn(*jp["conv"]["weight"].shape).astype(np.float32))
    jp["conv"]["modulation"]["bias"] = jnp.asarray(
        1.0 + 0.1 * rng.randn(local + coord).astype(np.float32))
    cp = _jcp(rng, B)
    tabs = jtab(cp, H, H, 3)
    x = rng.randn(B, H, H, local).astype(np.float32)
    style = rng.randn(B, sd).astype(np.float32)
    coords = rng.rand(B, H, H, coord).astype(np.float32) * 40.0
    cot = rng.randn(B, H, H, out).astype(np.float32)

    def jloss(x_, w_, s_):
        p = {"conv": dict(jp["conv"], weight=w_)}
        y = jconv.apply(p, x_, s_, jnp.asarray(coords), cp, tables=tabs,
                        tables_mode="sample")
        return (y * cot).sum(), y

    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(x), jp["conv"]["weight"], jnp.asarray(style))

    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    leaves = [torch.tensor(x, requires_grad=True),
              tp["conv"]["weight"].requires_grad_(True),
              torch.tensor(style, requires_grad=True)]
    y_t = tconv.apply({"conv": dict(tp["conv"], weight=leaves[1])},
                      leaves[0], leaves[2], torch.tensor(coords), None,
                      _tables(tabs), tables_mode="sample")
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=4e-4, rtol=2e-3)
    g_t = torch.autograd.grad((y_t * torch.tensor(cot)).sum(), leaves)
    # weight: the port holds OIHW, JAX HWIO
    g_t = [g_t[0].numpy(), g_t[1].permute(2, 3, 1, 0).numpy(), g_t[2].numpy()]
    for a, b, name in zip(g_t, g_j, ("x", "weight", "style")):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-6)
        err = np.abs(a - b).max() / scale
        assert err < 2e-4, f"grad mismatch for {name}: rel-to-scale {err}"


def test_no_silent_cpu_fallback():
    """A tensor that is not on the CPU goes to the kernel or raises: the
    wrapper never computes it with the plain version, and counts nothing
    it did not launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: "
                    "test_torch_sphere_sample_card.py covers it")
    x = torch.empty((2, 5, 7, C_TRAIN), device="meta")
    tabs = {k: torch.zeros((2, 5, 9), dtype=dt)
            for k, dt in ts.TABLE_DTYPES.items()}
    before = _launches("sphere_sample")
    with pytest.raises(ValueError, match="CUDA"):
        ts.sphere_sample_taps(x, tabs)
    assert _launches("sphere_sample") == before
