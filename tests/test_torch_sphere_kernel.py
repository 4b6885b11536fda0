"""The fused sphere-conv kernel's plain PyTorch version against the JAX
package's Pallas kernels (interpret mode on the CPU, as
tests/test_pallas_sphere.py runs them), and the wrapper's dispatch: a CPU
tensor takes the plain version, anything else the CUDA kernel or an error.

Tolerances: float32 2e-5 (the same lerps; tap products summed in another
order).  bf16: both sides round the same float32 tap once to bf16 and sum
in float32, so the outputs agree to one bf16 rounding of the result
(relative 2^-8) plus float32 summation noise: rtol 2^-7, atol 1e-3 on
O(1) outputs."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.geometry.sphere_grid import sphere_offset_tables
from spgan_tpu.ops.pallas import sphere_kernel as jk
from spgan_tpu_torch.ops.kernels import sphere_kernel as tk
from spgan_tpu_torch.utils import trace

_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=1e-3, rtol=2 ** -7)}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _launches(kernel: str) -> int:
    """The wrapper's launch counter (utils/trace.py)."""
    return trace.counters().get(f"spgan.{kernel}.launches", 0)


def _to_torch(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(_TDT[dtype])


def _tables(tabs):
    return {k: torch.tensor(np.asarray(v)) for k, v in tabs.items()}


def _compare(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,circ", [(17, 1.0), (29, 0.0)])
def test_plain_matches_jax_per_sample(hw, circ, dtype):
    rng = np.random.RandomState(hw)
    B, C, Cout = 2, 16, 8
    x = rng.randn(B, hw, hw, C).astype(np.float32)
    w9 = (rng.randn(9, C, Cout) * 0.1).astype(np.float32)
    t = sphere_offset_tables(0.1, 0.65, 0.3, 0.85, circ, 0.6667, h=hw, w=hw,
                             k=3, x_total=65, y_total=48)
    tabs = {k: jnp.tile(v[None], (B, 1, 1)) for k, v in t.items()}
    dt = jnp.dtype(dtype)
    want = jk.fused_sphere_conv(jnp.asarray(x).astype(dt), tabs,
                                jnp.asarray(w9).astype(dt), interpret=True)
    got = tk.fused_sphere_conv(_to_torch(x, dtype), _tables(tabs),
                               _to_torch(w9, dtype))
    assert got.dtype == _TDT[dtype]
    _compare(got, want, dtype)


def _random_group_tables(rng, G, H, K2):
    tg = {"y0": rng.randint(0, H, (G, H, K2)).astype(np.int32),
          "wy": rng.rand(G, H, K2).astype(np.float32),
          "sx": rng.randint(-7, 7, (G, H, K2)).astype(np.int32),
          "fx": rng.rand(G, H, K2).astype(np.float32)}
    tg["y1"] = np.minimum(tg["y0"] + 1, H - 1).astype(np.int32)
    return tg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_grouped(dtype):
    """Bg = 8 samples per table (the JAX kernel's smallest group), shifts
    beyond the margin (clipped to [-6, 5])."""
    rng = np.random.RandomState(0)
    G, Bg, H, W, C, Cout = 2, 8, 5, 11, 16, 24
    x = rng.randn(G * Bg, H, W, C).astype(np.float32)
    w9 = (rng.randn(9, C, Cout) * 0.1).astype(np.float32)
    tg = _random_group_tables(rng, G, H, 9)
    dt = jnp.dtype(dtype)
    want = jk.fused_sphere_conv_grouped(
        jnp.asarray(x).astype(dt), {k: jnp.asarray(v) for k, v in tg.items()},
        jnp.asarray(w9).astype(dt), groups=G, interpret=True)
    got = tk.fused_sphere_conv_grouped(_to_torch(x, dtype), _tables(tg),
                                       _to_torch(w9, dtype), groups=G)
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_equals_per_sample_with_repeated_tables(dtype):
    """One table per group == that table repeated per sample, bit for bit
    (the same per-element arithmetic)."""
    rng = np.random.RandomState(1)
    G, Bg, H, W, C, Cout = 3, 2, 9, 12, 8, 16
    x = _to_torch(rng.randn(G * Bg, H, W, C), dtype)
    w9 = _to_torch(rng.randn(9, C, Cout), dtype)
    tg = _tables(_random_group_tables(rng, G, H, 9))
    tp = {k: v.repeat_interleave(Bg, dim=0) for k, v in tg.items()}
    a = tk.fused_sphere_conv_grouped(x, tg, w9, groups=G)
    b = tk.fused_sphere_conv(x, tp, w9)
    assert torch.equal(a, b)


def test_no_silent_cpu_fallback():
    """Without a card, a CUDA request raises instead of drifting to the
    plain version: entry points refuse the default device, the wrapper
    refuses a tensor that is not on the CPU (a missing nvcc:
    tests/test_torch_native.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: "
                    "test_torch_sphere_kernel_card.py covers it")
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.device import resolve
    from spgan_tpu_torch.models.generator import Generator

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator.from_config(Config()).init(torch.Generator())
    x = torch.empty((2, 5, 5, 8), device="meta")
    tabs = {k: torch.zeros((2, 5, 9), dtype=dt)
            for k, dt in tk.TABLE_DTYPES.items()}
    before = _launches("sphere_conv")
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_sphere_conv(x, tabs, torch.empty((9, 8, 8), device="meta"))
    assert _launches("sphere_conv") == before
