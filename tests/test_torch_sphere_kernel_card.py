"""csrc/sphere_conv.cu against its plain PyTorch version on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_sphere_kernel_card.py -m gpu

Skips without a CUDA device.  Tolerances: float32 1e-5 (the same lerps,
products summed in another order; TF32 off); bf16 atol 1e-3 / rtol 2^-7
(identical bf16 taps, float32 sums in another order can move the final
bf16 rounding by one ulp)."""
import numpy as np
import pytest
import torch

from spgan_tpu_torch.ops.kernels import sphere_kernel as tk

_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=1e-3, rtol=2 ** -7)}


def _random_group_tables(rng, G, H, K2):
    tg = {"y0": rng.randint(0, H, (G, H, K2)).astype(np.int32),
          "wy": rng.rand(G, H, K2).astype(np.float32),
          "sx": rng.randint(-7, 7, (G, H, K2)).astype(np.int32),
          "fx": rng.rand(G, H, K2).astype(np.float32)}
    tg["y1"] = np.minimum(tg["y0"] + 1, H - 1).astype(np.int32)
    return {k: torch.tensor(v) for k, v in tg.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    """Both entry points, ragged tiles (M and Cout not multiples of the
    tile, C not a multiple of the channel chunk), shifts beyond the
    margin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(2)
    G, Bg, H, W, C, Cout = 3, 5, 13, 11, 40, 136
    x = torch.tensor(rng.randn(G * Bg, H, W, C), dtype=dtype).cuda()
    w9 = torch.tensor(rng.randn(9, C, Cout) / np.sqrt(9 * C),
                      dtype=dtype).cuda()
    tg = {k: v.cuda() for k, v in _random_group_tables(rng, G, H, 9).items()}
    tp = {k: v.repeat_interleave(Bg, dim=0).contiguous() for k, v in tg.items()}
    ref = tk.fused_sphere_conv_plain(x, tg, w9, G).cpu()
    n_g = tk.fused_sphere_conv_grouped.launches
    n_p = tk.fused_sphere_conv.launches
    got_g = tk.fused_sphere_conv_grouped(x, tg, w9, groups=G).cpu()
    got_p = tk.fused_sphere_conv(x, tp, w9).cpu()
    assert tk.fused_sphere_conv_grouped.launches == n_g + 1
    assert tk.fused_sphere_conv.launches == n_p + 1
    for got in (got_g, got_p):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   **_TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_bad_operands_on_card():
    """The wrapper raises, and launches nothing, on operands the kernel does
    not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(3)
    x = torch.randn(2, 5, 7, 16, device="cuda")
    w9 = torch.randn(9, 16, 8, device="cuda")
    tg = {k: v.cuda() for k, v in _random_group_tables(rng, 2, 5, 9).items()}
    n = tk.fused_sphere_conv.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.fused_sphere_conv(x.half(), tg, w9.half())
    with pytest.raises(ValueError, match="multiples of 8"):
        tk.fused_sphere_conv(x[..., :12].contiguous(), tg,
                             w9[:, :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_sphere_conv(x, tg, torch.randn(9, 8, 16, device="cuda")
                             .transpose(1, 2))
    with pytest.raises(ValueError, match="table y0"):
        tk.fused_sphere_conv(x, {**tg, "y0": tg["y0"].long()}, w9)
    assert tk.fused_sphere_conv.launches == n
