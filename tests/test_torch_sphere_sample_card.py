"""csrc/sphere_sample.cu against its plain PyTorch version on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_sphere_sample_card.py -m gpu

Skips without a CUDA device.  The kernel and the plain version run the
same float32 lerps op by op (no FMA contraction) and cast once, so the
taps must agree exactly, in float32 and in bf16."""
import numpy as np
import pytest
import torch

from spgan_tpu_torch.ops.kernels import sphere_sample as ts


def _random_tables(rng, B, H, K2):
    t = {"y0": rng.randint(0, H, (B, H, K2)).astype(np.int32),
         "wy": rng.rand(B, H, K2).astype(np.float32),
         "sx": rng.randint(-9, 9, (B, H, K2)).astype(np.int32),
         "fx": rng.rand(B, H, K2).astype(np.float32)}
    t["y1"] = np.minimum(t["y0"] + 1, H - 1).astype(np.int32)
    return {k: torch.tensor(v).cuda() for k, v in t.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    """C = 259 (rows not 16-byte aligned), W != H, shifts beyond the
    margin (clipped to [-6, 5])."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    B, H, W, C = 3, 13, 11, 259
    x = torch.tensor(rng.randn(B, H, W, C), dtype=dtype).cuda()
    tabs = _random_tables(rng, B, H, 9)
    ref = ts.sphere_sample_taps_plain(x, tabs).cpu()
    n = ts.sphere_sample_taps.launches
    got = ts.sphere_sample_taps(x, tabs)
    torch.cuda.synchronize()
    assert ts.sphere_sample_taps.launches == n + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, 9, H, W, C)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_kernel_rejects_bad_operands_on_card():
    """The wrapper raises, and launches nothing, on operands the kernel does
    not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(1)
    x = torch.randn(2, 5, 7, 259, device="cuda")
    tabs = _random_tables(rng, 2, 5, 9)
    n = ts.sphere_sample_taps.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ts.sphere_sample_taps(x.half(), tabs)
    with pytest.raises(ValueError, match="contiguous"):
        ts.sphere_sample_taps(x.transpose(1, 2), tabs)
    with pytest.raises(ValueError, match="table wy"):
        ts.sphere_sample_taps(x, {**tabs, "wy": tabs["wy"].double()})
    with pytest.raises(ValueError, match="table y0"):
        ts.sphere_sample_taps(x, {**tabs, "y0": tabs["y0"][:1]})
    assert ts.sphere_sample_taps.launches == n
