"""What the port's card tests share (`tests/test_torch_*_card.py`): the
skip without a card, float32 without TF32, the kernel wrappers' launch
counters and the tiny widths the CPU tests use.  Imports no JAX."""
import contextlib

import pytest
import torch

from spgan_tpu_torch.utils import trace

KERNELS = ("sphere_conv.grouped", "sphere_conv", "sphere_sample", "upfirdn",
           "styled_epilogue", "filtered_lrelu")


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@contextlib.contextmanager
def no_tf32():
    """float32 means float32 while inside."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


class Launches:
    """The kernel wrappers' launches (their counters in utils/trace.py)
    while inside: ``.got`` maps each of KERNELS to its count."""

    def __enter__(self):
        self._before = self._now()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        now = self._now()
        self.got = {k: now[k] - self._before[k] for k in KERNELS}

    @staticmethod
    def _now():
        c = trace.counters()
        return {k: c.get(f"spgan.{k}.launches", 0) for k in KERNELS}


def only(**want):
    """A Launches.got with `want` (keyword `grouped` for
    sphere_conv.grouped) and none of the other kernels."""
    got = dict.fromkeys(KERNELS, 0)
    for k, v in want.items():
        got["sphere_conv.grouped" if k == "grouped" else k] = v
    return got


def tiny_config():
    """The shipped Config at the CPU tests' tiny latent widths."""
    from spgan_tpu_torch.config import Config

    cfg = Config()
    tp = cfg.train_params
    tp.global_latent_dim, tp.local_latent_dim = 32, 16
    tp.channel_multiplier, tp.n_mlp, tp.ss_n_layers = 1, 2, 2
    return cfg


def assert_close(got, ref, atol, rtol=0.0):
    """Every value finite and within atol + rtol * |ref|."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    assert bool(got.isfinite().all())
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    assert not bool(bad.any()), (f"{int(bad.sum())} values off, max abs err "
                                 f"{float(err.max()):.3e}")
