"""The ops, networks and model variants outside the engine and the
training step, on cuda against the same code on cpu at small shapes,
float32 without TF32: the remaining ops of the JAX package, the
styleGAN2 baseline forward (which launches no hand-written kernel), the
evaluation networks, and a tiny patch inversion.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_ops_card.py

Skips without a CUDA device."""
import os

import numpy as np
import pytest
import torch

from helpers.card import (Launches, assert_close, needs_card, no_tf32, only,
                          tiny_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


def _both(fn, *args):
    """fn on args moved to cuda, and on args as given (cpu)."""
    from spgan_tpu_torch.tree import tree_map

    cuda = tree_map(lambda a: a.cuda() if torch.is_tensor(a) else a,
                    list(args))
    return fn(*cuda), fn(*args)


def _t(rng, *shape):
    return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32))


def _init(spec):
    """The spec's init, moved off its neutral values."""
    from spgan_tpu_torch.tree import tree_map

    p = spec.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    return tree_map(lambda a: a + 0.3 * torch.randn(a.shape, generator=gen), p)


def _ops():
    from spgan_tpu_torch.geometry import global_conv as gc
    from spgan_tpu_torch.models.generator import create_fusion_styles
    from spgan_tpu_torch.ops import modulated as mod
    from spgan_tpu_torch.ops import upfirdn as up

    sc = mod.StyledConv(mod.ModulatedConv2d(6, 5, 3, 8, no_zero_pad=True),
                        activation="lrelu_plain")
    cases = {
        "downsample": lambda r: (up.Downsample(), _t(r, 2, 12, 10, 5)),
        "blur_replicate": lambda r: (
            up.Blur((1.0, 3.0, 3.0, 1.0), pad=(1, 2, 0, 1),
                    upsample_factor=2, padding_mode="replicate"),
            _t(r, 2, 9, 11, 3)),
        "styled_conv_lrelu_plain": lambda r: (
            sc.apply, _init(sc), _t(r, 2, 9, 9, 6), _t(r, 2, 8),
            _t(r, 2, 7, 7, 1)),
        "fusion_styles": lambda r: (create_fusion_styles, _t(r, 2, 3, 5, 7),
                                    [_t(r, 2, 8) for _ in range(3)]),
    }
    for upsample in (False, True):
        mc = mod.ModulatedConv2d(6, 4, 3, 8, no_zero_pad=True,
                                 upsample=upsample)
        cases[f"spatial_style_upsample_{upsample}"] = \
            lambda r, mc=mc: (mc.apply, _init(mc), _t(r, 2, 9, 9, 6),
                              _t(r, 2, 11, 11, 8))
    for spec in (gc.GlobalSphereConv2d(4, 5, 3, 2),
                 gc.IncreIntervalSphereConv2d(4, 5, 3, 2),
                 gc.IncreIntervalSphereConv2d(4, 5, 3, 1, upsample=True)):
        name = f"{type(spec).__name__}_{spec.stride}" + (
            "_up" if getattr(spec, "upsample", False) else "")
        cases[name] = lambda r, s=spec: (s.apply, _init(s),
                                         _t(r, 2, 16, 32, 4))
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_ops()))
def test_op_matches_cpu_on_card(name):
    fn, *args = _ops()[name](np.random.RandomState(9))
    got, ref = _both(fn, *args)
    for k in (ref if isinstance(ref, dict) else [None]):
        assert_close(got if k is None else got[k],
                     ref if k is None else ref[k], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_samplers_and_to_rgb_match_cpu_on_card():
    """The nearest sampler bit for bit; get_to_rgb of a tiny generator."""
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.grid_sample import nearest_grid_sample_shared

    rng = np.random.RandomState(9)
    got, ref = _both(nearest_grid_sample_shared, _t(rng, 2, 7, 9, 3),
                     _t(rng, 5, 11, 2) * 1.3)
    assert torch.equal(got.cpu(), ref)
    g = Generator.from_config(tiny_config())
    object.__setattr__(g.ts, "channel_base", 48)
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    coords, _, cp = g.ss.coord_grid.sample_training(
        torch.Generator().manual_seed(3), 2)
    zs = g.ss.coord_grid.ss_spatial_size
    noises = [_t(rng, 2, s, s, 1) for s in g.ts.stitch_geometry().outfeat_sizes]

    def to_rgb(p, gl, ll, coords, noises):
        return g.get_to_rgb(p, cp=cp, global_latent=gl, local_latent=ll,
                            coords=coords, noises=noises)

    got, ref = _both(to_rgb, params, _t(rng, 2, 2, 32), _t(rng, 2, zs, zs, 16),
                     coords, noises)
    for k in ref:
        assert_close(got[k], ref[k], atol=2e-4, rtol=1e-4)


@pytest.mark.gpu
def test_baseline_forward_matches_cpu_on_card():
    """spgan.yaml as the styleGAN2 baseline (out_res 128 from a 4x4 local
    latent, 10 convs of 512 channels, [1,3,3,1] blur) at batch 2: within
    1e-4 of the largest value (cuDNN and the CPU sum ten demodulated
    layers in other orders); no sphere kernel launches, one styled conv
    epilogue a conv."""
    from spgan_tpu_torch.config import load_config
    from spgan_tpu_torch.models.generator import Generator

    cfg = load_config(os.path.join(REPO, "configs", "model", "spgan.yaml"))
    tp = cfg.train_params
    tp.styleGAN2_baseline, tp.use_ss = True, False
    tp.ts_input_size, tp.patch_size, tp.ts_no_zero_pad = 4, 128, False
    g = Generator.from_config(cfg)
    assert g.ss is None and g.ts.out_res == 128
    gen = torch.Generator().manual_seed(0)
    gl = torch.randn((2, 2, g.ts.global_dim), generator=gen)
    gl[:, 1] = gl[:, 0]
    ll = torch.randn((2, 4, 4, g.ts.local_dim), generator=gen)
    noises = [torch.randn((2, s, s, 1), generator=gen)
              for s in g.ts.noise_sizes()]
    out = {}
    for dev in ("cpu", "cuda"):
        params = g.init(torch.Generator().manual_seed(0), device=dev)
        for c in params["ts"]["convs"]:
            c["noise"]["weight"].fill_(0.1)
        with torch.inference_mode(), Launches() as n:
            out[dev] = g.apply(params, global_latent=gl.to(dev),
                               local_latent=ll.to(dev), coords=None, cp=None,
                               noises=[t.to(dev) for t in noises])["gen"]
    # one epilogue a styled conv (inference mode on cuda), nothing else
    assert n.got == only(upfirdn=n.got["upfirdn"],
                         styled_epilogue=g.ts.num_layers)
    assert_close(out["cuda"], out["cpu"],
                 atol=1e-4 * float(out["cpu"].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["inception_features", "inception_logits",
                                 "lpips"])
def test_eval_network_matches_cpu_on_card(net):
    """Seeded random networks at batch 4 on a 101^2 patch and a 256x768
    panorama (which the resize shrinks): within 1e-4 of the largest value
    plus 1e-3 relative."""
    from spgan_tpu_torch.evalkit.inception import random_inception
    from spgan_tpu_torch.evalkit.lpips import random_lpips

    rng = np.random.RandomState(12)
    if net == "lpips":
        nets = {d: random_lpips(device=d) for d in ("cuda", "cpu")}
        inputs = [(_t(rng, 4, 256, 768, 3), _t(rng, 4, 256, 768, 3))]
    else:
        nets = {d: random_inception(with_logits=net.endswith("logits"),
                                    device=d) for d in ("cuda", "cpu")}
        inputs = [(_t(rng, 4, h, w, 3),) for h, w in ((101, 101), (256, 768))]
    with torch.no_grad():
        for args in inputs:
            ref = nets["cpu"](*args)
            got = nets["cuda"](*(a.cuda() for a in args))
            assert_close(got, ref, atol=1e-4 * float(ref.abs().max()),
                         rtol=1e-3)


@pytest.mark.gpu
def test_tiny_inversion_matches_cpu_on_card():
    """invert_patch's first three losses from one numpy start, within 1e-3
    relative."""
    from spgan_tpu_torch.infer.inversion import invert_patch
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.tree import tree_map

    g = Generator.from_config(tiny_config())
    object.__setattr__(g.ts, "channel_base", 48)
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    coords, _, cp = g.ss.coord_grid.sample_training(
        torch.Generator().manual_seed(2), 1)
    rng = np.random.RandomState(6)
    zs = g.ss.coord_grid.ss_spatial_size
    init = {"w_mean": rng.randn(g.ts.global_dim).astype(np.float32),
            "z": rng.randn(1, zs, zs, g.ts.local_dim).astype(np.float32),
            "gz": rng.randn(1, g.ts.global_dim).astype(np.float32),
            "noises": [rng.randn(1, s, s, 1).astype(np.float32)
                       for s in g.ts.stitch_geometry().outfeat_sizes]}
    target = _t(rng, 1, 101, 101, 3)
    cpu = invert_patch(g, params, target, cp, coords, steps=3,
                       init=init).losses
    gpu = invert_patch(g, tree_map(lambda t: t.cuda(), params),
                       target.cuda(), cp, coords.cuda(), steps=3,
                       init=init).losses
    np.testing.assert_allclose(gpu, cpu, rtol=1e-3)
