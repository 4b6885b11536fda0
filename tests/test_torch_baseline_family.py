"""The styleGAN2 baseline generator family in the port (no SS: the TS on
the 4x4 local latent, zero padding, a [1,3,3,1] blur, out_res 64 or 128)
against the JAX package on the CPU, on JAX's weights (compat/from_jax.py)
and numpy inputs: the conv plan, each zero-padding layer (atol 1e-5), the
whole forward at tests/test_model_families.py's config (channel_base 48;
atol 1e-4, rtol 1e-4) and get_to_rgb, the weight maps without "ss", the
FLOP count, and the refusals: the engines with the JAX engine's
ValueError text, the trainer by the config's name."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgan_tpu.compat.baseline import (
    import_torch_baseline_generator as jimport_baseline)
from spgan_tpu.compat.load import save_params_npz as jsave_params_npz
from spgan_tpu.compat.torch_import import (
    export_torch_style_state_dict as jexport)
from spgan_tpu.config import Config as JConfig
from spgan_tpu.infer.engine import PanoramaEngine as JEngine
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.models.generator import ts_conv_plan as jplan
from spgan_tpu.models.latents import LatentSampler as JLatentSampler
from spgan_tpu.ops import modulated as jmod
from spgan_tpu.utils.flops import generator_flops as jflops
from spgan_tpu_torch.compat.baseline import import_torch_baseline_generator
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.compat.torch_import import (
    export_torch_style_state_dict, import_torch_generator)
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.halo import make_width_sharded_generate
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator, ts_conv_plan
from spgan_tpu_torch.models.latents import LatentSampler
from spgan_tpu_torch.ops import modulated as mod
from spgan_tpu_torch.parallel.mesh import Mesh
from spgan_tpu_torch.train.loop import train
from spgan_tpu_torch.train.step import make_train_step
from spgan_tpu_torch.tree import flatten
from spgan_tpu_torch.utils.flops import generator_flops
from helpers.port_tiny import cpu_budget, jax_layout

BLUR = (1.0, 3.0, 3.0, 1.0)


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    with cpu_budget():
        yield


def _jitter(tree, rng):
    """Every leaf moved by N(0, 0.3), as float32 numpy: the zero-init
    noise weights and biases count."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.3 * np.asarray(
            rng.randn(*np.shape(a)))).astype(np.float32), tree)


def baseline(cfg, patch_size=64):
    """tests/test_model_families.py's baseline config, either package."""
    tp = cfg.train_params
    tp.styleGAN2_baseline = True
    tp.use_ss = False
    tp.ts_input_size = 4
    tp.patch_size = patch_size
    tp.ts_no_zero_pad = False
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.diversity_z_w = 0
    return cfg


def _models(patch_size):
    """(JAX generator, its params (_jitter), the port's generator):
    channel_base 48."""
    jg = JGenerator.from_config(baseline(JConfig(), patch_size))
    g = Generator.from_config(baseline(Config(), patch_size))
    for gg in (jg, g):
        object.__setattr__(gg.ts, "channel_base", 48)
    jp = _jitter(jg.init(jax.random.PRNGKey(0)),
                 np.random.RandomState(patch_size))
    return jg, jp, g


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("out_res, cm, base", [
    (64, 1, 48), (128, 1, 48), (64, 2, 512), (128, 2, 512)])
def test_ts_conv_plan_matches_jax(out_res, cm, base):
    convs, to_rgbs, i2j = ts_conv_plan(out_res, 4, cm, base)
    jconvs, jto_rgbs, ji2j = jplan(out_res, 4, cm, base)
    assert convs == jconvs and i2j == ji2j == {}
    assert to_rgbs == [{"src": t["src"], "tgt": t["tgt"]} for t in jto_rgbs]
    assert len(convs) == {64: 8, 128: 10}[out_res]


def _layer_case(name):
    """(port spec, JAX spec, x shape): the zero-padding layers of the
    baseline TS."""
    if name == "upsample_conv":
        kw = dict(in_ch=6, out_ch=5, kernel_size=3, style_dim=7,
                  upsample=True, blur_kernel=BLUR, no_zero_pad=False)
        return mod.ModulatedConv2d(**kw), jmod.ModulatedConv2d(**kw), \
            (2, 4, 5, 6)
    if name == "plain_conv":
        kw = dict(in_ch=6, out_ch=5, kernel_size=3, style_dim=7,
                  blur_kernel=BLUR, no_zero_pad=False)
        return mod.ModulatedConv2d(**kw), jmod.ModulatedConv2d(**kw), \
            (2, 8, 7, 6)
    kw = dict(in_ch=6, style_dim=7, blur_kernel=BLUR, no_zero_pad=False)
    return mod.ToRGB(**kw), jmod.ToRGB(**kw), (2, 8, 8, 6)


@pytest.mark.parametrize("name", ["upsample_conv", "plain_conv", "to_rgb"])
def test_zero_pad_layers_match_jax(name):
    """The modulated upsample conv (transposed conv, then the 4-tap blur
    with StyleGAN2's even padding: 2H out), the plain conv (padding 1) and
    ToRGB with the 4-tap zero-padding skip upsample."""
    spec, jspec, shape = _layer_case(name)
    rng = np.random.RandomState(3)
    params = _jitter(jspec.init(jax.random.PRNGKey(1)), rng)
    x = rng.randn(*shape).astype(np.float32)
    style = rng.randn(shape[0], 7).astype(np.float32)
    args = [x, style]
    if name == "to_rgb":
        args.append(rng.randn(shape[0], 4, 4, 3).astype(np.float32))
    want = jax.jit(jspec.apply)(params, *map(jnp.asarray, args))
    got = spec.apply(params_from_jax(params, device="cpu"),
                     *map(torch.tensor, args))
    assert tuple(got.shape) == want.shape == {
        "upsample_conv": (2, 8, 10, 5), "plain_conv": (2, 8, 7, 5),
        "to_rgb": (2, 8, 8, 3)}[name]
    _close(got, want, 1e-5)


def _inputs(g, batch=2, seed=5):
    rng = np.random.RandomState(seed)
    gl = rng.randn(batch, 2, 32).astype(np.float32)
    gl[:, 1] = gl[:, 0]
    ll = rng.randn(batch, 4, 4, 16).astype(np.float32)
    noises = [rng.randn(batch, s, s, 1).astype(np.float32)
              for s in g.ts.noise_sizes()]
    return gl, ll, noises


@pytest.mark.parametrize("out_res", [64, 128])
def test_baseline_forward_matches_jax(out_res):
    jg, jp, g = _models(out_res)
    assert g.ss is None and jg.ss is None
    assert g.ts.noise_sizes() == [8, 8, 16, 16, 32, 32, 64, 64, 128,
                                  128][:g.ts.num_layers]
    kw = dict(global_dim=32, local_dim=16, ts_input_size=4,
              ss_unfold_size=0)
    assert tuple(LatentSampler(**kw).sample_local(
        torch.Generator().manual_seed(0), 2).shape) == (2, 4, 4, 16)
    assert LatentSampler(**kw).local_shape() == \
        JLatentSampler(**kw).local_shape() == (4, 4)
    gl, ll, noises = _inputs(g)
    want = jax.jit(lambda p, gl, ll, n: jg.apply(
        p, global_latent=gl, local_latent=ll, cp=None, noises=n)["gen"])(
        jp, jnp.asarray(gl), jnp.asarray(ll), [jnp.asarray(n)
                                               for n in noises])
    params = params_from_jax(jp, device="cpu")
    assert "ss" not in params
    out = g.apply(params, global_latent=torch.tensor(gl),
                  local_latent=torch.tensor(ll), coords=None, cp=None,
                  noises=[torch.tensor(n) for n in noises])
    assert tuple(out["gen"].shape) == want.shape == (2, out_res, out_res, 3)
    assert torch.equal(out["structure_latent"], torch.tensor(ll))
    _close(out["gen"], want, 1e-4, 1e-4)


def test_get_to_rgb_on_the_baseline():
    """With an explicit structure latent, JAX's patch and (empty) sphere
    skip features; without one, a ValueError naming the baseline (JAX:
    an AttributeError)."""
    jg, jp, g = _models(64)
    gl, ll, noises = _inputs(g, seed=6)
    want = jax.jit(lambda p, gl, ll, n: jg.get_to_rgb(
        p, global_latent=gl, structure_latent=ll, cp=None, noises=n))(
        jp, jnp.asarray(gl), jnp.asarray(ll), [jnp.asarray(n)
                                               for n in noises])
    params = params_from_jax(jp, device="cpu")
    got = g.get_to_rgb(params, cp=None, global_latent=torch.tensor(gl),
                       structure_latent=torch.tensor(ll),
                       noises=[torch.tensor(n) for n in noises])
    assert sorted(got) == sorted(want) == ["patch"]
    _close(got["patch"], want["patch"], 1e-4, 1e-4)
    with pytest.raises(ValueError, match="styleGAN2 baseline"):
        g.get_to_rgb(params, cp=None, global_latent=torch.tensor(gl),
                     local_latent=torch.tensor(ll), coords=None)


def test_weight_maps_without_ss(tmp_path):
    """params_from_jax on a tree without "ss", or on its flat .npz keys,
    gives the port's init structure; the reference state dict (JAX's
    export) imports to the same parameters through
    import_torch_generator, the partial baseline import loads every leaf,
    and the port's export equals JAX's."""
    jg, jp, g = _models(128)
    params = params_from_jax(jp, device="cpu")
    template = g.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in flatten(template)}
    assert {k: tuple(v.shape) for k, v in flatten(params)} == shapes
    jsave_params_npz(str(tmp_path / "g.npz"), jp)
    with np.load(tmp_path / "g.npz") as f:
        flat = params_from_jax({k: f[k] for k in f.files}, device="cpu")
    for k, v in flatten(params):
        assert torch.equal(dict(flatten(flat))[k], v), k
    sd = {k: torch.tensor(np.array(v)) for k, v in jexport(jp, jg).items()}
    assert not any(k.startswith("structure_synthesizer") for k in sd)
    imported = import_torch_generator(sd, g, device="cpu")
    for k, v in flatten(params):
        assert torch.equal(dict(flatten(imported))[k], v), k
    loaded, mask = import_torch_baseline_generator(sd, g, template)
    jloaded, jmask = jimport_baseline(sd, jg, jg.init(jax.random.PRNGKey(9)))
    assert all(m for _, m in flatten(mask))
    assert dict(flatten(mask)) == {k: bool(m) for k, m in flatten(jmask)}
    for k, v in flatten(jax_layout(loaded)):
        np.testing.assert_array_equal(v, np.asarray(dict(flatten(jloaded))[k]),
                                      err_msg=k)
    ours = export_torch_style_state_dict(params, g)
    assert sorted(ours) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(ours[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("patch_size", [64, 128])
def test_generator_flops_match_jax(patch_size):
    jg, _, g = _models(patch_size)
    assert generator_flops(g, batch=3) == jflops(jg, batch=3)
    assert generator_flops(g)["flops_ss"] == 0


def test_engines_refuse_with_jax_text():
    """The folded engine (and so its sharded form) and the halo path raise
    the JAX engine's ValueError before any field is drawn."""
    jg, _, g = _models(64)
    with pytest.raises(ValueError) as want:
        JEngine(g=jg, plan=None, batch=1)
    with pytest.raises(ValueError) as got:
        PanoramaEngine(g=g, plan=None, batch=1, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as halo:
        make_width_sharded_generate(g, None, Mesh(), 1, 0.6667,
                                    device="cpu")
    assert str(halo.value) == str(want.value)


@pytest.mark.parametrize("baseline_flag, use_ss", [(True, True),
                                                   (False, False)])
def test_trainer_refuses_the_baseline_by_name(baseline_flag, use_ss,
                                              tmp_path):
    cfg = baseline(Config())
    cfg.train_params.styleGAN2_baseline = baseline_flag
    cfg.train_params.use_ss = use_ss
    cfg.log_dir = str(tmp_path)
    g = Generator.from_config(cfg)
    assert g.ss is None
    d = Discriminator(patch_size=64, channel_multiplier=1, batch_size=2)
    msg = (f"styleGAN2_baseline: {baseline_flag}, use_ss: {use_ss}: the "
           "styleGAN2 baseline family")
    with pytest.raises(ValueError, match=msg):
        make_train_step(cfg, g, d)
    with pytest.raises(ValueError, match=msg):
        train(cfg, device="cpu")
    assert not list(tmp_path.iterdir())
