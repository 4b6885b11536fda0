"""The JAX package's last public functions in the port, each against its
JAX counterpart on the CPU on numpy inputs (float32, atol 1e-6 unless
stated): the reference checkpoint maps (import_torch_discriminator,
export_torch_style_state_dict), load_params_npz, the losses l1_loss /
l2_loss / grad_reduce, scaled_leaky_relu, gaussian_kernel and blur,
ConstantInput, the bilinear grid samplers, the spatial-size helpers, the
presampled patch grids (also against tests/golden at
tests/test_golden_grids.py's atol 2e-5), CoordsPartial.batch,
LatticePlan.coords_partial, TrainParams.ss_input_size, Config.replace,
TextureSynthesizer.num_layers, LatentSampler.sample_circular_local and
FileLock; and the names the ops and compat packages export."""
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgan_tpu.compat as jcompat_pkg
import spgan_tpu.ops as jops_pkg
import spgan_tpu_torch.compat as compat_pkg
import spgan_tpu_torch.ops as ops_pkg
from spgan_tpu.compat import load as jload
from spgan_tpu.compat import torch_import as jti
from spgan_tpu.config import Config as JConfig
from spgan_tpu.geometry.sphere_grid import (
    sphere_patch_grid_presampled as jpresampled)
from spgan_tpu.infer.stitcher import build_close_loop_plan as jplan
from spgan_tpu.models import losses as jlosses
from spgan_tpu.models.discriminator import Discriminator as JDiscriminator
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.models.latents import LatentSampler as JLatentSampler
from spgan_tpu.ops import grid_sample as jgs
from spgan_tpu.ops import linear as jlinear
from spgan_tpu.ops import modulated as jmod
from spgan_tpu.ops import spatial as jspatial
from spgan_tpu.ops import upfirdn as jup
from spgan_tpu.utils.misc import FileLock as JFileLock
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.compat.load import load_params_npz
from spgan_tpu_torch.compat.torch_import import (
    export_torch_style_state_dict, import_torch_discriminator,
    import_torch_generator)
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.geometry.coords import CoordsPartial
from spgan_tpu_torch.geometry.sphere_grid import sphere_patch_grid_presampled
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models import losses
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.models.latents import LatentSampler
from spgan_tpu_torch.ops import grid_sample as gs
from spgan_tpu_torch.ops import linear
from spgan_tpu_torch.ops import modulated as mod
from spgan_tpu_torch.ops import spatial
from spgan_tpu_torch.ops import upfirdn as up
from spgan_tpu_torch.tree import flatten
from spgan_tpu_torch.utils.misc import FileLock
from helpers.port_tiny import cpu_budget, jax_layout, narrow, tiny, \
    train_models


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    with cpu_budget():
        yield


def _rand(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _equal_trees(got, want):
    g, w = dict(flatten(got)), dict(flatten(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert torch.equal(g[k], w[k]), k


def _generators():
    """The tiny SS generator of tests/helpers/port_tiny.py, both packages,
    with ss_mapping and SS noise on so every key group is mapped."""
    out = []
    for C, G in ((JConfig, JGenerator), (Config, Generator)):
        cfg = tiny(C())
        cfg.train_params.ss_mapping = True
        cfg.train_params.ss_disable_noise = False
        out.append(narrow(G.from_config(cfg)))
    return out


# ------------------------------------------------------------- compat
def _d_state_dict(p):
    """The reference StyleGan2Discriminator state dict of the port's D
    params (its conv weights are OIHW and its linears (out, in), as the
    reference's)."""
    sd = {}

    def layer(prefix, lp, ci):
        sd[f"{prefix}.{ci}.weight"] = lp["conv"]["weight"]
        if "bias" in lp["conv"]:
            sd[f"{prefix}.{ci}.bias"] = lp["conv"]["bias"]
        if "act_bias" in lp:
            sd[f"{prefix}.{ci + 1}.bias"] = lp["act_bias"]

    layer("convs.0", p["stem"], 0)
    for i, b in enumerate(p["blocks"]):
        layer(f"convs.{i + 1}.conv1", b["conv1"], 0)
        layer(f"convs.{i + 1}.conv2", b["conv2"], 1)
        layer(f"convs.{i + 1}.skip", b["skip"], 1)
    layer("final_conv", p["final_conv"], 0)
    for name in ("final_linear", "coord_linear"):
        for i, lin in enumerate(p[name]):
            sd[f"{name}.{i}.weight"] = lin["weight"]
            sd[f"{name}.{i}.bias"] = lin["bias"]
    return {"module." + k: v for k, v in sd.items()}


def test_import_torch_discriminator_matches_jax():
    _, _, d = train_models(Config, Generator, Discriminator, 4)
    _, _, jd = train_models(JConfig, JGenerator, JDiscriminator, 4)
    params = d.init(torch.Generator().manual_seed(3), device="cpu")
    sd = _d_state_dict(params)
    got = import_torch_discriminator(sd, d, device="cpu")
    jparams = jti.import_torch_discriminator(sd, jd)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")
    _equal_trees(got, want)
    _equal_trees(got, params)


def test_export_torch_style_state_dict_round_trip():
    """The port's export equals JAX's on the same parameters, and the
    port's import of it gives the parameters back."""
    jg, g = _generators()
    params = g.init(torch.Generator().manual_seed(4), device="cpu")
    sd = export_torch_style_state_dict(params, g)
    want = jti.export_torch_style_state_dict(jax_layout(params), jg)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    back = import_torch_generator(
        {k: torch.tensor(v) for k, v in sd.items()}, g, device="cpu")
    _equal_trees(back, params)


def test_load_params_npz_matches_jax(tmp_path):
    jg, g = _generators()
    path = str(tmp_path / "g.npz")
    jp = jg.init(jax.random.PRNGKey(2))
    jload.save_params_npz(path, jp)
    template = g.init(torch.Generator().manual_seed(0), device="cpu")
    got = load_params_npz(path, template, device="cpu")
    want = jax.tree_util.tree_map(np.asarray,
                                  jload.load_params_npz(path, jp))
    _equal_trees(got, params_from_jax(want, device="cpu"))


@pytest.mark.parametrize("jax_pkg, pkg", [(jops_pkg, ops_pkg),
                                          (jcompat_pkg, compat_pkg)])
def test_package_exports_match_jax(jax_pkg, pkg):
    names = [n for n, v in vars(jax_pkg).items()
             if not n.startswith("_") and not inspect.ismodule(v)]
    assert names and [n for n in names if not hasattr(pkg, n)] == []


# ---------------------------------------------------------------- ops
@pytest.mark.parametrize("name, reduce_all", [
    ("l1_loss", False), ("l1_loss", True), ("l2_loss", False),
    ("l2_loss", True), ("grad_reduce", None)])
def test_losses_match_jax(name, reduce_all):
    a, b = _rand(0, 3, 4, 5, 2), _rand(1, 3, 4, 5, 2)
    if name == "grad_reduce":
        got = losses.grad_reduce(torch.tensor(a))
        want = jlosses.grad_reduce(jnp.asarray(a))
    else:
        got = getattr(losses, name)(torch.tensor(a), torch.tensor(b),
                                    reduce_all)
        want = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b),
                                      reduce_all)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_scaled_leaky_relu_matches_jax():
    x = _rand(2, 4, 7)
    for slope in (0.2, 0.01):
        _close(linear.scaled_leaky_relu(torch.tensor(x), slope),
               jlinear.scaled_leaky_relu(jnp.asarray(x), slope))


@pytest.mark.parametrize("kernel, pad", [
    ("1331", (2, 1)), ("121", (1, 1)), ("gauss5", (2, 2)), ("gauss4", (1, 2))])
def test_gaussian_kernel_and_blur_match_jax(kernel, pad):
    if kernel.startswith("gauss"):
        n = int(kernel[5:])
        k = up.gaussian_kernel(n, 1.5)
        np.testing.assert_array_equal(k, jup.gaussian_kernel(n, 1.5))
    else:
        k = up.make_kernel([float(c) for c in kernel])
    x = _rand(3, 2, 9, 8, 3)
    got = up.blur(torch.tensor(x), k.astype(np.float32), pad)
    want = jup.blur(jnp.asarray(x), jnp.asarray(k, jnp.float32), pad)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_constant_input_matches_jax():
    jspec = jmod.ConstantInput(channel=5, size=4)
    jp = jspec.init(jax.random.PRNGKey(0))
    got = mod.ConstantInput(channel=5, size=4).apply(
        params_from_jax(jp, device="cpu"), 3)
    _close(got, jspec.apply(jp, 3), 0)
    p = mod.ConstantInput(channel=5, size=4).init(
        torch.Generator().manual_seed(0))
    assert tuple(p["input"].shape) == jp["input"].shape == (1, 4, 4, 5)


@pytest.mark.parametrize("shared", [False, True])
def test_bilinear_grid_samplers_match_jax(shared):
    """Grids up to 1.2 beyond [-1, 1]: the border clamp too."""
    x = _rand(4, 2, 5, 6, 3)
    grid = _rand(5, *(() if shared else (2,)), 4, 7, 2, lo=-1.2, hi=1.2)
    fn = "bilinear_grid_sample_shared" if shared else "bilinear_grid_sample"
    got = getattr(gs, fn)(torch.tensor(x), torch.tensor(grid))
    want = getattr(jgs, fn)(jnp.asarray(x), jnp.asarray(grid))
    assert tuple(got.shape) == want.shape == (2, 4, 7, 3)
    _close(got, want)


@pytest.mark.parametrize("blur_len", [3, 4])
def test_spatial_size_helpers_match_jax(blur_len):
    ups = [True, False] * 4
    specs = [spatial.ConvSpec(upsample=u, blur_len=blur_len) for u in ups]
    jspecs = [jspatial.ConvSpec(upsample=u, blur_len=blur_len) for u in ups]
    for size in (11, 22, 101):
        assert (spatial.calc_out_spatial_size(specs, size)
                == jspatial.calc_out_spatial_size(jspecs, size))
        assert (spatial.calc_in_spatial_size(specs, size)
                == jspatial.calc_in_spatial_size(jspecs, size))


# ----------------------------------------------------------- geometry
def test_presampled_grids_match_jax_and_golden(golden):
    n = 0
    for key in golden.files:
        if not key.startswith("pre_") or key.endswith("_meta"):
            continue
        (pxs, pxe, pys, pye, circ, xt, yt, tflag, pmode,
         partial) = golden[key + "_meta"]
        args = (pxs, pxe, pys, pye, bool(circ),
                float(partial) if tflag else 0.8)
        kw = dict(full_shape=(59, 48), k=3, x_total=int(xt),
                  y_total=int(yt), pre_sample_mode=bool(pmode))
        got = sphere_patch_grid_presampled(*args, **kw)
        np.testing.assert_array_equal(got, jpresampled(*args, **kw))
        pat = golden[key]
        want = np.stack([pat[0, :, :, 1] / yt * 2 - 1,
                         pat[0, :, :, 0] / xt * 2 - 1], axis=-1)
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=key)
        n += 1
    assert n == 6


def test_coords_partial_of_a_plan_matches_jax():
    """LatticePlan.coords_partial (positions 3..9, each 2 times) and
    CoordsPartial.batch."""
    jg, g = _generators()
    jcp = jplan(jg, 128, 384).coords_partial(2, 3, 7, 0.6667)
    cp = build_close_loop_plan(g, 128, 384).coords_partial(2, 3, 7, 0.6667)
    assert cp.batch == jcp.batch == 14
    for f in ("p_x_st", "p_x_ed", "p_y_st", "p_y_ed", "circular"):
        np.testing.assert_array_equal(getattr(cp, f).numpy(),
                                      np.asarray(getattr(jcp, f)), err_msg=f)
    for f in ("x_total", "y_total", "grid_partial"):
        assert getattr(cp, f) == getattr(jcp, f)
    assert CoordsPartial.from_scalars(np.zeros((5, 5)), 45, 140,
                                      0.8).batch == 5


# ------------------------------------------------------- config, models
def test_config_helpers_match_jax():
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.train_params.ss_n_layers = 3
    assert cfg.train_params.ss_input_size == jcfg.train_params.ss_input_size
    assert cfg.train_params.ss_input_size == 11 + 2 * 9
    new = cfg.replace(exp_name="other", log_dir="elsewhere")
    jnew = jcfg.replace(exp_name="other", log_dir="elsewhere")
    assert (new.exp_name, new.log_dir) == (jnew.exp_name, jnew.log_dir)
    assert new.train_params is cfg.train_params and cfg.exp_name == "spgan"
    jg, g = _generators()
    assert g.ts.num_layers == jg.ts.num_layers == 8


def test_sample_circular_local_shape_and_device():
    """RNG streams differ between the packages: shapes only."""
    sampler = LatentSampler(global_dim=32, local_dim=16)
    jsampler = JLatentSampler(global_dim=32, local_dim=16)
    gen = torch.Generator().manual_seed(0)
    for pad, h in ((True, 5 + 24), (False, 5)):
        z = sampler.sample_circular_local(gen, 2, 42, 5, pad)
        want = jax.eval_shape(
            lambda k, p=pad: jsampler.sample_circular_local(k, 2, 42, 5, p),
            jax.random.PRNGKey(0))
        assert tuple(z.shape) == want.shape == (2, h, 42, 16)
        assert z.device.type == "cpu" and z.dtype == torch.float32


# --------------------------------------------------------------- utils
def _lock_story(cls, path):
    """What a lock shows: the lock file while held, none after, and a
    stale lock file taken over after the timeout."""
    seen = []
    with cls(path, timeout=0.05, poll=0.01) as lock:
        seen.append(os.path.exists(lock.lock_path))
    seen.append(os.path.exists(path + ".lock"))
    open(path + ".lock", "w").close()  # stale: its owner is gone
    with cls(path, timeout=0.05, poll=0.01):
        seen.append(os.path.exists(path + ".lock"))
    seen.append(os.path.exists(path + ".lock"))
    return seen


def test_file_lock_matches_jax(tmp_path):
    assert (_lock_story(FileLock, str(tmp_path / "a.log"))
            == _lock_story(JFileLock, str(tmp_path / "b.log"))
            == [True, False, True, False])
