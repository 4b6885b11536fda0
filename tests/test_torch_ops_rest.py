"""The JAX package's remaining ops and forward variants in the port,
against the JAX package on the CPU, float32, atol 1e-5 unless stated:
Downsample and the replicate-pad Blur (ops/upfirdn.py), the lrelu_plain
StyledConv and the spatially styled ModulatedConv2d (ops/modulated.py),
create_fusion_styles, Generator.get_to_rgb with the TS return_feats, the
nearest batch-shared grid sampler (ops/grid_sample.py) and the global-grid
sphere convs with their patterns (geometry/global_conv.py,
geometry/sphere_grid.py).  Parameters are drawn by the port and carried
to the JAX layout; every JAX function runs under jax.jit (one compile
each instead of one per primitive)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgan_tpu.config import Config as JConfig
from spgan_tpu.geometry import global_conv as jgc
from spgan_tpu.geometry import sphere_grid as jsg
from spgan_tpu.geometry.coords import CoordsPartial as JCoordsPartial
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.models.generator import create_fusion_styles as jfusion
from spgan_tpu.ops import modulated as jmod
from spgan_tpu.ops import upfirdn as jup
from spgan_tpu.ops.grid_sample import nearest_grid_sample_shared as jnearest
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.geometry import global_conv as gc
from spgan_tpu_torch.geometry import sphere_grid as sg
from spgan_tpu_torch.models.generator import Generator, create_fusion_styles
from spgan_tpu_torch.ops import modulated as mod
from spgan_tpu_torch.ops import upfirdn as up
from spgan_tpu_torch.ops.grid_sample import nearest_grid_sample_shared
from spgan_tpu_torch.tree import tree_map
from helpers.port_tiny import cpu_budget, jax_layout


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    with cpu_budget():
        yield


def _rand(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _jittered(params, seed):
    """Every leaf moved by N(0, 0.3): zero-init leaves (noise weights, the
    act bias) do not hide a wrong formula."""
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t + 0.3 * torch.randn(t.shape, generator=gen),
                    params)


@pytest.mark.parametrize("kernel, shape", [
    ((1.0, 3.0, 3.0, 1.0), (2, 12, 10, 5)), ((1.0, 3.0, 3.0, 1.0),
                                             (1, 11, 13, 3)),
    ((1.0, 2.0, 1.0), (1, 9, 8, 2))])
def test_downsample_matches_jax(kernel, shape):
    x = _rand(np.random.RandomState(0), *shape)
    want = jax.jit(jup.Downsample(kernel))(jnp.asarray(x))
    got = up.Downsample(kernel)(torch.tensor(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("kernel, pad, factor", [
    ((1.0, 2.0, 1.0), (1, 1), 1), ((1.0, 3.0, 3.0, 1.0), (2, 1), 1),
    ((1.0, 3.0, 3.0, 1.0), (1, 2, 0, 1), 2)])
def test_replicate_blur_matches_jax(kernel, pad, factor):
    x = _rand(np.random.RandomState(1), 2, 9, 11, 3)
    kw = dict(pad=pad, upsample_factor=factor, padding_mode="replicate")
    want = jax.jit(jup.Blur(kernel, **kw))(jnp.asarray(x))
    got = up.Blur(kernel, **kw)(torch.tensor(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def _conv_pair(**kw):
    return mod.ModulatedConv2d(**kw), jmod.ModulatedConv2d(**kw)


def test_lrelu_plain_styled_conv_matches_jax():
    """activation "lrelu_plain": LeakyReLU(0.01), no act bias, no gain."""
    rng = np.random.RandomState(2)
    conv, jconv = _conv_pair(in_ch=6, out_ch=5, kernel_size=3, style_dim=8,
                             no_zero_pad=True)
    spec = mod.StyledConv(conv=conv, activation="lrelu_plain")
    jspec = jmod.StyledConv(conv=jconv, activation="lrelu_plain")
    params = _jittered(spec.init(torch.Generator().manual_seed(0)), 1)
    assert "act_bias" not in params
    x, s, n = _rand(rng, 2, 9, 9, 6), _rand(rng, 2, 8), _rand(rng, 2, 7, 7, 1)
    want = jax.jit(jspec.apply)(jax_layout(params), jnp.asarray(x),
                                jnp.asarray(s), jnp.asarray(n))
    got = spec.apply(params, torch.tensor(x), torch.tensor(s),
                     torch.tensor(n))
    _close(got, want)
    assert float(got.min()) < 0


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, no_zero_pad=True),
    dict(kernel_size=3, no_zero_pad=False),
    dict(kernel_size=3, no_zero_pad=True, upsample=True),
    dict(kernel_size=1, no_zero_pad=True, demodulate=False)],
    ids=["nopad", "zeropad", "upsample", "torgb"])
def test_spatial_style_matches_jax(kw):
    """A (B,Hs,Ws,D) style map, larger than x by 2 (center-cropped), takes
    the spatial path through apply's ndim-4 dispatch."""
    rng = np.random.RandomState(3)
    conv, jconv = _conv_pair(in_ch=6, out_ch=4, style_dim=8, **kw)
    params = _jittered(conv.init(torch.Generator().manual_seed(1)), 2)
    x, style = _rand(rng, 2, 9, 9, 6), _rand(rng, 2, 11, 11, 8)
    want = jax.jit(jconv.apply)(jax_layout(params), jnp.asarray(x),
                                jnp.asarray(style))
    got = conv.apply(params, torch.tensor(x), torch.tensor(style))
    assert tuple(got.shape) == want.shape
    _close(got, want, atol=2e-5 if kw.get("upsample") else 1e-5)


def test_fusion_styles_match_jax():
    rng = np.random.RandomState(4)
    fmap = rng.rand(2, 3, 5, 7).astype(np.float32)
    styles = [_rand(rng, 2, 8) for _ in range(3)]
    want = jfusion(jnp.asarray(fmap), [jnp.asarray(s) for s in styles])
    got = create_fusion_styles(torch.tensor(fmap),
                               [torch.tensor(s) for s in styles])
    assert tuple(got.shape) == (2, 5, 7, 8)
    _close(got, want)


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 16
    tp.local_latent_dim = 8
    tp.channel_multiplier = 1
    tp.n_mlp = 1
    tp.ss_n_layers = 1
    return cfg


def test_get_to_rgb_matches_jax():
    """Generator.get_to_rgb (the RGB skip before and after each sphere
    skip conv, and the patch) on one training crop, the patch grids, TS
    noise maps; the port's per-layer list of styles gives the same."""
    g = Generator.from_config(_tiny(Config()))
    jg = JGenerator.from_config(_tiny(JConfig()))
    for gen in (g, jg):
        object.__setattr__(gen.ts, "channel_base", 24)
    params = _jittered(g.init(torch.Generator().manual_seed(0),
                              device="cpu"), 3)
    coords, _, cp = g.ss.coord_grid.sample_training(
        torch.Generator().manual_seed(5), 2)
    jcp = JCoordsPartial(*(jnp.asarray(getattr(cp, f).numpy()) for f in (
        "p_x_st", "p_x_ed", "p_y_st", "p_y_ed", "circular")),
        x_total=cp.x_total, y_total=cp.y_total, grid_partial=cp.grid_partial)
    rng = np.random.RandomState(5)
    zs = g.ss.coord_grid.ss_spatial_size
    gl = rng.randn(2, 2, 16).astype(np.float32)
    ll = rng.randn(2, zs, zs, 8).astype(np.float32)
    noises = [rng.randn(2, s, s, 1).astype(np.float32)
              for s in g.ts.stitch_geometry().outfeat_sizes]

    @jax.jit
    def jfeats(p, gl, ll, coords, noises):
        return jg.get_to_rgb(p, global_latent=gl, local_latent=ll,
                             coords=coords, cp=jcp, noises=noises)

    want = jfeats(jax_layout(params), gl, ll, coords.numpy(), noises)
    kw = dict(cp=cp, local_latent=torch.tensor(ll), coords=coords,
              noises=[torch.tensor(n) for n in noises])
    got = g.get_to_rgb(params, global_latent=torch.tensor(gl), **kw)
    assert set(got) == set(want) == {
        "to_rgb_3", "sphere_to_rgb_3", "to_rgb_5", "sphere_to_rgb_5",
        "to_rgb_7", "sphere_to_rgb_7", "patch"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k], atol=1e-4)
    styles = g.build_styles(params, torch.tensor(gl))
    listed = g.get_to_rgb(params, styles=[styles[:, i] for i in range(
        styles.shape[1])], global_latent=torch.tensor(gl), **kw)
    for k in want:
        assert torch.equal(listed[k], got[k]), k


def test_nearest_grid_sample_matches_jax():
    """Zeros outside [-1, 1], ties rounded half to even in both."""
    rng = np.random.RandomState(6)
    x = _rand(rng, 2, 7, 9, 3)
    grid = rng.uniform(-1.3, 1.3, (5, 11, 2)).astype(np.float32)
    # exact ties: gx = (g + 1) / 2 * 8 = k + 0.5 at g = k / 4 - 0.875
    grid[0, :, 0] = np.arange(11, dtype=np.float32) / 4 - 0.875
    want = jax.jit(jnearest)(jnp.asarray(x), jnp.asarray(grid))
    got = nearest_grid_sample_shared(torch.tensor(x), torch.tensor(grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).any()


@pytest.mark.parametrize("h, w, k, stride, upsample", [
    (8, 16, 3, 1, None), (8, 16, 3, 2, None), (10, 20, 3, 2, False),
    (8, 16, 3, 1, False), (8, 16, 3, 1, True)])
def test_global_sphere_convs_match_jax(h, w, k, stride, upsample):
    """The patterns (numpy, float64) are equal; the convs (nearest
    sampling, stride-k conv, bias) agree."""
    if upsample is None:
        want_pat = jsg.global_sphere_pattern(h, w, k, stride)
        pat = sg.global_sphere_pattern(h, w, k, stride)
        spec = gc.GlobalSphereConv2d(4, 5, k, stride)
        jspec = jgc.GlobalSphereConv2d(4, 5, k, stride)
    else:
        want_pat = jsg.incre_interval_pattern(h, w, k, stride, upsample)
        pat = sg.incre_interval_pattern(h, w, k, stride, upsample)
        spec = gc.IncreIntervalSphereConv2d(4, 5, k, stride,
                                            upsample=upsample)
        jspec = jgc.IncreIntervalSphereConv2d(4, 5, k, stride,
                                              upsample=upsample)
    np.testing.assert_array_equal(pat, want_pat)
    params = spec.init(torch.Generator().manual_seed(7))
    x = _rand(np.random.RandomState(8), 2, h, w, 4)
    want = jax.jit(jspec.apply)(jax_layout(params), jnp.asarray(x))
    got = spec.apply(params, torch.tensor(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)
