"""The generator options of the port against the JAX package on the CPU:
SS noise (ss_disable_noise false) and ss_mapping in one patch forward and
in the close-loop engine, the coordinate encodings of every coord_num_dir,
the raises where JAX raises, and SS noise / SS mapping weights through
the torch checkpoint import and the .npz export.

Tiny widths (channel_base 48, 1 SS layer, 1 mapping layer); the noise
weights, zero at init, are set to 0.5 so the noise maps show.  Renders
agree to float32 summation-order noise (atol 2e-4, as the JAX package's
engine tests use), with the close-loop wrap columns bit-identical;
coordinate encodings at 1e-6; weights exactly."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.compat.load import load_params_npz as jax_load_npz
from spgan_tpu.compat.torch_import import (export_torch_style_state_dict,
                                           import_torch_generator as
                                           jax_import_torch_generator)
from spgan_tpu.config import Config as JConfig
from spgan_tpu.data.pipeline import PatchCropper as JCropper
from spgan_tpu.geometry import coords as jcoords
from spgan_tpu.geometry.coords import CoordsPartial as JCP
from spgan_tpu.infer.engine import PanoramaEngine as JEngine
from spgan_tpu.infer.stitcher import build_close_loop_plan as jplan
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu_torch.compat.from_jax import params_from_jax, params_to_jax
from spgan_tpu_torch.compat.load import load_generator_params, save_params_npz
from spgan_tpu_torch.compat.torch_import import import_torch_generator
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.data.pipeline import PatchCropper
from spgan_tpu_torch.geometry import coords
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.models.latents import LatentSampler
from spgan_tpu_torch.ops.spatial import out_size_chain
from spgan_tpu_torch.tree import flatten


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads (several test processes run side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 1
    tp.ss_n_layers = 1
    tp.ss_disable_noise = False
    tp.ss_mapping = True
    return cfg


@pytest.fixture(scope="module")
def models():
    """The SS-noise + ss_mapping generator in both packages with the same
    weights (drawn by the port's init, whose tree test_from_config_takes_
    the_ss_options holds against JAX's; JAX's init compiles for seconds),
    noise weights set to 0.5."""
    jg = JGenerator.from_config(_tiny(JConfig()))
    g = Generator.from_config(_tiny(Config()))
    for m in (jg, g):
        object.__setattr__(m.ts, "channel_base", 48)
    jparams = params_to_jax(g.init(torch.Generator().manual_seed(0),
                                   device="cpu"))
    for blk in jparams["ss"]["blocks"]:
        blk["planar"]["noise"]["weight"] = np.float32(0.5)
    for conv in jparams["ts"]["convs"]:
        conv["noise"]["weight"] = np.float32(0.5)
    assert len(jparams["ss"]["mapping"]) == 8
    return jg, jparams, g, params_from_jax(jparams, device="cpu")


def test_from_config_takes_the_ss_options(models):
    """The port's init has JAX's tree and shapes (in the JAX layout): a
    noise weight per SS planar conv and the 8-layer SS mapping."""
    jg, jparams, g, params = models
    want = jax.eval_shape(jg.init, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in flatten(jparams)} == \
        {k: tuple(v.shape) for k, v in flatten(want)}
    assert g.ss.noise_sizes(35) == jg.ss.noise_sizes(35) == [29]


def test_ss_noise_and_mapping_forward_matches_jax(models):
    """One patch forward (JAX's SS fed explicit noise maps, then its TS)
    at training crops, one of them wrapping."""
    jg, jparams, g, params = models
    grid = g.ss.coord_grid
    B, win = 3, grid.ss_spatial_size              # 17: one SS layer
    rng = np.random.RandomState(0)
    x_st, y_st = np.array([0, 4, 9]), np.array([3, 30, 60])   # 60 wraps
    crops, _, cp = grid.training_crops(torch.tensor(x_st), torch.tensor(y_st),
                                       torch.zeros(3))
    gl = rng.randn(B, 2, 32).astype(np.float32)
    gl[:, 1] = gl[:, 0]
    z = rng.randn(B, win, win, 16).astype(np.float32)
    noises = [rng.randn(B, s, s, 1).astype(np.float32)
              for s in out_size_chain(g.ts.conv_specs_spatial(), 11)]
    ss_noises = [rng.randn(B, s, s, 1).astype(np.float32)
                 for s in g.ss.noise_sizes(win)]
    jcp = JCP(p_x_st=cp.p_x_st.numpy(), p_x_ed=cp.p_x_ed.numpy(),
              p_y_st=cp.p_y_st.numpy(), p_y_ed=cp.p_y_ed.numpy(),
              circular=cp.circular.numpy(), x_total=grid.size_x,
              y_total=grid.size_y, grid_partial=0.8)

    @jax.jit
    def fwd(p, gl, z, c, cp, n, ssn):
        s = jg.ss.apply(p["ss"], gl[:, 0], z, c, cp, noises=ssn)
        return jg.ts.synthesize(p["ts"], s, jg.build_styles(p, gl, None), cp,
                                noises=n)

    want = np.asarray(fwd(jparams, gl, z, crops.numpy(), jcp, noises,
                          ss_noises))
    got = g.apply(params, global_latent=torch.tensor(gl),
                  local_latent=torch.tensor(z), coords=crops, cp=cp,
                  noises=[torch.tensor(n) for n in noises],
                  ss_noises=[torch.tensor(n) for n in ss_noises])["gen"]
    assert tuple(got.shape) == want.shape == (B, 101, 101, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    # the maps reach the image: without them it differs
    bare = g.apply(params, global_latent=torch.tensor(gl),
                   local_latent=torch.tensor(z), coords=crops, cp=cp,
                   noises=[torch.tensor(n) for n in noises])["gen"]
    assert float((bare - got).abs().max()) > 1e-3


@pytest.mark.parametrize("mult", [2, 4])
def test_ext_forward_matches_jax(models, mult):
    """The extrapolated image grids' forward (a local latent mult times
    wider on extrapolated crops) in ss_tables_mode "grid" equals JAX's
    forward without tables: the structure latent at atol 2e-4, the image
    at 5e-5 of its largest value (2e-4 of the ~4 the 101-pixel renders
    reach; these reach ~18, and their float32 noise grows with them).  The
    row-offset tables do not
    describe those windows: there the sample-mode SS is far from JAX's."""
    jg, jparams, g, params = models
    grid = g.ss.coord_grid
    size = LatentSampler().local_shape(mult)[0]
    crops, _, cp = grid.sample_training_extrap(
        torch.Generator().manual_seed(mult), 2, size)
    rng = np.random.RandomState(mult)
    gl = rng.randn(2, 2, 32).astype(np.float32)
    z = rng.randn(2, size, size, 16).astype(np.float32)
    ss_noises = [rng.randn(2, s, s, 1).astype(np.float32)
                 for s in g.ss.noise_sizes(size)]
    noises = [rng.randn(2, s, s, 1).astype(np.float32)
              for s in out_size_chain(g.ts.conv_specs_spatial(),
                                      g.ss.noise_sizes(size)[-1])]
    jcp = JCP(p_x_st=cp.p_x_st.numpy(), p_x_ed=cp.p_x_ed.numpy(),
              p_y_st=cp.p_y_st.numpy(), p_y_ed=cp.p_y_ed.numpy(),
              circular=cp.circular.numpy(), x_total=grid.size_x,
              y_total=grid.size_y, grid_partial=cp.grid_partial)

    @jax.jit
    def fwd(p, gl, z, c, cp, n, ssn):
        s = jg.ss.apply(p["ss"], gl[:, 0], z, c, cp, noises=ssn)
        return s, jg.ts.synthesize(p["ts"], s, jg.build_styles(p, gl, None),
                                   cp, noises=n)

    want_ss, want = map(np.asarray, fwd(jparams, gl, z, crops.numpy(), jcp,
                                        noises, ss_noises))
    out = g.apply(params, global_latent=torch.tensor(gl),
                  local_latent=torch.tensor(z), coords=crops, cp=cp,
                  noises=[torch.tensor(n) for n in noises],
                  ss_noises=[torch.tensor(n) for n in ss_noises],
                  ss_tables_mode="grid")
    got = out["gen"].numpy()
    assert got.shape == want.shape and got.shape[1] > 101 * mult
    np.testing.assert_allclose(out["structure_latent"].numpy(), want_ss,
                               atol=2e-4)
    np.testing.assert_allclose(got, want, atol=5e-5 * np.abs(want).max())
    sampled = g.ss.apply(params["ss"], torch.tensor(gl[:, 0]),
                         torch.tensor(z), crops, None,
                         g.ss.train_tables(cp, size), tables_mode="sample",
                         noises=[torch.tensor(n) for n in ss_noises])
    assert np.abs(sampled.numpy() - want_ss).max() > 1e-2


@pytest.mark.heavy
def test_close_loop_with_ss_noise_matches_jax(models):
    """The engine appends one SS map per planar conv after the TS noise
    fields and hands every patch of a panorama the same map: the meta
    image equals JAX's, and the wrap columns equal their base columns bit
    for bit."""
    jg, jparams, g, params = models
    jeng = JEngine(g=jg, plan=jplan(jg, 128, 672), batch=2, patch_chunk=4,
                   grid_partial=0.6667, use_pallas=False, use_skip_tables=True)
    gl, z, noises = (np.asarray(v) if not isinstance(v, list)
                     else [np.asarray(n) for n in v]
                     for v in jeng.sample_fields(jax.random.PRNGKey(3)))
    assert len(noises) == len(jeng.plan.noise_sizes) + 1
    want = np.asarray(jeng.generate_from_fields(jparams, gl, z, noises))

    plan = build_close_loop_plan(g, 128, 672)
    fields = (torch.tensor(gl), torch.tensor(z),
              [torch.tensor(n) for n in noises])
    eng = PanoramaEngine(g=g, plan=plan, batch=2, patch_chunk=4,
                         grid_partial=0.6667, device="cpu")
    got = eng.generate_from_fields(params, *fields)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    full = PanoramaEngine(g=g, plan=plan, batch=2, patch_chunk=4,
                          grid_partial=0.6667, dedup_wrap=False, device="cpu")
    patches = full.generate_patches(params, *fields).reshape(
        plan.num_steps_h, plan.num_steps_w, 2, 101, 101, 3)
    nwm = plan.num_steps_w_min
    for j in range(nwm, plan.num_steps_w):
        assert torch.equal(patches[:, j], patches[:, j - nwm])
    assert torch.equal(full.generate_from_fields(params, *fields), got)
    sampled = eng.sample_fields(torch.Generator().manual_seed(0))[2]
    assert [tuple(n.shape) for n in sampled] == [n.shape for n in noises]


@pytest.mark.parametrize("num_dir", [1, 2, 3, 4, 5, 21])
def test_encode_coords_matches_jax(num_dir):
    rng = np.random.RandomState(num_dir)
    c = rng.uniform(-3, 3, (2, 5, 7, num_dir)).astype(np.float32)
    want = np.asarray(jcoords.encode_coords(jnp.asarray(c), num_dir))
    got = coords.encode_coords(torch.tensor(c), num_dir).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_base_grid_num_dir_1_matches_jax():
    jg = jcoords.CoordGrid(num_dir=1)
    g = coords.CoordGrid(num_dir=1)
    for args in ((), (20, 57)):
        want = jg.base_grid(*args)
        got = g.base_grid(*args)
        assert got.shape == want.shape and got.shape[-1] == 1
        np.testing.assert_allclose(got, want, atol=1e-6)


def _raises(fn):
    try:
        fn()
    except NotImplementedError:
        return True
    return False


@pytest.mark.parametrize("case", ["encode6", "grid2", "perturb1",
                                  "sample1", "cropper1"])
def test_num_dir_raises_where_jax_raises(case):
    """encode_coords beyond its branches, base_grid beyond 1 and 3, and the
    training draws (perturb_ranges) and the patch cropper beyond 3."""
    def run(mod, cropper):
        if case == "encode6":
            return lambda: mod.encode_coords(
                (jnp if mod is jcoords else torch).zeros((1, 6)), 6)
        if case == "grid2":
            return lambda: mod.CoordGrid(num_dir=2).base_grid()
        if case == "perturb1":
            return lambda: mod.CoordGrid(num_dir=1).perturb_ranges()
        if case == "sample1":
            if mod is jcoords:
                return lambda: mod.CoordGrid(num_dir=1).sample_training(
                    jax.random.PRNGKey(0), 2)
            return lambda: mod.CoordGrid(num_dir=1).sample_training(
                torch.Generator().manual_seed(0), 2)
        img = np.zeros((197, 197, 3), np.uint8)
        return lambda: cropper(197, 101, 1)(img, np.random.RandomState(0))

    assert _raises(run(jcoords, JCropper))
    assert _raises(run(coords, PatchCropper))


def test_ss_weights_through_torch_import_and_npz(models, tmp_path):
    """A reference state dict with SS noise and global_mapping weights
    imports as JAX imports it, and the .npz export round-trips through the
    JAX package's loader."""
    jg, jparams, g, params = models
    sd = export_torch_style_state_dict(jparams, jg)
    assert any(".conv.noise.weight" in k and "structure" in k for k in sd)
    assert any("global_mapping.8.weight" in k for k in sd)
    got = import_torch_generator(sd, g, device="cpu")
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_import_torch_generator(sd, jg)), device="cpu")
    fg, fw = dict(flatten(got)), dict(flatten(want))
    assert fg.keys() == fw.keys() == dict(flatten(params)).keys()
    assert all(torch.equal(fg[k], fw[k]) for k in fg)
    assert float(got["ss"]["blocks"][0]["planar"]["noise"]["weight"]) == 0.5

    path = str(tmp_path / "g.npz")
    save_params_npz(path, got)
    back = load_generator_params(path, g, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(back), flatten(got)))
    jback = jax_load_npz(path, jax.eval_shape(jg.init, jax.random.PRNGKey(0)))
    for (k, a), (_, b) in zip(
            sorted(flatten(jax.tree_util.tree_map(np.asarray, jback))),
            sorted(flatten(jparams))):
        np.testing.assert_array_equal(a, b, err_msg=k)
