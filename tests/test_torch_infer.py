"""The port's inference surface (spgan_tpu_torch/infer, compat, utils)
against the JAX package on the CPU, at the tiny config of
tests/test_torch_engine.py (channel_base 48, 2 SS layers): the planar
lattice plan, the planar engine, TestingVars files and edits, regenerate,
calibration, FLOPs, PNG files and checkpoint loading.

Float32 renders agree to summation-order noise (atol 2e-4, as the JAX
package's engine tests use); plans, files, FLOPs and imported weights are
compared exactly."""
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from spgan_tpu.compat.load import save_params_npz as jax_save_params_npz
from spgan_tpu.compat.torch_import import export_torch_style_state_dict
from spgan_tpu.config import Config as JConfig
from spgan_tpu.infer import calibrate as jcal
from spgan_tpu.infer.engine import PanoramaEngine as JEngine
from spgan_tpu.infer.managers import InfiniteGenerationManager as JInfinite
from spgan_tpu.infer.managers import save_image_batch as jax_save_images
from spgan_tpu.infer.stitcher import build_close_loop_plan as jax_cl_plan
from spgan_tpu.infer.stitcher import build_infinite_plan as jax_inf_plan
from spgan_tpu.infer.testing_vars import TestingVars as JVars
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.ops.spatial import ConvSpec as JConvSpec
from spgan_tpu.utils.flops import generator_flops as jax_flops
from spgan_tpu.utils.flops import pretty as jax_pretty
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.compat.load import flatten, load_generator_params
from spgan_tpu_torch.compat.torch_import import import_torch_generator
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.infer import calibrate as cal
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.managers import (InfiniteGenerationManager,
                                            save_image_batch)
from spgan_tpu_torch.infer.stitcher import (build_close_loop_plan,
                                            build_infinite_plan)
from spgan_tpu_torch.infer.testing_vars import TestingVars
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.ops.spatial import ConvSpec
from spgan_tpu_torch.tree import tree_leaves
from spgan_tpu_torch.utils.flops import generator_flops, pretty


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and a process per core's worth of spinning threads each slows
    them all several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PLANAR_HW = (128, 200)   # 4 x 5 lattice, meta 389 x 485


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.ss_n_layers = 2
    return cfg


def _narrow(g):
    object.__setattr__(g.ts, "channel_base", 48)
    return g


def _jax_layout(node, name=""):
    """The port's parameter tree in the JAX package's layout (numpy, conv
    weights HWIO, linear weights (in, out)): params_from_jax's inverse."""
    if isinstance(node, dict):
        return {k: _jax_layout(v, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_jax_layout(v, name) for v in node]
    a = node.numpy()
    if name == "weight" and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if name == "weight" and a.ndim == 2 else a


@pytest.fixture(scope="module")
def tiny():
    """The tiny generator in both packages, with the same weights (drawn
    by the port's init: JAX's compiles for seconds on the CPU)."""
    g = _narrow(Generator.from_config(_tiny(Config())))
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    jparams = _jax_layout(params)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params_from_jax(jparams, device="cpu")),
        tree_leaves(params)))
    return {"jg": _narrow(JGenerator.from_config(_tiny(JConfig()))),
            "jparams": jparams, "g": g, "params": params}


def _fields(seed, plan, batch, global_dim, local_dim):
    rng = np.random.RandomState(seed)
    gl = rng.randn(batch, 2, global_dim).astype(np.float32)
    gl[:, 1] = gl[:, 0]
    z = rng.randn(batch, plan.z_field_h, plan.z_field_w,
                  local_dim).astype(np.float32)
    noises = [rng.randn(batch, h, w, 1).astype(np.float32)
              for h, w in plan.noise_sizes]
    return gl, z, noises


def _assert_plans_equal(plan, want):
    for f in ("close_loop", "target_h", "target_w", "meta_h", "meta_w",
              "num_steps_h", "num_steps_w", "num_steps_w_min", "window",
              "z_field_h", "z_field_w", "x_total", "y_total", "noise_sizes"):
        assert getattr(plan, f) == getattr(want, f), f
    assert plan.geom == want.geom or vars(plan.geom) == vars(want.geom)
    for f in ("z_starts", "img_starts", "cp_scalars"):
        a, b = getattr(plan, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert len(plan.noise_starts) == len(want.noise_starts)
    for a, b in zip(plan.noise_starts, want.noise_starts):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(256, 512), (384, 768), (101, 101),
                                  (300, 1000)])
def test_infinite_plan_matches_jax(size):
    plan = build_infinite_plan(Generator.from_config(Config()), *size)
    want = jax_inf_plan(JGenerator.from_config(JConfig()), *size)
    _assert_plans_equal(plan, want)
    assert not plan.close_loop and plan.cp_scalars[:, 4].max() == 0.0


def test_infinite_plan_shipped_task_lattice():
    """configs/test/spgan_infinite_256x512.yaml: a 5 x 8 lattice, so 40
    positions = 10 chunks of 4 -> 40 grouped sphere-conv launches over the
    4 SS layers per batch."""
    plan = build_infinite_plan(Generator.from_config(Config()), 256, 512)
    assert (plan.num_steps_h, plan.num_steps_w, plan.meta_h, plan.meta_w) == (
        5, 8, 485, 773)
    assert plan.num_patches == 40


def test_tiny_infinite_plan_matches_jax(tiny):
    _assert_plans_equal(build_infinite_plan(tiny["g"], *PLANAR_HW),
                        jax_inf_plan(tiny["jg"], *PLANAR_HW))


@pytest.fixture(scope="module")
def planar(tiny):
    """The tiny planar engine in both packages on the same weights and
    fields.  JAX runs its kernel path (the Pallas sphere kernel in
    interpret mode, skip tables), the path B1 ports: its grid path
    mirrors the last lattice column of a planar plan
    (test_jax_grid_path_mirrors_the_last_planar_column)."""
    jeng = JEngine(g=tiny["jg"], plan=jax_inf_plan(tiny["jg"], *PLANAR_HW),
                   batch=2, patch_chunk=4, grid_partial=0.6667,
                   use_pallas=True, use_skip_tables=True)
    eng = PanoramaEngine(g=tiny["g"],
                         plan=build_infinite_plan(tiny["g"], *PLANAR_HW),
                         batch=2, patch_chunk=4, grid_partial=0.6667,
                         device="cpu")
    fields = _fields(3, eng.plan, 2, 32, 16)
    want = np.asarray(jeng.generate_from_fields(tiny["jparams"], *fields))
    return {"jeng": jeng, "eng": eng, "fields": fields, "want": want}


def _torch(fields):
    gl, z, noises = fields
    return torch.tensor(gl), torch.tensor(z), [torch.tensor(n) for n in noises]


@pytest.mark.heavy
def test_planar_meta_matches_jax(tiny, planar):
    eng, jeng = planar["eng"], planar["jeng"]
    assert eng._skip_margins == jeng._skip_margins
    assert len(eng._render_idx) == eng.plan.num_patches == 20
    got = eng.generate_from_fields(tiny["params"], *_torch(planar["fields"]))
    want = planar["want"]
    assert tuple(got.shape) == want.shape == (2, 389, 485, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    crop = eng.crop_to_target(got)
    assert tuple(crop.shape) == (2, *PLANAR_HW, 3)
    np.testing.assert_array_equal(
        crop.numpy(), np.asarray(jeng.crop_to_target(got.numpy())))


def test_planar_fields_are_not_padded(tiny):
    """A planar plan reads its fields as they are: the last lattice column
    reads the last z columns, and no patch write wraps."""
    plan = build_infinite_plan(tiny["g"], *PLANAR_HW)
    last = plan.z_starts[:, 1].max() + plan.window
    assert last == plan.z_field_w
    assert (plan.img_starts[:, 1] + plan.geom.outfeat_sizes[-1]).max() == \
        plan.meta_w


def test_jax_grid_path_mirrors_the_last_planar_column(tiny):
    """A difference between the JAX package's two sphere-conv paths that
    the port does not carry over: a planar plan's last column has
    p_y_ed = (z_field_w + 1) / z_field_w > 1 with the circular flag off,
    so sphere_patch_grid wraps y_ed to 2*pi / z_field_w, below y_st, and
    its min-max-normalized longitudes run backwards (a mirrored patch).
    The offset tables (the Pallas kernel's path, and the port's) do not
    read p_y and sample that column like every other."""
    from spgan_tpu.geometry.sphere_grid import sphere_patch_grid

    plan = jax_inf_plan(tiny["jg"], *PLANAR_HW)
    cps = plan.cp_scalars.reshape(plan.num_steps_h, plan.num_steps_w, 5)
    assert (cps[:, -1, 3] > 1).all() and (cps[:, :-1, 3] <= 1).all()

    def gx_row(cp):
        grid = sphere_patch_grid(*cp, 0.6667, h=23, w=23, k=3,
                                 x_total=plan.x_total, y_total=plan.y_total)
        return np.asarray(grid)[34, ::3, 0]   # gx along a middle tap row

    assert np.all(np.diff(gx_row(cps[1, 0])) > 0)
    assert np.all(np.diff(gx_row(cps[1, -1])) < 0)


@pytest.mark.heavy
def test_regenerate_with_selection_map_matches_jax(tiny, planar):
    jm = JInfinite(g=tiny["jg"], params_ema=tiny["jparams"], config=JConfig())
    jm.engine = planar["jeng"]
    m = InfiniteGenerationManager(g=tiny["g"], params_ema=tiny["params"],
                                  config=Config(), device="cpu")
    m.engine = planar["eng"]
    gl, z, noises = planar["fields"]
    coords = m.engine._coords_field.numpy()
    jv = JVars(meta_img=None, global_latent=gl.copy(), local_latent=z.copy(),
               meta_coords=coords, noises=[n.copy() for n in noises])
    tv = TestingVars(meta_img=None, global_latent=gl.copy(),
                     local_latent=z.copy(), meta_coords=coords,
                     noises=[n.copy() for n in noises])
    np.testing.assert_allclose(m.generate_with_vars(tv),
                               jm.generate_with_vars(jv), atol=2e-4)
    rng = np.random.RandomState(9)
    new_z = rng.randn(*z.shape).astype(np.float32)
    sel = np.zeros(z.shape[1:3])
    sel[2:6, 3:9] = 1
    for v in (tv, jv):
        v.update_local_latent(new_z, sel)
    before, jbefore = tv.meta_img.copy(), np.array(jv.meta_img)
    got = m.regenerate(tv, update_by_ss_map=sel)
    want = jm.regenerate(jv, update_by_ss_map=sel)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the selection reaches the windows of lattice row 0, columns 0-1
    # only: those patches are written again, every other pixel keeps its
    # value bit for bit
    patch = m.engine.plan.geom.outfeat_sizes[-1]
    cols = m.engine.plan.geom.pixelspace_step + patch
    for new, old in ((got, before), (want, jbefore)):
        assert not np.array_equal(new[:, :patch, :cols], old[:, :patch, :cols])
        np.testing.assert_array_equal(new[:, patch:], old[:, patch:])
        np.testing.assert_array_equal(new[:, :, cols:], old[:, :, cols:])


def _random_vars(cls, rng, with_optional):
    return cls(
        meta_img=(rng.randn(2, 12, 20, 3).astype(np.float32)
                  if with_optional else None),
        global_latent=rng.randn(2, 2, 8).astype(np.float32),
        local_latent=rng.randn(2, 10, 16, 4).astype(np.float32),
        meta_coords=rng.randn(10, 16, 3).astype(np.float32),
        noises=[rng.randn(2, s, s + 2, 1).astype(np.float32)
                for s in (5, 7, 9)],
        styles=(rng.randn(2, 9, 8).astype(np.float32)
                if with_optional else None))


def _assert_vars_equal(a, b):
    for f in ("meta_img", "global_latent", "local_latent", "meta_coords",
              "styles"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y)
    assert len(a.noises) == len(b.noises)
    for x, y in zip(a.noises, b.noises):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("with_optional", [False, True])
def test_testing_vars_files_load_in_both_packages(tmp_path, with_optional):
    rng = np.random.RandomState(int(with_optional))
    port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    _random_vars(TestingVars, rng, with_optional).save(port_file)
    _assert_vars_equal(JVars.load(port_file), TestingVars.load(port_file))
    _random_vars(JVars, rng, with_optional).save(jax_file)
    _assert_vars_equal(TestingVars.load(jax_file), JVars.load(jax_file))
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)


@pytest.mark.parametrize("close_loop", [True, False])
def test_testing_vars_edits_match_jax(close_loop):
    g, jg = Generator.from_config(Config()), JGenerator.from_config(JConfig())
    size = (384, 768) if close_loop else (256, 512)
    plan = (build_close_loop_plan if close_loop else build_infinite_plan)(
        g, *size)
    jplan = (jax_cl_plan if close_loop else jax_inf_plan)(jg, *size)
    rng = np.random.RandomState(4)
    base = dict(
        meta_img=None, global_latent=rng.randn(2, 2, 8).astype(np.float32),
        local_latent=rng.randn(2, plan.z_field_h, plan.z_field_w,
                               4).astype(np.float32),
        meta_coords=np.zeros((plan.z_field_h, plan.z_field_w, 3), np.float32),
        noises=[rng.randn(2, h, w, 1).astype(np.float32)
                for h, w in plan.noise_sizes])

    def copy():
        return {k: ([n.copy() for n in v] if isinstance(v, list) else
                    (None if v is None else v.copy())) for k, v in base.items()}

    tv, jv = TestingVars(**copy()), JVars(**copy())
    new_gl = rng.randn(2, 2, 8).astype(np.float32)
    new_z = rng.randn(*base["local_latent"].shape).astype(np.float32)
    sel = (rng.rand(plan.z_field_h, plan.z_field_w) > 0.5).astype(np.float32)
    new_n = [rng.randn(*n.shape).astype(np.float32) for n in base["noises"]]
    sels = [(rng.rand(*n.shape[1:3]) > 0.5) for n in base["noises"]]
    records = [{"local_latent": rng.randn(11, 11, 4).astype(np.float32),
                "noises": [rng.randn(s, s, 1).astype(np.float32)
                           for s in plan.geom.outfeat_sizes[:4]],
                "global_latent": rng.randn(2, 8).astype(np.float32)},
               {"local_latent": rng.randn(7, 9, 4).astype(np.float32)}]
    for v, p in ((tv, plan), (jv, jplan)):
        v.update_global_latent(new_gl)
        v.update_local_latent(new_z, sel)
        v.update_noises(new_n, sels)
        v.replace_by_records(p, records, [0.02, 0.7], batch_index=1)
    _assert_vars_equal(tv, jv)
    tv.update_local_latent(new_z * 2)
    jv.update_local_latent(new_z * 2)
    tv.update_noises(new_n[::-1])
    jv.update_noises(new_n[::-1])
    _assert_vars_equal(tv, jv)


def test_calibrate_matches_jax():
    specs = [True, False] * 4      # the TS chain 11 -> 101
    rng = np.random.RandomState(0)
    x = rng.randn(2, 101, 101, 3).astype(np.float32)
    feats, pins = cal.calibrate_backward([ConvSpec(upsample=u) for u in specs],
                                         torch.tensor(x), pin_loc=(50, 47))
    jfeats, jpins = jcal.calibrate_backward(
        [JConvSpec(upsample=u) for u in specs], jax.numpy.asarray(x),
        pin_loc=(50, 47))
    assert pins == jpins
    assert [tuple(f.shape) for f in feats] == [f.shape for f in jfeats]
    for a, b in zip(feats, jfeats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    z = rng.randn(1, 11, 11, 8).astype(np.float32)
    feats, pins = cal.calibrate_backward_ss(4, 3, torch.tensor(z), (5, 6))
    jfeats, jpins = jcal.calibrate_backward_ss(4, 3, jax.numpy.asarray(z),
                                               (5, 6))
    assert pins == jpins and len(feats) == len(jfeats) == 8
    for a, b in zip(feats, jfeats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for n in (1, 2, 11, 13, 17, 19, 29, 31, 53, 55, 103, 105, 199, 352):
        np.testing.assert_array_equal(cal._unit_linspace(n, "cpu").numpy(),
                                      np.asarray(jax.numpy.linspace(-1.0, 1.0,
                                                                    n)))
    y = rng.randn(2, 7, 9, 3).astype(np.float32)
    np.testing.assert_allclose(
        cal.resize_align_corners(torch.tensor(y), 13, 17).numpy(),
        np.asarray(jcal.resize_align_corners(jax.numpy.asarray(y), 13, 17)),
        atol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "shipped"])
def test_generator_flops_match_jax(tiny, which):
    if which == "tiny":
        g, jg = tiny["g"], tiny["jg"]
    else:
        g, jg = (Generator.from_config(Config()),
                 JGenerator.from_config(JConfig()))
    for batch in (1, 16):
        assert generator_flops(g, batch) == jax_flops(jg, batch)
    for v in generator_flops(g).values():
        assert pretty(v) == jax_pretty(v) and pretty(v * 60) == jax_pretty(v * 60)


def test_pngs_decode_to_jax_pngs(tmp_path):
    rng = np.random.RandomState(5)
    imgs = rng.uniform(-1.3, 1.3, (3, 17, 29, 3)).astype(np.float32)
    imgs[0, 0, :4, 0] = [-1.0, 1.0, 0.0, np.nextafter(np.float32(-1), 0)]
    got = save_image_batch(imgs, str(tmp_path / "port"), 7, suffix="full")
    want = jax_save_images(imgs, str(tmp_path / "jax"), 7, suffix="full")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        ["000007full.png", "000008full.png", "000009full.png"]
    for a, b in zip(got, want):
        pa, pb = Image.open(a), Image.open(b)
        assert pa.mode == pb.mode == "RGB" and pa.size == pb.size == (29, 17)
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


def _assert_trees_equal(a, b):
    fa, fb = dict(flatten(a)), dict(flatten(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("prefix", ["", "module."])
def test_import_torch_generator_matches_params_from_jax(tiny, prefix):
    sd = {prefix + k: torch.tensor(v) for k, v in
          export_torch_style_state_dict(tiny["jparams"], tiny["jg"]).items()}
    _assert_trees_equal(import_torch_generator(sd, tiny["g"], device="cpu"),
                        tiny["params"])


@pytest.mark.parametrize("suffix", [".npz", ".ckpt", ".pth.tar"])
def test_load_generator_params_files(tiny, tmp_path, suffix):
    path = str(tmp_path / f"g{suffix}")
    if suffix == ".npz":
        jax_save_params_npz(path, tiny["jparams"])
    else:
        sd = export_torch_style_state_dict(tiny["jparams"], tiny["jg"])
        torch.save({"g_ema": {"module." + k: torch.tensor(v)
                              for k, v in sd.items()}, "iter": 3}, path)
    _assert_trees_equal(load_generator_params(path, tiny["g"], device="cpu"),
                        tiny["params"])


def test_load_generator_params_rejects(tiny, tmp_path):
    flat = dict(flatten(tiny["jparams"]))
    missing = str(tmp_path / "missing.npz")
    np.savez(missing, **{k: v for k, v in list(flat.items())[1:]})
    with pytest.raises(ValueError, match="missing"):
        load_generator_params(missing, tiny["g"], device="cpu")
    extra = str(tmp_path / "extra.npz")
    np.savez(extra, **flat, **{"ts/extra/weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        load_generator_params(extra, tiny["g"], device="cpu")
    wide = str(tmp_path / "wide.npz")
    jax_save_params_npz(wide, tiny["jparams"])
    with pytest.raises(ValueError, match="shapes"):
        load_generator_params(wide, Generator.from_config(_tiny(Config())),
                              device="cpu")
    with pytest.raises(ValueError, match="save_params_npz"):
        load_generator_params(str(tmp_path), tiny["g"], device="cpu")
    # SS noise weights in a checkpoint are imported (as JAX imports them),
    # so a generator without SS noise rejects the file's extra key
    sd = export_torch_style_state_dict(tiny["jparams"], tiny["jg"])
    sd["structure_synthesizer.implicit_model.conv_stack.1.conv.noise.weight"] \
        = np.full(1, 0.25, np.float32)
    got = import_torch_generator(sd, tiny["g"], device="cpu")
    assert float(got["ss"]["blocks"][0]["planar"]["noise"]["weight"]) == 0.25
    noisy = str(tmp_path / "noisy.ckpt")
    torch.save({"g_ema": {k: torch.tensor(v) for k, v in sd.items()}}, noisy)
    with pytest.raises(ValueError, match="unexpected"):
        load_generator_params(noisy, tiny["g"], device="cpu")
