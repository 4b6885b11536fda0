"""The port's scale-out inference paths against the JAX package, in worlds
of CPU processes over gloo (tests/helpers/torch_world.py; one world
renders the sharded engine, the halo path at both widths and the halo
path with SS noise, once per module, while the test process compiles
JAX's references):

  * the lattice-sharded engine (PanoramaEngine.make_sharded_generate) on
    2 ranks against JAX's make_sharded_generate on a 2-device CPU mesh,
    on the same numpy fields and weights (the engine's tiny config,
    128x672, batch 2, chunk 4: 28 rendered positions padded to 32);
  * the width-sharded halo path (infer/halo.py) on 2 ranks against JAX's
    generate_width_sharded on a 1-device mesh, on the fields JAX draws
    from its key (repeated here as halo.py draws them), at ss_n_layers 1
    (window 17, halo 11), height 128, widths 384 (4 columns) and 480 (5
    columns: pad 1);
  * N ranks against 1 rank, bit for bit (the halo path with SS noise
    too); the halo path with SS noise against the port's folded engine,
    since JAX's halo drops the SS noise maps (fault C8); `--engine
    sharded|halo` through the infer CLI, in a world of one and under
    torchrun's environment.

Float32 on both sides (JAX's defaults off a TPU: the sphere convs on the
patch grids in XLA; they compile in less than half the time of its
tap-table form and agree with it to ~1e-6 here), so the images agree to
summation-order noise: atol 2e-4, the engine parity bound of
tests/test_torch_engine.py."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

import spgan_tpu_torch.models.generator as port_generator
from spgan_tpu.compat.load import save_params_npz
from spgan_tpu.config import Config as JConfig
from spgan_tpu.infer.engine import PanoramaEngine as JEngine
from spgan_tpu.infer.halo import make_width_sharded_generate as jhalo
from spgan_tpu.infer.stitcher import build_close_loop_plan as jplan
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.parallel.mesh import make_mesh as jmesh
from spgan_tpu_torch.compat.load import load_generator_params
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.infer.__main__ import main
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.halo import (column_generator,
                                        make_width_sharded_generate)
from spgan_tpu_torch.infer.managers import (CloseLoopPanoramaManager,
                                            InfiniteGenerationManager,
                                            halo_seed, to_uint8)
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.parallel.mesh import Mesh

from helpers import scale_scenarios as sc
from helpers.port_tiny import cpu_budget, narrow, tiny, write_yamls
from helpers.torch_world import run_world, start_world

HALO_WIDTHS = (384, 480)


@pytest.fixture(scope="module", autouse=True)
def _budget():
    with cpu_budget():
        yield


def _jax_generator(ss_n_layers, ss_disable_noise=True):
    cfg = tiny(JConfig())
    cfg.train_params.ss_n_layers = ss_n_layers
    cfg.train_params.ss_disable_noise = ss_disable_noise
    g = narrow(JGenerator.from_config(cfg))
    return cfg, g, g.init(jax.random.PRNGKey(0))


def _jax_halo_fields(g, plan, key, batch=1):
    """The fields JAX's width-sharded generate draws from `key`
    (spgan_tpu/infer/halo.py, `full`)."""
    kg, kz, kn = jax.random.split(key, 3)
    gl = jax.random.normal(kg, (batch, 2, g.ts.global_dim))
    gl = gl.at[:, 1].set(gl[:, 0])
    z = jax.random.normal(kz, (batch, plan.z_field_h, plan.z_field_w,
                               g.ts.local_dim))
    noises = [jax.random.normal(jax.random.fold_in(kn, i), (batch, h, w, 1))
              for i, (h, w) in enumerate(plan.noise_sizes)]
    return np.asarray(gl), np.asarray(z), [np.asarray(n) for n in noises]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One 2-rank world renders the sharded engine, the halo path at both
    widths and the halo path with SS noise
    (helpers.scale_scenarios.infer_paths) while this process compiles
    JAX's references and runs the 1-rank halos."""
    tmp = tmp_path_factory.mktemp("worlds")
    (cfg2, jg2, jp2), (cfg1, jg1, jp1) = (_jax_generator(2),
                                          _jax_generator(1))
    save_params_npz(str(tmp / "params2.npz"), jp2)
    save_params_npz(str(tmp / "params1.npz"), jp1)
    key = jax.random.PRNGKey(3)
    halo_fields = {}
    for w in HALO_WIDTHS:
        gl, z, noises = halo_fields[w] = _jax_halo_fields(
            jg1, jplan(jg1, 128, w), key)
        np.savez(tmp / f"fields{w}.npz", gl=gl, z=z,
                 **{f"noise{i}": n for i, n in enumerate(noises)})
    world = start_world("helpers.scale_scenarios:infer_paths", 2, tmp,
                        args=(tmp,))
    try:
        eng = JEngine(g=jg2, plan=jplan(jg2, 128, 672), batch=2,
                      patch_chunk=4, grid_partial=cfg2.train_params.partial)
        gl, z, noises = sc.plan_fields(eng.plan, jg2, 2, 11)
        fn = eng.make_sharded_generate(jmesh(jax.devices()[:2]))
        sharded = {"want": np.asarray(fn(jp2, jnp.asarray(gl),
                                         jnp.asarray(z),
                                         [jnp.asarray(n) for n in noises]))}
        halo = {}
        for w in HALO_WIDTHS:
            fn = jhalo(jg1, jplan(jg1, 128, w), jmesh(jax.devices()[:1]), 1,
                       cfg1.train_params.partial)
            one = {}
            sc.halo(Mesh(), one, str(tmp / "params1.npz"), 128, w,
                    str(tmp / f"fields{w}.npz"))
            halo[w] = dict(want=np.asarray(fn(jp1, key)),
                           fields=halo_fields[w], one=one)
        ss_noise = {"one": {}, "off": {}}
        for k, wgt in (("one", 0.5), ("off", 0.0)):
            sc.halo_ss_noise(Mesh(), ss_noise[k], 128, 480, wgt)
    except BaseException:
        world.close()
        raise
    ranks = world.results()
    for name, d in ([("sharded", sharded)]
                    + [(f"halo{w}", halo[w]) for w in HALO_WIDTHS]
                    + [("halo_ss_noise", ss_noise)]):
        d["ranks"] = [{k[len(name) + 1:]: v for k, v in r.items()
                       if k.startswith(name + "/")} for r in ranks]
    return sharded, halo, tmp / "params1.npz", ss_noise


@pytest.fixture(scope="module")
def sharded(worlds):
    return worlds[0]["want"], worlds[0]["ranks"]


@pytest.fixture(scope="module")
def halo(worlds):
    """Per width: JAX's meta image, the port's 2-rank and 1-rank results."""
    return worlds[1], worlds[2]


def test_sharded_engine_matches_jax(sharded):
    want, ranks = sharded
    for r, res in enumerate(ranks):
        assert res["meta"].shape == want.shape == (2, 389, 672, 3)
        np.testing.assert_allclose(res["meta"], want, atol=2e-4,
                                   err_msg=f"rank {r}")


def test_sharded_engine_equals_folded_and_pads_evenly(sharded):
    """Every rank holds the same meta image, equal to the folded engine's
    bit for bit (a chunk without padding is one of the folded engine's
    own chunks); 28 rendered positions over 2 ranks in chunks of 4 pad to
    ceil(ceil(28 / 2) / 4) = 4 chunks a rank."""
    _, ranks = sharded
    for res in ranks:
        np.testing.assert_array_equal(res["meta"], ranks[0]["meta"])
        np.testing.assert_array_equal(res["meta"], res["folded"])
        assert int(res["chunks"]) == 4


@pytest.mark.parametrize("width", HALO_WIDTHS)
def test_halo_matches_jax(halo, width):
    res = halo[0][width]
    want, r0 = res["want"], res["ranks"][0]
    assert r0["fields"].shape == want.shape == (1, 389, width, 3)
    np.testing.assert_allclose(r0["fields"], want, atol=2e-4)
    # rank 0 assembles; rank 1 returns nothing
    assert "fields" not in res["ranks"][1] and "seed" not in res["ranks"][1]
    # 4 columns: 2 a rank; 5 columns: 3 a rank, one padded wrap column
    assert (int(r0["cols_per_dev"]), int(r0["pad"])) == \
        {384: (2, 0), 480: (3, 1)}[width]


@pytest.mark.parametrize("width", HALO_WIDTHS)
def test_halo_n_ranks_equal_one_rank_bit_for_bit(halo, width):
    """Injected fields and fields drawn per lattice column from a seed:
    2 ranks equal 1 rank bit for bit; the per-column draws do not depend
    on the world size."""
    res = halo[0][width]
    r0, one = res["ranks"][0], res["one"]
    for k in ("fields", "seed"):
        np.testing.assert_array_equal(r0[k], one[k])
    for k in one:
        if k.startswith("seed_"):
            for rr in res["ranks"]:
                np.testing.assert_array_equal(rr[k], one[k])


@pytest.mark.parametrize("width", HALO_WIDTHS)
def test_halo_matches_the_folded_engine_on_its_fields(halo, width):
    """The halo path and the folded engine render the same panorama from
    the same fields (their chunks group other positions)."""
    (res, npz), (gl, z, noises) = halo, halo[0][width]["fields"]
    cfg, g = sc.infer_generator(1)
    params = load_generator_params(str(npz), g, device="cpu")
    eng = PanoramaEngine(g=g, plan=build_close_loop_plan(g, 128, width),
                         batch=1, grid_partial=cfg.train_params.partial,
                         device="cpu")
    folded = eng.generate_from_fields(
        params, torch.tensor(gl), torch.tensor(z),
        [torch.tensor(n) for n in noises]).numpy()
    np.testing.assert_allclose(res[width]["ranks"][0]["fields"], folded,
                               atol=2e-4)


def test_halo_with_ss_noise_n_ranks_equal_one_rank_bit_for_bit(worlds):
    """ss_disable_noise false at 128x480 (5 columns, 3 a rank, one padded
    wrap column) from a seed: 2 ranks equal 1 rank bit for bit (every
    rank draws the same SS noise maps), and the SS noise weights moving
    from 0 to 0.5 move the image."""
    res = worlds[3]
    r0 = res["ranks"][0]["seed"]
    assert r0.shape == (1, 389, 480, 3) and np.isfinite(r0).all()
    assert "seed" not in res["ranks"][1]
    np.testing.assert_array_equal(r0, res["one"]["seed"])
    assert np.abs(r0 - res["off"]["seed"]).max() > 1e-3


def test_halo_assertions_keep_jax_messages():
    cfg, g = sc.infer_generator(1)
    plan = build_close_loop_plan(g, 128, 384)   # 4 columns, window 17
    with pytest.raises(ValueError, match="shard width 6 latent cols < halo "
                                         "11"):
        make_width_sharded_generate(g, plan, Mesh(rank=0, world_size=4),
                                    1, cfg.train_params.partial,
                                    device="cpu")


def test_column_generator_depends_on_seed_and_tag_only():
    a = torch.randn(4, generator=column_generator(5, 3, "cpu"))
    b = torch.randn(4, generator=column_generator(5, 3, "cpu"))
    c = torch.randn(4, generator=column_generator(5, 4, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_c8_jax_halo_renders_without_the_ss_noise():
    """Fault C8: with ss_disable_noise false, JAX's halo body passes no SS
    noise maps (halo.py:228-229): its image does not move when the SS
    noise weights do, while the folded engine's does (the port's folded
    engine here, on the same weights).  The port's halo renders with the
    maps: it equals the port's folded engine on the halo's own fields
    (global_fields, the SS noise maps after the TS noise fields) at both
    weights."""
    cfg, jg, jp = _jax_generator(1, ss_disable_noise=False)
    plan = jplan(jg, 128, 384)
    fn = jhalo(jg, plan, jmesh(jax.devices()[:1]), 1,
               cfg.train_params.partial)

    def with_ss_noise_weight(params, wgt):
        blocks = [dict(b, planar=dict(b["planar"], noise={
            "weight": wgt + 0 * b["planar"]["noise"]["weight"]}))
            for b in params["ss"]["blocks"]]
        return dict(params, ss=dict(params["ss"], blocks=blocks))

    key = jax.random.PRNGKey(3)
    off = np.asarray(fn(with_ss_noise_weight(jp, 0.0), key))
    on = np.asarray(fn(with_ss_noise_weight(jp, 0.5), key))
    assert np.isfinite(off).all()
    np.testing.assert_array_equal(on, off)

    tcfg, g = sc.infer_generator(1, ss_disable_noise=False)
    eng = PanoramaEngine(g=g, plan=build_close_loop_plan(g, 128, 384),
                         batch=1, grid_partial=tcfg.train_params.partial,
                         device="cpu")
    fn = make_width_sharded_generate(g, eng.plan, Mesh(), 1,
                                     tcfg.train_params.partial, device="cpu")
    fields = fn.global_fields(5)
    assert [tuple(n.shape) for n in fields[2][len(eng.plan.noise_sizes):]] \
        == [(1, s, s, 1) for s in g.ss.noise_sizes(eng.plan.window)]
    metas = []
    for wgt in (0.0, 0.5):
        params = sc.ss_noise_params(g, wgt)
        metas.append(eng.generate_from_fields(params, *fields))
        np.testing.assert_allclose(fn(params, 5).numpy(),
                                   metas[-1].numpy(), atol=2e-4)
    assert bool(metas[0].isfinite().all())
    assert float((metas[1] - metas[0]).abs().max()) > 1e-3


# --------------------------------------------------------------- the CLI
@pytest.fixture
def narrowed(monkeypatch):
    def from_config(cfg, orig=port_generator.Generator.from_config):
        return narrow(orig(cfg))
    monkeypatch.setattr(port_generator.Generator, "from_config",
                        staticmethod(from_config))


def _png(path):
    return np.asarray(Image.open(path))


def test_cli_sharded_and_halo_in_a_world_of_one(narrowed, tmp_path,
                                                monkeypatch):
    """--engine sharded writes the folded run's PNG bit for bit; --engine
    halo the folded engine's render of the halo's own fields (drawn per
    lattice column from the batch's seed) within one LSB."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = write_yamls(tmp_path) + ["--device", "cpu"]
    pngs = {}
    for engine in ("folded", "sharded", "halo"):
        out = tmp_path / engine
        m = main(args + ["--engine", engine, "--save-root", str(out)])
        assert sorted(os.listdir(out)) == ["000000.png"]
        pngs[engine] = _png(out / "000000.png")
    np.testing.assert_array_equal(pngs["sharded"], pngs["folded"])
    eng = m.engine
    seed = halo_seed(torch.Generator().manual_seed(17))
    fields = m._halo_fn.global_fields(seed)
    want = to_uint8(eng.crop_to_target(
        eng.generate_from_fields(m.params_ema, *fields)).numpy())[0]
    diff = np.abs(pngs["halo"].astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def test_cli_halo_under_torchrun_env_writes_on_rank_0(narrowed, tmp_path,
                                                       monkeypatch):
    """--engine halo on 2 ranks that torchrun's environment joins: only
    rank 0 writes, the PNG of a world of one."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = write_yamls(tmp_path) + ["--engine", "halo", "--save-root", "out"]
    cwds = [tmp_path / f"rank{r}" for r in range(2)]
    for c in cwds:
        c.mkdir()
    ranks = run_world("helpers.scale_scenarios:infer_cli", 2, tmp_path,
                      args=args, cwds=cwds, join=False)
    assert list(ranks[0]["pngs"]) == ["./out/000000.png"]
    assert list(ranks[1]["pngs"]) == [""]
    main(args[:-1] + [str(tmp_path / "one"), "--device", "cpu"])
    np.testing.assert_array_equal(_png(cwds[0] / "out" / "000000.png"),
                                  _png(tmp_path / "one" / "000000.png"))


def test_halo_needs_the_close_loop_manager():
    cfg = tiny(Config())
    cfg.task.engine = "halo"
    g = narrow(Generator.from_config(cfg))
    mgr = InfiniteGenerationManager(g=g, params_ema=None, config=cfg,
                                    device="cpu")
    with pytest.raises(ValueError, match="needs the close-loop manager"):
        mgr.task_specific_init()
    cfg.task.engine = "sharded"
    mgr = CloseLoopPanoramaManager(g=g, params_ema=None, config=cfg,
                                   device="cpu")
    mgr.task_specific_init()
    assert mgr._sharded_fn.chunks == -(-len(mgr.engine._render_idx)
                                       // mgr.engine.patch_chunk)
