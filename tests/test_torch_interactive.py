"""The port's editing REPL (spgan_tpu_torch/infer/interactive.py) and
`python -m spgan_tpu_torch.infer --interactive`, on the CPU, against the
JAX package's REPL at the tiny config of tests/test_interactive.py
(channel_base 48, 2 SS layers, 128x672, batch 1): JAX's scripted REPL
test run on the port, the same saved vars shown by both REPLs (PNG values
within 1), fault C7 (JAX's `place` cannot read the record its own
inversion writes; the port's reads both layouts), and the CLI flag and
yaml key on a scripted stdin."""
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

import spgan_tpu_torch.models.generator as port_generator
from spgan_tpu.config import Config as JConfig
from spgan_tpu.infer.interactive import run_interactive as jax_repl
from spgan_tpu.infer.managers import CloseLoopPanoramaManager as JManager
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.infer.__main__ import main
from spgan_tpu_torch.infer.interactive import run_interactive
from spgan_tpu_torch.infer.inversion import InversionResult
from spgan_tpu_torch.infer.managers import CloseLoopPanoramaManager
from spgan_tpu_torch.infer.testing_vars import TestingVars
from spgan_tpu_torch.models.generator import Generator
from helpers.port_tiny import (cpu_budget, jax_layout, narrow, tiny,
                               write_yamls)


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    with cpu_budget():
        yield


@pytest.fixture(scope="module")
def port_mgr():
    cfg = tiny(Config())
    g = narrow(Generator.from_config(cfg))
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    mgr = CloseLoopPanoramaManager(g=g, params_ema=params, config=cfg,
                                   device="cpu")
    mgr.task_specific_init()
    return mgr


def _jax_mgr(port_mgr):
    cfg = tiny(JConfig())
    jg = narrow(JGenerator.from_config(cfg))
    mgr = JManager(g=jg, params_ema=jax_layout(port_mgr.params_ema),
                   config=cfg)
    mgr.task_specific_init()
    return mgr


def _png(path):
    return np.asarray(Image.open(path))


def _script(*lines):
    return io.StringIO("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def scripted(port_mgr, tmp_path_factory):
    """tests/test_interactive.py's scripted session on the port: gen ->
    region reroll -> save / global reroll / load -> show, then two bad
    lines."""
    root = tmp_path_factory.mktemp("repl")
    vars_path = str(root / "vars.npz")
    out = []
    n = run_interactive(port_mgr, str(root / "imgs"), stream=_script(
        "gen 3", "reroll region 0 0 4 4 7", f"save {vars_path}",
        "reroll global 9", f"load {vars_path}", "show", "bogus command",
        "reroll region oops", "quit"), out=out.append)
    return root / "imgs", n, out


def test_repl_scripted(port_mgr, scripted):
    """Four renders; the save / load round trip restored the state before
    the global reroll, so `show` equals the region reroll's image; the two
    bad lines are reported, not raised."""
    imgs_dir, n, out = scripted
    assert n == 4
    pngs = sorted(os.listdir(imgs_dir))
    assert pngs == ["000000.png", "000001.png", "000002.png", "000003.png"]
    imgs = [_png(imgs_dir / p) for p in pngs]
    assert imgs[0].shape == (port_mgr.plan.meta_h, 672, 3)
    np.testing.assert_array_equal(imgs[1], imgs[3])
    assert not np.array_equal(imgs[1], imgs[2])
    errs = [line for line in out if line.startswith(" [!]")]
    assert len(errs) == 2


def test_regenerate_keeps_untouched_patches(port_mgr, scripted):
    """The region reroll (z rows and columns 0..3) rewrote only the
    patches whose latent window overlaps the region: every pixel outside
    them kept its value."""
    imgs_dir = scripted[0]
    a, b = _png(imgs_dir / "000000.png"), _png(imgs_dir / "000001.png")
    plan = port_mgr.plan
    win, size = plan.window, plan.geom.outfeat_sizes[-1]
    touched = np.zeros((plan.meta_h, plan.meta_w), bool)
    for (zr, zc), (r, cc) in zip(plan.z_starts, plan.img_starts):
        if zr < 4 and ((zc + np.arange(win)) % plan.z_field_w < 4).any():
            touched[r:r + size, (cc + np.arange(size)) % plan.meta_w] = True
    assert 0 < touched.mean() < 0.75
    assert not np.array_equal(a[touched], b[touched])
    np.testing.assert_array_equal(a[~touched], b[~touched])


def test_both_repls_show_the_same_vars(port_mgr, tmp_path):
    """Vars saved once, loaded into JAX's REPL and the port's, on the same
    weights: `show` writes PNGs within 1 of each other."""
    tv = port_mgr.create_vars(torch.Generator().manual_seed(11))
    tv.save(str(tmp_path / "vars.npz"))
    script = (f"load {tmp_path / 'vars.npz'}", "show")
    n_jax = jax_repl(_jax_mgr(port_mgr), str(tmp_path / "jax"),
                     stream=_script(*script), out=lambda s: None)
    n_port = run_interactive(port_mgr, str(tmp_path / "port"),
                             stream=_script(*script), out=lambda s: None)
    assert n_jax == n_port == 1
    a = _png(tmp_path / "jax" / "000000.png").astype(int)
    b = _png(tmp_path / "port" / "000000.png").astype(int)
    assert a.shape == b.shape == (port_mgr.plan.meta_h, 672, 3)
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() > 0.999


def _record(port_mgr):
    g = port_mgr.g
    zs = g.ss.coord_grid.ss_spatial_size
    rng = np.random.RandomState(4)
    return InversionResult(
        local_latent=rng.randn(zs, zs, g.ts.local_dim).astype(np.float32),
        noises=[rng.randn(s, s, 1).astype(np.float32)
                for s in g.ts.stitch_geometry().outfeat_sizes],
        wplus=np.zeros((g.ts.n_latent, g.ts.global_dim), np.float32),
        losses=np.ones(3))


def test_c7_place_reads_the_inversion_record(port_mgr, tmp_path):
    """Fault C7: InversionResult.save writes z / noiseNN, JAX's REPL
    `place` reads local_latent / noise_{i}, so it reports a KeyError on
    its own producer's file; the port's `place` pastes it."""
    rec = _record(port_mgr)
    rec.save(str(tmp_path / "rec.npz"))
    tv = port_mgr.create_vars(torch.Generator().manual_seed(2))
    tv.save(str(tmp_path / "vars.npz"))
    script = (f"load {tmp_path / 'vars.npz'}",
              f"place {tmp_path / 'rec.npz'} 0.5",
              f"save {tmp_path / 'placed.npz'}")

    out_jax = []
    n = jax_repl(_jax_mgr(port_mgr), str(tmp_path / "jax"),
                 stream=_script(*script[:2]), out=out_jax.append)
    assert n == 0
    assert [s for s in out_jax if s.startswith(" [!]")] == [
        " [!] KeyError: 'local_latent is not a file in the archive'"]

    out = []
    n = run_interactive(port_mgr, str(tmp_path / "port"),
                        stream=_script(*script), out=out.append)
    assert n == 1 and not [s for s in out if s.startswith(" [!]")]
    placed = TestingVars.load(str(tmp_path / "placed.npz"))
    want = TestingVars.load(str(tmp_path / "vars.npz"))
    want.replace_by_records(port_mgr.plan, [rec.record()], [0.5])
    np.testing.assert_array_equal(placed.local_latent, want.local_latent)
    for a, b in zip(placed.noises, want.noises):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(placed.local_latent, tv.local_latent)


@pytest.mark.parametrize("how", ["flag", "yaml"])
def test_cli_interactive_on_stdin(tmp_path, monkeypatch, how):
    """--interactive (or task.interactive in the test yaml) runs the REPL
    on stdin instead of the batches; `reroll noise` draws every map anew
    (their injection weights start at 0, so the render itself does not
    move)."""
    monkeypatch.setattr(
        port_generator.Generator, "from_config", staticmethod(
            lambda cfg, orig=port_generator.Generator.from_config:
            narrow(orig(cfg))))
    monkeypatch.chdir(tmp_path)
    if how == "flag":
        args = write_yamls(tmp_path) + ["--interactive"]
        script = ("gen 5", f"save {tmp_path / 'a.npz'}", "reroll noise",
                  f"save {tmp_path / 'b.npz'}", "reroll oops", "help", "quit")
    else:
        args = write_yamls(tmp_path, interactive="true")
        script = ("gen 5", "quit", "gen 6")
    monkeypatch.setattr("sys.stdin", _script(*script))
    main(args + ["--device", "cpu", "--random-init",
                 "--save-root", str(tmp_path / "out")])
    pngs = sorted(os.listdir(tmp_path / "out"))
    if how == "yaml":
        assert pngs == ["000000.png"]
        return
    assert pngs == ["000000.png", "000001.png"]
    na, nb = (TestingVars.load(str(tmp_path / f)).noises
              for f in ("a.npz", "b.npz"))
    assert [n.shape for n in na] == [n.shape for n in nb]
    assert na[0].shape[0] == 1
    assert not any(np.array_equal(x, y) for x, y in zip(na, nb))


def test_cli_interactive_refuses_batches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="batch_size 1"):
        main(write_yamls(tmp_path, batch_size=2)
             + ["--device", "cpu", "--interactive"])
