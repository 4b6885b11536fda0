"""The port's training-time FID (spgan_tpu_torch/train/evals.py, the
loop's FID and EXT2-FID ticks) and the full images of its data
pipelines, against the JAX package on the CPU.

TrainFID and its ext2 variant on tests/test_train_fid.py's tiny config
(channel_base 48, 2 SS layers, batch 4, n_fid_sample 8): the same
generator weights, the same fields (the port's draws, handed to JAX's
g.apply), the same pipeline of real images and the same inception
weights (a pytorch-fid-layout .pth read by both loaders): FID within rel
1e-4, each package's frechet_distance taken in the span of the
statistics (tests/helpers/fid_span.py: the same value, without a 2048^2
matrix square root).  The include_full batches of the npy, synthetic
and native pipelines equal JAX's bit for bit.  The loop's ticks, snapshots and
best.json run on a tiny yaml with SPGAN_TPU_INCEPTION=random, whose
network is replaced by a 16-feature stand-in: the plumbing is the same,
and each Frechet distance takes milliseconds instead of the ~10 s of a
2048-d matrix square root on a CPU."""
import json
import os
import sys

import numpy as np
import pytest
import jax
import torch
from threadpoolctl import threadpool_limits

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.fid_span import span_frechet  # noqa: E402
from helpers.inception_sd import pt_inception_state_dict  # noqa: E402

import spgan_tpu.data.native_loader as jax_native  # noqa: E402
import spgan_tpu.evalkit.fid as jax_fid  # noqa: E402
from spgan_tpu.config import Config as JConfig  # noqa: E402
from spgan_tpu.data.pipeline import TrainPipeline as JTrainPipeline  # noqa
from spgan_tpu.evalkit.inception import \
    load_torch_inception as jax_load_inception  # noqa: E402
from spgan_tpu.geometry.coords import CoordsPartial as JCP  # noqa: E402
from spgan_tpu.models.generator import Generator as JGenerator  # noqa: E402
from spgan_tpu.train.evals import TrainFID as JTrainFID  # noqa: E402
import spgan_tpu_torch.evalkit.inception as port_inception  # noqa: E402
import spgan_tpu_torch.models.discriminator as port_discriminator  # noqa
import spgan_tpu_torch.models.generator as port_generator  # noqa: E402
from spgan_tpu_torch.compat.from_jax import params_to_jax  # noqa: E402
from spgan_tpu_torch.config import Config  # noqa: E402
from spgan_tpu_torch.data import native_loader  # noqa: E402
from spgan_tpu_torch.data.pipeline import (TrainPipeline,  # noqa: E402
                                           make_train_pipeline)
from spgan_tpu_torch.infer.__main__ import main as infer_main  # noqa: E402
from spgan_tpu_torch.train.__main__ import main as train_main  # noqa: E402
from spgan_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
import spgan_tpu_torch.train.evals as port_evals  # noqa: E402
from spgan_tpu_torch.train.evals import TrainFID  # noqa: E402
from spgan_tpu_torch.train.loop import read_best  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for torch and one BLAS thread for numpy and
    scipy: several test processes run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.ss_n_layers = 2
    tp.batch_size = 4
    cfg.test_params.n_fid_sample = 8
    return cfg


class _FakePipe:
    """tests/test_train_fid.py's pipeline: uniform noise patches and full
    images from RandomState(0)."""

    def __init__(self, cfg):
        self.rng = np.random.RandomState(0)
        tp = cfg.train_params
        self.b, self.p, self.full = tp.batch_size, tp.patch_size, tp.full_size

    def __next__(self):
        return {"patch": self.rng.rand(self.b, self.p, self.p, 3).astype(
                    np.float32) * 2 - 1,
                "full": self.rng.rand(self.b, self.full, self.full, 3).astype(
                    np.float32) * 2 - 1}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jcfg, cfg = _tiny(JConfig()), _tiny(Config())
    jg, g = JGenerator.from_config(jcfg), port_generator.Generator.from_config(
        cfg)
    for m in (jg, g):
        object.__setattr__(m.ts, "channel_base", 48)
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path_factory.mktemp("inception") / "pt_inception.pth")
    torch.save(pt_inception_state_dict(np.random.RandomState(1)), path)
    return (jcfg, jg, params_to_jax(params), jax_load_inception(path),
            cfg, g, params, port_inception.load_torch_inception(
                path, device="cpu"))


def _to_jax(fields):
    cp = fields["cp"]
    return (fields["global_latent"].numpy(), fields["local_latent"].numpy(),
            fields["coords"].numpy(),
            JCP(p_x_st=cp.p_x_st.numpy(), p_x_ed=cp.p_x_ed.numpy(),
                p_y_st=cp.p_y_st.numpy(), p_y_ed=cp.p_y_ed.numpy(),
                circular=cp.circular.numpy(), x_total=cp.x_total,
                y_total=cp.y_total, grid_partial=cp.grid_partial),
            [n.numpy() for n in fields["noises"]])


@pytest.mark.parametrize("ext2", [False, True], ids=["fid", "ext2"])
def test_train_fid_matches_jax(models, ext2, tmp_path, monkeypatch):
    """The same fields through both generators (JAX's g.apply, its crop to
    full_size for ext2) and the same real batches: FID within rel 1e-4.
    Each package writes its real-stats cache in a directory of its own."""
    jcfg, jg, jparams, jinc, cfg, g, params, inc = models
    monkeypatch.setattr(jax_fid, "frechet_distance",
                        span_frechet(jax_fid.frechet_distance))
    monkeypatch.setattr(port_evals, "frechet_distance",
                        span_frechet(port_evals.frechet_distance))
    full = cfg.train_params.full_size
    port = TrainFID(cfg, g, _FakePipe(cfg), inception_params=inc, ext2=ext2,
                    device="cpu")
    fields = [port.draw(torch.Generator().manual_seed(10 + i), 4)
              for i in range(2)]
    img = port.forward(params, fields[0])
    assert img.dtype == torch.float32
    assert img.shape == ((4, full, full, 3) if ext2 else (4, 101, 101, 3))

    @jax.jit
    def jax_gen(p, gl, ll, coords, cp, noises):
        out = jg.apply(p, global_latent=gl, local_latent=ll, coords=coords,
                       cp=cp, noises=noises)["gen"]
        if ext2 and out.shape[1] > full:   # JAX's TrainFID crop
            q = (out.shape[1] - full) // 2
            out = out[:, q:q + full, q:q + full]
        return out

    jfid = JTrainFID(jcfg, jg, _FakePipe(jcfg), inception_params=jinc,
                     ext2=ext2)
    jfields = iter([_to_jax(f) for f in fields])
    jfid._gen = lambda p, key: jax_gen(p, *next(jfields))
    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    want = jfid(jparams, jax.random.PRNGKey(0))

    pfields = iter(fields)
    monkeypatch.setattr(port, "draw", lambda gen, n: next(pfields))
    os.makedirs(tmp_path / "port")
    monkeypatch.chdir(tmp_path / "port")
    got = port(params, torch.Generator())
    assert np.isfinite(want) and want > 0
    assert abs(got - want) <= 1e-4 * want, (got, want)
    key = f"Matterport3d-{full if ext2 else 101}" \
          f"{'-ext2' if ext2 else ''}_spgan_tpu.pkl"
    assert os.listdir(tmp_path / "port" / ".fid-cache") == [key]
    assert set(port.ms) == {"real_stats", "generate", "features", "frechet"}


def _configs(**data):
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.train_params.batch_size = 4
        for k, v in data.items():
            setattr(c.data_params, k, v)
    return jcfg, cfg


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for b, jb in zip(got, want):
        assert set(b) == set(jb) == {"patch", "ac_coords", "full"}
        for k in b:
            assert b[k].dtype == jb[k].dtype == np.float32
            np.testing.assert_array_equal(b[k], jb[k])
        assert b["full"].shape == (4, 197, 197, 3)


def _take(pipe, n=2):
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


@pytest.mark.parametrize("source", ["synthetic", "npy"])
def test_python_pipeline_full_images_match_jax(source, tmp_path):
    data = {}
    if source == "npy":
        path = str(tmp_path / "panos.npy")
        np.save(path, np.random.RandomState(3).randint(
            0, 256, (5, 128, 384, 3), np.uint8))
        data = dict(source="npy", folder=path)
    jcfg, cfg = _configs(**data)
    _assert_batches_equal(
        _take(make_train_pipeline(cfg, seed=7, include_full=True)),
        _take(JTrainPipeline(jcfg, seed=7, include_full=True)))
    # without include_full the batch has no "full" and the same patches
    plain = _take(TrainPipeline(cfg, seed=7), 1)[0]
    assert "full" not in plain


def test_native_loader_full_images_match_jax(tmp_path, monkeypatch):
    """The .spr pipeline's full images from the C++ loader's full_out."""
    monkeypatch.setattr(jax_native, "_SO", str(tmp_path / "libjax.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    imgs = np.random.RandomState(4).randint(0, 256, (6, 96, 288, 3),
                                            np.uint8)
    path = str(tmp_path / "panos.spr")
    native_loader.write_records(path, imgs)
    _, cfg = _configs(source="spr", folder=path)
    jld = jax_native.NativeRecordLoader(path, full_size=197, patch_size=101,
                                        batch=4, seed=5, include_full=True)
    try:
        want = [jld.next_batch() for _ in range(2)]
    finally:
        jld.close()
    _assert_batches_equal(
        _take(make_train_pipeline(cfg, seed=5, include_full=True)), want)


TINY_YAML = """\
data_params:
  source: npy
  folder: {folder}
train_params:
  global_latent_dim: 32
  local_latent_dim: 16
  channel_multiplier: 1
  n_mlp: 1
  ss_n_layers: 1
  batch_size: 2
  extra_pre_resize: ~
log_params:
  n_save_sample: 4
  log_tick: 2
  img_tick: 1000
  save_tick: 1000
  eval_tick: 2
  fid_ext2_tick: 2
test_params:
  calc_fid: true
  calc_fid_ext2: true
  n_fid_sample: 4
"""


class _StandIn(torch.nn.Module):
    """16 features of an image (pooled colours through a fixed linear
    map and tanh): a stand-in for the random inception network."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(12, 16)
        with torch.no_grad():
            rng = np.random.RandomState(9)
            self.lin.weight.copy_(torch.tensor(
                rng.randn(16, 12).astype(np.float32)))
            self.lin.bias.copy_(torch.tensor(
                rng.randn(16).astype(np.float32)))

    def forward(self, x):
        pooled = torch.nn.functional.adaptive_avg_pool2d(
            x.float().permute(0, 3, 1, 2), 2).flatten(1)
        return torch.tanh(self.lin(pooled * 4))


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A working directory holding tiny.yaml (npy source of 6 panoramas),
    the generator narrowed to channel_base 16 and the discriminator to 16
    channels (as tests/test_torch_train_cli.py narrows them), and
    SPGAN_TPU_INCEPTION=random with the stand-in network."""
    def g_from_config(cfg, orig=port_generator.Generator.from_config):
        g = orig(cfg)
        object.__setattr__(g.ts, "channel_base", 16)
        return g

    def d_from_config(cfg, orig=port_discriminator.Discriminator.from_config):
        d = orig(cfg)
        object.__setattr__(d, "channels", lambda: dict.fromkeys(
            d.__class__.channels(d), 16))
        return d

    monkeypatch.setattr(port_generator.Generator, "from_config",
                        staticmethod(g_from_config))
    monkeypatch.setattr(port_discriminator.Discriminator, "from_config",
                        staticmethod(d_from_config))
    monkeypatch.setattr(port_inception, "random_inception",
                        lambda device=None, **kw: _StandIn().to(device))
    monkeypatch.setenv("SPGAN_TPU_INCEPTION", "random")
    monkeypatch.chdir(tmp_path)
    imgs = np.random.RandomState(0).randint(0, 256, (6, 64, 192, 3), np.uint8)
    np.save(tmp_path / "panos.npy", imgs)
    (tmp_path / "tiny.yaml").write_text(
        TINY_YAML.format(folder=tmp_path / "panos.npy"))
    (tmp_path / "test.yaml").write_text(
        'task_manager: "spgan_tpu.infer.infinite.InfiniteGenerationManager"\n'
        "height: 128\nwidth: 200\nbatch_size: 1\nnum_gen: 1\nseed: 5\n")
    return tmp_path


def _scalars(out, tag):
    return [float(line.split(f"{tag} ")[1].split()[0])
            for line in out.splitlines() if f": {tag} " in line]


def test_loop_fid_ticks_snapshots_and_best_json(run_dir, capsys):
    """eval and fid_ext2 ticks of 2 over 4 iterations: FID and EXT2-FID at
    2 and 4, best_fid.pt / best_fid_ext2.pt with best.json holding the
    lowest of each, none listed by steps(); --ckpt best_fid.pt renders."""
    main_args = ["tiny.yaml", "--max-iters", "4", "--device", "cpu"]
    state = train_main(main_args)
    out = capsys.readouterr().out
    assert state.step == 4 and "RANDOM inception weights" in out
    fids, ext2 = _scalars(out, "metric/fid"), _scalars(out, "metric/fid_ext2")
    assert len(fids) == len(ext2) == 2
    assert all(np.isfinite(fids + ext2)) and min(fids + ext2) > 0
    ckpt = run_dir / "logs" / "tiny" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["best.json", "best_fid.pt",
                                        "best_fid_ext2.pt"]
    assert CheckpointManager(str(ckpt)).steps() == []
    best = json.loads((ckpt / "best.json").read_text())
    assert best["best_fid"] == pytest.approx(min(fids), rel=1e-5)
    assert best["best_ext2_fid"] == pytest.approx(min(ext2), rel=1e-5)
    assert best["best_ext2_fid_later"] == float("inf")
    assert (run_dir / ".fid-cache" /
            "Matterport3d-101_spgan_tpu.pkl").exists()
    assert (run_dir / ".fid-cache" /
            "Matterport3d-197-ext2_spgan_tpu.pkl").exists()

    manager = infer_main(["--model-config", "tiny.yaml", "--test-config",
                          "test.yaml", "--ckpt", str(ckpt / "best_fid.pt"),
                          "--device", "cpu", "--save-root", "render"])
    assert len([f for f in os.listdir(run_dir / "render")
                if f.endswith(".png")]) == 1
    assert manager.params_ema is not None


def test_loop_resume_reads_best_json(run_dir, capsys):
    """A resumed run starts from best.json's values: with a best FID below
    any the run can reach, no snapshot is written; a truncated best.json
    reads as none, and the next tick writes it whole."""
    ckpt = run_dir / "logs" / "tiny" / "ckpt"
    state = train_main(["tiny.yaml", "--max-iters", "1", "--device", "cpu"])
    assert state.step == 1
    CheckpointManager(str(ckpt)).save(1, state)
    (ckpt / "best.json").write_text(json.dumps(
        {"best_fid": -1.0, "best_ext2_fid": -1.0,
         "best_ext2_fid_later": -1.0}))
    train_main(["tiny.yaml", "--max-iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Resumed from iter 1" in out
    assert len(_scalars(out, "metric/fid")) == 1
    assert not (ckpt / "best_fid.pt").exists()
    assert read_best(str(ckpt / "best.json"))["best_fid"] == -1.0

    (ckpt / "best.json").write_text('{"best_fid": 0.')    # cut mid-write
    assert read_best(str(ckpt / "best.json"))["best_fid"] == float("inf")
    train_main(["tiny.yaml", "--max-iters", "2", "--device", "cpu"])
    assert (ckpt / "best_fid.pt").exists()
    assert json.loads((ckpt / "best.json").read_text())["best_fid"] < 1e30


def test_fid_off_without_inception_weights(run_dir, capsys, monkeypatch):
    """No SPGAN_TPU_INCEPTION (or a path that names no file): the JAX
    package's message, no FID, no snapshot."""
    for env in (None, str(run_dir / "missing.pth")):
        if env is None:
            monkeypatch.delenv("SPGAN_TPU_INCEPTION")
        else:
            monkeypatch.setenv("SPGAN_TPU_INCEPTION", env)
        train_main(["tiny.yaml", "--max-iters", "2", "--device", "cpu"])
        out = capsys.readouterr().out
        assert " [!] Inception weights not found (SPGAN_TPU_INCEPTION); " \
            "FID evaluation disabled." in out
        assert "metric/fid" not in out
    assert not (run_dir / "logs" / "tiny" / "ckpt" / "best_fid.pt").exists()
