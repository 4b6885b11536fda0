"""The port's training CLI, python -m spgan_tpu_torch.train, as a whole on
the CPU (--device cpu): a yaml with an npy source, ticks, checkpoints and
tensorboard, --debug, the error log, resume, and the hand-over of its
checkpoint directory to the inference CLI.  Tiny widths: the yaml's own
(latent dims, 1 SS layer), the generator narrowed to channel_base 16 and
the discriminator to 16 channels, as tests/test_torch_train.py narrows
them.  (D narrowed by d_extra_multiplier 1/16 or 1/32 instead corrupts
the heap inside PyTorch 2.13's CPU oneDNN convolutions in the D backward
of a training step; with torch.backends.mkldnn off it runs.)"""
import os

import numpy as np
import pytest
import torch

import spgan_tpu_torch.models.discriminator as port_discriminator
import spgan_tpu_torch.models.generator as port_generator
from spgan_tpu_torch.infer.__main__ import main as infer_main
from spgan_tpu_torch.train import loop
from spgan_tpu_torch.train.__main__ import main
from spgan_tpu_torch.train.checkpoint import CheckpointManager
from spgan_tpu_torch.tree import flatten

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
  img_tick: 4
  save_tick: 2
test_params:
  calc_fid: true
"""
TEST_YAML = """\
task_manager: "spgan_tpu.infer.infinite.InfiniteGenerationManager"
height: 128
width: 200
batch_size: 1
num_gen: 1
seed: 5
"""


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads (several test processes run side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A working directory holding tiny.yaml (npy source of 6 panoramas),
    with both networks narrowed for every caller."""
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
    monkeypatch.chdir(tmp_path)
    imgs = np.random.RandomState(0).randint(0, 256, (6, 64, 192, 3), np.uint8)
    np.save(tmp_path / "panos.npy", imgs)
    (tmp_path / "tiny.yaml").write_text(
        TINY_YAML.format(folder=tmp_path / "panos.npy"))
    (tmp_path / "test.yaml").write_text(TEST_YAML)
    return tmp_path


def _ckpt_dir(root):
    return root / "logs" / "tiny" / "ckpt"


def test_run_ticks_checkpoints_resume_and_render(run_dir, capsys,
                                                 monkeypatch):
    """4 iterations with log and save ticks of 2 (grids at 4):
    checkpoints 2 and 4, a tensorboard event file with the grids, the code
    snapshot and two scalar lines; a rerun to 5 resumes from 4; the
    inference CLI renders a PNG from the checkpoint directory with the
    EMA generator of its newest checkpoint (4)."""
    monkeypatch.delenv("SPGAN_TPU_INCEPTION", raising=False)
    state = main(["tiny.yaml", "--max-iters", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert state.step == 4
    assert "Inception weights not found (SPGAN_TPU_INCEPTION); FID " \
        "evaluation disabled." in out
    assert "[train] iter 2/4" in out and "[train] iter 4/4" in out
    assert "nan" not in out
    exp = run_dir / "logs" / "tiny"
    assert CheckpointManager(str(_ckpt_dir(run_dir))).steps() == [2, 4]
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(exp / "tb"))
    assert (exp / "codes" / "tiny.yaml").exists()

    saved = state
    state = main(["tiny.yaml", "--max-iters", "5", "--device", "cpu"])
    assert "Resumed from iter 4" in capsys.readouterr().out
    assert state.step == 5
    assert CheckpointManager(str(_ckpt_dir(run_dir))).steps() == [2, 4]

    manager = infer_main(["--model-config", "tiny.yaml", "--test-config",
                          "test.yaml", "--ckpt", str(_ckpt_dir(run_dir)),
                          "--device", "cpu", "--save-root", "out"])
    got = dict(flatten(manager.params_ema))
    for k, v in flatten(saved.params_g_ema):
        assert torch.equal(got[k], v), k
    pngs = [f for f in os.listdir(run_dir / "out") if f.endswith(".png")]
    assert len(pngs) == 1


def test_image_grids_shapes():
    """The grids of make_image_grids: uint8, rows of 8 patches."""
    from spgan_tpu_torch.config import Config

    cfg = Config()
    tp = cfg.train_params
    tp.global_latent_dim, tp.local_latent_dim = 32, 16
    tp.channel_multiplier, tp.n_mlp, tp.ss_n_layers = 1, 1, 1
    cfg.log_params.n_save_sample = 9
    g = port_generator.Generator.from_config(cfg)
    object.__setattr__(g.ts, "channel_base", 16)
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    grids = loop.make_image_grids(cfg, g, seed=0, device="cpu")(params, 7)
    assert {k: v.shape for k, v in grids.items()} == {
        "samples/ema": (202, 808, 3), "samples/style_diversity": (101, 808, 3),
        "samples/structure_diversity": (101, 808, 3)}
    assert all(v.dtype == np.uint8 and v.std() > 0 for v in grids.values())


def test_debug_writes_nothing(run_dir, capsys):
    state = main(["tiny.yaml", "--debug", "--device", "cpu"])
    assert state.step == 1
    assert "[debug] one iteration OK" in capsys.readouterr().out
    assert not (run_dir / "logs").exists()


def test_failure_appends_to_error_log(run_dir, monkeypatch):
    def broken(*args, **kwargs):
        def step(*a, **kw):
            raise RuntimeError("step exploded")
        return step

    monkeypatch.setattr(loop, "make_train_step", broken)
    log = run_dir / "logs" / "tiny" / "error-log.txt"
    for n in (1, 2):
        with pytest.raises(RuntimeError, match="step exploded"):
            main(["tiny.yaml", "--max-iters", "2", "--device", "cpu"])
        assert log.read_text().count("RuntimeError: step exploded") == n


@pytest.mark.parametrize("flag", [["--baseline-ckpt", "b.ckpt"]])
def test_unported_flags_raise(flag):
    """--baseline-ckpt is ported, and a checkpoint that is not there
    raises naming it, before anything else runs."""
    with pytest.raises(FileNotFoundError, match="b.ckpt"):
        main(["tiny.yaml", *flag, "--device", "cpu"])


def test_cuda_without_a_card_raises(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["tiny.yaml", "--max-iters", "1"])
