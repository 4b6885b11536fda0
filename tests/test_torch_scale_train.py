"""The port's data-parallel training (train/step.py and train/loop.py on a
torch.distributed world), in worlds of CPU processes over gloo
(tests/helpers/torch_world.py; both worlds start together, once per
module).

  * The 2-rank step of the tiny training config (tests/helpers/
    port_tiny.train_models: batch 8, 4 a rank; PPL batch 4, 2 a rank)
    against the 1-process port step on the same global batch and the
    same global draws: a plain step and an R1+PPL step from the same
    state.  Metrics within rtol 5e-4 / atol 1e-5 (the JAX package's
    n-device against 1-device bound, __graft_entry__.py phase 1b); the
    parameters after the step as tests/test_torch_train.py holds them
    (Adam's first step normalises g/|g|, so float noise on near-zero
    gradients flips single updates by 2*lr); identical across the ranks.
    The 1-process step is held against JAX's real make_train_step by
    tests/test_torch_train.py.
  * python -m spgan_tpu_torch.train with --coordinator, --num-processes
    2 and --process-id on --device cpu, each rank in its own working
    directory: 2 iterations, equal parameters, and only rank 0 writes."""
import numpy as np
import pytest
import torch

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.parallel.mesh import Mesh
from spgan_tpu_torch.train.step import make_train_step

from helpers import scale_scenarios as sc
from helpers.port_tiny import train_models
from helpers.torch_world import start_world

CLI_ITERS = 2


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(the 2-rank steps, the 1-process steps, the CLI ranks' results and
    working directories)."""
    tmp = tmp_path_factory.mktemp("worlds")
    yaml = tmp / "tiny.yaml"
    yaml.write_text(sc.CLI_YAML)
    cwds = [tmp / f"rank{r}" for r in range(2)]
    for c in cwds:
        c.mkdir()
    started = [
        start_world("helpers.scale_scenarios:train_steps", 2, tmp),
        start_world("helpers.scale_scenarios:train_cli", 2, tmp,
                    args=(yaml, CLI_ITERS), cwds=cwds, join=False)]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = {}
        sc.train_steps(Mesh(), one)
        return started[0].results(), one, started[1].results(), cwds
    finally:
        torch.set_num_threads(n)
        for w in started:
            w.close()


def _params_close(got, want, name):
    diff = np.abs(got - want)
    assert diff.max() < 0.01, name
    assert (diff > 5e-4).mean() < 0.005, name


@pytest.mark.parametrize("kind", ["plain", "reg"])
def test_two_rank_step_matches_one_process(worlds, kind):
    ranks, one, _, _ = worlds
    keys = [k for k in one if k.startswith(f"{kind}/metric/")]
    assert len(keys) == 16
    for k in keys:
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[k], one[k], rtol=5e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
    if kind == "reg":
        assert one["reg/metric/r1"] > 0 and one["reg/metric/path"] > 0
    for tree in ("params_g", "params_d", "params_g_ema"):
        _params_close(ranks[0][f"{kind}/{tree}"], one[f"{kind}/{tree}"],
                      tree)
    np.testing.assert_allclose(ranks[0][f"{kind}/mean_path_length"],
                               one[f"{kind}/mean_path_length"], rtol=5e-4,
                               atol=1e-8)


@pytest.mark.parametrize("kind", ["plain", "reg"])
def test_ranks_hold_identical_parameters(worlds, kind):
    ranks = worlds[0]
    for k in ranks[0]:
        if k.startswith(kind):
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)


def test_batches_that_do_not_split_raise():
    """The global batches must split into even blocks where dual latents
    pair adjacent samples; the error names the numbers."""
    cfg, g, d = train_models(Config, Generator, Discriminator, 8)
    with pytest.raises(ValueError, match="batch_size = 8 does not split "
                                         "over 3 ranks"):
        make_train_step(cfg, g, d, mesh=Mesh(world_size=3))
    with pytest.raises(ValueError, match=r"PPL batch .* = 4 over 4 ranks "
                                         "gives 1 a rank"):
        make_train_step(cfg, g, d, mesh=Mesh(world_size=4))
    cfg.train_params.batch_size = 12
    with pytest.raises(ValueError, match="batch_size = 12 over 4 ranks "
                                         "gives 3 a rank"):
        make_train_step(cfg, g, d, mesh=Mesh(world_size=4))


def test_cli_multi_process_flags_train_and_only_rank_0_writes(worlds):
    _, _, ranks, cwds = worlds
    for res in ranks:
        assert int(res["step"]) == CLI_ITERS
    np.testing.assert_array_equal(ranks[1]["params_g"], ranks[0]["params_g"])
    written = set(ranks[0]["listing"])
    assert f"logs/tiny/ckpt/{CLI_ITERS}.pt" in written
    assert list(ranks[1]["listing"]) == [""]
    assert sorted(p.name for p in cwds[1].iterdir()) == []
