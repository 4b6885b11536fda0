"""The port's training checkpoints and the generator export on the CPU:
the round trip, rolling retention and resume, layout drift, a resumed
step against an uninterrupted one, and the .npz export against the JAX
package's save_params_npz and load_generator_params.

Tiny widths (tests/test_torch_train.py's models).  Every comparison is
exact: a checkpoint stores the tensors themselves, the export transposes
float32 arrays, and a resumed step repeats the same float32 arithmetic on
the CPU."""
import jax
import numpy as np
import pytest
import torch

from spgan_tpu.compat.load import load_generator_params as jax_load
from spgan_tpu.compat.load import save_params_npz as jax_save_params_npz
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.compat.load import (load_generator_params,
                                         save_params_npz)
from spgan_tpu_torch.train.checkpoint import (CheckpointLayoutError,
                                              CheckpointManager, state_tensors)
from spgan_tpu_torch.train.loop import iteration_generator
from spgan_tpu_torch.train.state import create_train_state
from spgan_tpu_torch.train.step import make_train_step
from spgan_tpu_torch.tree import flatten
from test_torch_train import _models

B = 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and a process per core's worth of spinning threads each slows
    them all several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    (jcfg, jg, _), (cfg, g, d) = _models()
    step = make_train_step(cfg, g, d)
    rng = np.random.RandomState(0)
    batches = [(torch.tensor(rng.uniform(-1, 1, (B, 101, 101, 3))
                             .astype(np.float32)),
                torch.tensor(rng.uniform(-1, 1, (B, 3)).astype(np.float32)))
               for _ in range(2)]
    s0 = create_train_state(cfg, g, d, torch.Generator().manual_seed(0),
                            device="cpu")
    states = [s0]
    for it, (patch, ac) in enumerate(batches):
        s, _ = step(states[-1], patch, ac, iteration_generator(3, it, "cpu"),
                    do_r1=it == 0, do_ppl=it == 1)
        states.append(s)
    return dict(cfg=cfg, g=g, d=d, jcfg=jcfg, jg=jg, step=step,
                batches=batches, states=states)


def _template(tiny, seed=9):
    return create_train_state(tiny["cfg"], tiny["g"], tiny["d"],
                              torch.Generator().manual_seed(seed),
                              device="cpu")


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert torch.equal(a.mean_path_length, b.mean_path_length)
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k], tb[k]), k


def test_round_trip_is_exact(tiny, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    saved = tiny["states"][2]
    mgr.save(saved.step, saved)
    _assert_states_equal(mgr.restore(_template(tiny)), saved)
    keys = state_tensors(saved)
    assert any(k.startswith("opt_d/count/") for k in keys)
    assert any(k.startswith("params_g_ema/ss/") for k in keys)


def test_max_to_keep_and_latest_step(tiny, tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_template(tiny))
    for step in (10, 20, 30):
        mgr.save(step, tiny["states"][1])
    (tmp_path / "ckpt" / ".40.abc.tmp").write_bytes(b"cut short")
    assert mgr.steps() == [20, 30] and mgr.latest_step() == 30
    assert mgr.restore(_template(tiny)).step == 1  # the state's own
    mgr.save(40, tiny["states"][2])
    assert mgr.steps() == [30, 40]


def test_stale_layout_raises(tiny, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tiny["states"][1])
    t = _template(tiny)
    t.opt_g.count["ts"]["mapping"][0]["weight_extra"] = torch.zeros(())
    with pytest.raises(CheckpointLayoutError, match="OPTIMIZER") as e:
        mgr.restore(t)
    assert "opt_g/count/ts/mapping/0/weight_extra" in str(e.value)
    t = _template(tiny)
    t.params_g_ema["ss"]["blocks"][0]["sphere"]["conv"]["weight"] = \
        torch.zeros(1, 2, 3, 3)
    with pytest.raises(CheckpointLayoutError, match="differ in shape") as e:
        mgr.restore(t)
    assert "OPTIMIZER" not in str(e.value)


def test_resumed_step_equals_the_uninterrupted_one(tiny, tmp_path):
    """Save after iteration 0, restore into a template of other weights,
    and take iteration 1 on the same batch: bit-equal to the run that was
    not interrupted."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tiny["states"][1])
    resumed = mgr.restore(_template(tiny))
    _assert_states_equal(resumed, tiny["states"][1])
    patch, ac = tiny["batches"][1]
    s2, _ = tiny["step"](resumed, patch, ac,
                         iteration_generator(3, resumed.step, "cpu"),
                         do_r1=False, do_ppl=True)
    _assert_states_equal(s2, tiny["states"][2])


def test_npz_export_matches_jax(tiny, tmp_path):
    jparams = tiny["jg"].init(jax.random.PRNGKey(4))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_params_npz(ours, params)
    jax_save_params_npz(theirs, jparams)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype == np.float32, k
            assert a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = dict(flatten(jax.tree_util.tree_map(
        np.asarray, jax_load(ours, tiny["jg"]))))
    want = dict(flatten(jax.tree_util.tree_map(np.asarray, jparams)))
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_generator_from_port_checkpoints(tiny, tmp_path):
    """The infer path's loader reads a checkpoint directory (the newest)
    and a single checkpoint file as the run's EMA generator."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tiny["states"][1])
    mgr.save(2, tiny["states"][2])
    want = dict(flatten(tiny["states"][2].params_g_ema))
    for path in (str(tmp_path), mgr.path(2)):
        got = dict(flatten(load_generator_params(path, tiny["g"],
                                                 device="cpu")))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)


def test_port_checkpoint_file_loads_weights_only(tiny, tmp_path,
                                                 monkeypatch):
    """A port checkpoint file (<step>.pt) is never unpickled with
    weights_only=False on its way to the infer path."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tiny["states"][1])
    calls, load = [], torch.load

    def spy(*args, **kwargs):
        calls.append(kwargs.get("weights_only"))
        return load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", spy)
    got = dict(flatten(load_generator_params(mgr.path(1), tiny["g"],
                                             device="cpu")))
    assert calls == [True]
    want = dict(flatten(tiny["states"][1].params_g_ema))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
