"""The port's tracer (spgan_tpu_torch/utils/trace.py) on tiny CPU configs:
the shared no-op while off, the engine's and the training step's spans
while on, results unchanged by tracing, and the exported clock."""
import time

import numpy as np
import pytest
import torch

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.managers import to_uint8
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.train import state as tstate
from spgan_tpu_torch.train.step import make_train_step
from spgan_tpu_torch.tree import tree_leaves
from spgan_tpu_torch.utils import trace
from helpers.port_tiny import narrow, tiny, train_models


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _engine():
    cfg = tiny(Config())
    g = narrow(Generator.from_config(cfg))
    plan = build_close_loop_plan(g, cfg.task.height, cfg.task.width)
    eng = PanoramaEngine(g=g, plan=plan, batch=1, patch_chunk=4,
                         device="cpu")
    return eng, g.init(torch.Generator().manual_seed(0), device="cpu")


def _children(recs, i):
    return [j for j, r in enumerate(recs) if r["parent"] == i]


def test_off_span_is_the_shared_noop_and_counters_count():
    a, b = trace.span("spgan.a"), trace.span("spgan.b", unit=3)
    assert a is b is trace._NULL
    with a:
        with b:
            pass
    assert trace.records() == []
    assert trace.count("spgan.test.n") == 1
    assert trace.count("spgan.test.n", 4) == 5
    assert trace.counters()["spgan.test.n"] == 5


def test_engine_spans_per_batch():
    eng, params = _engine()
    n_chunks = len(eng._render_idx) // eng.patch_chunk
    trace.enable()
    for seed in (1, 2):
        meta = eng.generate(params, torch.Generator().manual_seed(seed))
        to_uint8(eng.crop_to_target(meta).numpy())
    trace.disable()
    recs = trace.records()
    gens = [i for i, r in enumerate(recs) if r["name"] == "spgan.engine.generate"]
    assert len(gens) == 2
    assert [recs[i]["unit"] for i in gens] == [1, 2]
    assert trace.counters()["spgan.engine.batches"] == 2
    for i in gens:
        assert recs[i]["parent"] == -1
        kids = [recs[j]["name"] for j in _children(recs, i)]
        assert kids.count("spgan.engine.chunk_inputs") == n_chunks
        assert kids.count("spgan.generator.ss") == n_chunks
        assert kids.count("spgan.generator.ts") == n_chunks
        assert kids.count("spgan.engine.scatter") == 1
        assert "spgan.engine.fields" in kids
        under = [j for j, r in enumerate(recs)
                 if r["start_ns"] >= recs[i]["start_ns"]
                 and r["end_ns"] <= recs[i]["end_ns"]]
        assert {recs[j]["unit"] for j in under} == {recs[i]["unit"]}
        for j in under:
            assert recs[j]["thread"] == recs[i]["thread"]
    assert [r["name"] for r in recs].count("spgan.engine.to_uint8") == 2
    assert all(r["name"].startswith("spgan.") for r in recs)


def test_engine_output_unchanged_by_tracing():
    eng, params = _engine()
    off = eng.generate(params, torch.Generator().manual_seed(5))
    trace.enable()
    on = eng.generate(params, torch.Generator().manual_seed(5))
    trace.disable()
    assert torch.equal(off, on)
    assert trace.records()


def _train():
    cfg, g, d = train_models(Config, Generator, Discriminator, batch_size=4)
    state = tstate.create_train_state(cfg, g, d,
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
    rng = np.random.RandomState(1)
    real = torch.as_tensor(rng.uniform(-1, 1, (4, 101, 101, 3))
                           .astype(np.float32))
    ac = torch.as_tensor(rng.uniform(-1, 1, (4, 3)).astype(np.float32))
    return make_train_step(cfg, g, d), state, real, ac


def test_train_step_spans_follow_the_schedule():
    step, state, real, ac = _train()
    trace.enable()
    for do_r1, do_ppl in ((True, False), (False, True)):
        trace.reset()
        state, _ = step(state, real, ac, torch.Generator().manual_seed(2),
                        do_r1, do_ppl)
        recs = trace.records()
        names = [r["name"] for r in recs]
        assert names[0] == "spgan.train.step"
        assert recs[0]["unit"] == state.step - 1
        assert {r["unit"] for r in recs} == {state.step - 1}
        assert all(r["parent"] == 0 for r in recs[1:])
        assert ("spgan.train.r1" in names) is do_r1
        assert ("spgan.train.ppl" in names) is do_ppl
        for n in ("spgan.train.draw", "spgan.train.d", "spgan.train.g",
                  "spgan.train.ema"):
            assert names.count(n) == 1
        assert names.count("spgan.train.update") == 3
        assert "spgan.train.all_reduce" not in names
    trace.disable()
    assert trace.counters()["spgan.train.steps"] == 1


def test_train_state_unchanged_by_tracing():
    step, state, real, ac = _train()
    off, m_off = step(state, real, ac, torch.Generator().manual_seed(3),
                      True, True)
    trace.enable()
    on, m_on = step(state, real, ac, torch.Generator().manual_seed(3),
                    True, True)
    trace.disable()
    trees = [(off.params_g, on.params_g), (off.params_d, on.params_d),
             (off.params_g_ema, on.params_g_ema)]
    trees += [(getattr(off, o).__dict__, getattr(on, o).__dict__)
              for o in ("opt_g", "opt_d")]
    for a, b in trees:
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert torch.equal(off.mean_path_length, on.mean_path_length)
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)


def test_exported_starts_on_the_unix_clock():
    t_enable = trace.enable()
    before = time.time_ns()
    with trace.span("spgan.test.outer", unit=7):
        with trace.span("spgan.test.inner"):
            time.sleep(0.002)
    after = time.time_ns()
    t_disable = trace.disable()
    outer, inner = trace.records()
    assert inner["parent"] == 0 and outer["parent"] == -1
    assert inner["unit"] == outer["unit"] == 7
    for r in (outer, inner):
        assert abs(r["start_ns"] - before) < 1_000_000
        assert before - 1_000_000 < r["end_ns"] <= after + 1_000_000
    assert inner["end_ns"] - inner["start_ns"] >= 2_000_000
    assert t_enable <= outer["start_ns"] and outer["end_ns"] <= t_disable
