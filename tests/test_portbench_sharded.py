"""The four-rank cell's loop (portbench/loops/render_sharded.py) on the
CPU: four rank processes over gloo, at the portbench tiny widths, on the
cell's traffic cut to batch 2.  Rank 0's gathered images equal the folded
engine's bit for bit on the same weights and seeds, and the whole run
through the harness is `correct` against the plain reference; traced,
rank 0's records hold the program's spans, the all-gather among them."""
import json
import shutil
import time

import numpy as np
import pytest

from portbench import build, harness
from portbench.loops import render, render_sharded

# the portbench tiny widths in float32; at these widths a panorama runs
# some 25 times the calibration panorama's RMS, so a low target keeps its
# pixels inside [-1, 1], where a comparison sees them
TINY = {"train_params": {"global_latent_dim": 32, "local_latent_dim": 16,
                         "channel_multiplier": 1, "n_mlp": 2,
                         "ss_n_layers": 2, "compute_dtype": "float32"},
        "ts_channel_base": 16, "assumed": {"to_rgb_rms": 0.02}}
CELL = "sharded-tiny"


def _traffic() -> dict:
    tr = harness.load_data("traffic", "render-360-sharded")
    tr["task"] = dict(tr["task"], batch_size=2)
    tr.update(traced_units=1, check_images=4)
    return tr


@pytest.fixture
def root(tmp_path):
    """A benchmark root holding the tiny cell, held to the float32 render
    limits (limits/render-planar-f32.json), and its manifest."""
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE / "metrics", root / "metrics")
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (root / "traffic" / f"{CELL}.json").write_text(json.dumps(_traffic()))
    shutil.copy(harness.HERE / "limits" / "render-planar-f32.json",
                root / "limits" / f"{CELL}.json")
    manifest = harness.load_manifest()
    manifest["workloads"] = [{"name": CELL, "config": "tiny",
                              "traffic": CELL, "chips": 4, "why": "test"}]
    real = "scale-360-bf16-4chip"
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if real in m["workloads"] else []
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def _run(root, trace, monkeypatch):
    """harness.run_cell on the tiny cell; with rank 0's gathered sample
    and the scale the ranks were given."""
    kept = {}
    gathered = render_sharded.gathered

    def keep(ctx, scale, threads=0):
        kept["scale"] = scale
        kept["result"], kept["got"] = gathered(ctx, scale, threads)
        return kept["result"], kept["got"]

    monkeypatch.setattr(render_sharded, "gathered", keep)
    manifest = json.loads((root.parent / "BENCHMARK.json").read_text())
    r, out = harness.run_cell(CELL, 2 ** 40 + 11, 0.0, trace,
                              t0=time.perf_counter(), device="cpu",
                              manifest=manifest, root=root)
    return r, out, kept


def _folded(scale, sample, seed, config=TINY, device="cpu"):
    """The folded engine's uint8 crops of the sampled panoramas."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.managers import to_uint8
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models import generator as gen_mod

    tr = _traffic()
    cfg = build.make_config(Config, config, tr["task"])
    g = build.make_generator(gen_mod, cfg, config)
    eng = PanoramaEngine(
        g=g, plan=build_close_loop_plan(g, cfg.task.height, cfg.task.width),
        batch=cfg.task.batch_size, patch_chunk=cfg.task.patch_chunk,
        grid_partial=cfg.train_params.partial,
        compute_dtype=cfg.train_params.compute_dtype, dedup_wrap=True,
        device=device)
    params = build.generator_params(config, seed, device, scale)
    out = {}
    for k, bs in sample.items():
        meta = eng.generate(params, build.generator(seed, build.TAG_BATCH, k,
                                                    device=device))
        out[k] = to_uint8(eng.crop_to_target(meta).cpu().numpy())[bs]
    return out


def test_rank0_images_equal_the_folded_engine_bit_for_bit(root, monkeypatch):
    r, out, kept = _run(root, False, monkeypatch)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"images_per_s", "peak_mem_gib", "setup_s"}
    assert r["device"]["count"] == 4
    sample = {int(k): v for k, v in kept["result"]["sample"].items()}
    assert sample == render.sample_images(2 ** 40 + 11, r["attempted"] // 2,
                                          2, 4)
    want = _folded(kept["scale"], sample, 2 ** 40 + 11)
    assert set(kept["got"]) == set(want)
    for k in want:
        assert kept["got"][k].dtype == np.uint8
        np.testing.assert_array_equal(kept["got"][k], want[k])
    assert r["checks"]["mean_lsb"]["value"] <= 0.01


def test_traced_rank0_records_hold_the_all_gather(root, monkeypatch):
    r, out, _ = _run(root, True, monkeypatch)
    assert r["correct"] is True
    names = out.records["spans"]["names"]
    assert names["spgan.engine.all_gather"]["count"] == 1
    assert names["spgan.engine.generate"]["count"] == 1
    # 48 rendered positions over 4 ranks: 3 chunks of 4 on rank 0
    assert names["spgan.generator.ts"]["count"] == 3
    assert out.records["counters"]["spgan.engine.batches"] == 1
    assert out.records["traced_images"] == 2
    assert {"device_idle.render", "engine.all_gather_share"} <= set(
        r["metrics"])


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the world at once and the run with it."""
    ctx = harness.Context(
        workload=CELL, seed=1, seconds=0.0, trace=False, device="cpu",
        cell={}, config=dict(TINY, train_params=dict(
            TINY["train_params"], ts_input_size=12)),
        traffic=_traffic(), setup=harness.SetupClock(time.perf_counter(),
                                                     lambda _: None))
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="sharded world failed"):
        render_sharded.gathered(ctx, 1.0, threads=1)
    assert time.perf_counter() - t < 60
