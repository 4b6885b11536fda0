"""A tiny copy of the benchmark's files for CPU tests: the real metric
readers and the real cells' limits, a configuration cut in every width
(test-only), and one cell per timed loop at a few patches."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import harness

TINY_TRAIN_PARAMS = {
    "global_latent_dim": 32, "local_latent_dim": 16, "channel_multiplier": 1,
    "n_mlp": 2, "ss_n_layers": 2, "batch_size": 4, "d_extra_multiplier": 0.125,
}
TASK = {"height": 384, "width": 768, "batch_size": 2, "patch_chunk": 4}
LATTICE = {"close_loop": True, "dedup_wrap": True}
# each tiny cell is held to the limits of the real cell of its kind
LIMITS_OF = {"float32": {"render-tiny": "render-planar-f32"},
             "bfloat16": {"render-tiny": "render-360-bf16"}}


def tiny_config(dtype: str) -> dict:
    """At these widths the cells' panoramas run some 25 times the
    calibration panorama's root mean square: a low target keeps most of
    their pixels inside [-1, 1], where a comparison can see them."""
    return {"train_params": dict(TINY_TRAIN_PARAMS, compute_dtype=dtype),
            "ts_channel_base": 16, "assumed": {"to_rgb_rms": 0.02}}


def make_root(tmp: Path, dtype: str = "float32") -> Path:
    """A benchmark root under tmp with the cells render-tiny (on a
    configuration of `dtype`) and train-tiny (float32), and its manifest
    in tmp/BENCHMARK.json."""
    root = tmp / "portbench"
    shutil.copytree(harness.HERE / "metrics", root / "metrics")
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True)
    for name, dt in (("tiny", dtype), ("tiny-f32", "float32")):
        (root / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(dt)))
    traffic = {
        "render-tiny": {"loop": "render", "task": TASK, "lattice": LATTICE,
                        "traced_units": 1, "check_images": 4},
        "train-tiny": {"loop": "train", "start_iteration": 100000,
                       "traced_cycles": 1}}
    limits = dict(LIMITS_OF[dtype], **{"train-tiny": "train-f32-lazyreg"})
    for cell, tr in traffic.items():
        (root / "traffic" / f"{cell}.json").write_text(json.dumps(tr))
        shutil.copy(harness.HERE / "limits" / f"{limits[cell]}.json",
                    root / "limits" / f"{cell}.json")
    real = {"render-360-bf16": "render-tiny", "render-planar-f32":
            "render-tiny", "train-f32-lazyreg": "train-tiny"}
    manifest = harness.load_manifest()
    manifest["workloads"] = [
        {"name": c, "config": "tiny-f32" if c == "train-tiny" else "tiny",
         "traffic": c, "chips": 1, "why": "test"} for c in traffic]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({real[w] for w in m["workloads"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run(root: Path, workload: str, seed: int = 7, trace: bool = False,
        seconds: float = 0.0) -> dict:
    manifest = json.loads((root.parent / "BENCHMARK.json").read_text())
    return harness.run_cell(workload, seed, seconds, trace,
                            t0=time.perf_counter(), device="cpu",
                            manifest=manifest, root=root)[0]
