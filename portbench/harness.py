"""The benchmark's frame: the manifest, the files found by name, the set-up
clock, the result line and the look for JAX.

A cell (`BENCHMARK.json` "workloads") names a configuration, found as
`configs/<config>.json`, and a traffic mix, found as
`traffic/<traffic>.json`.  The traffic file names its loop
(`loops/<loop>.py`, one of a few timed loops).  A per-layer metric is
`metrics/<name>.py`, a reader of the traced run's records with one
function, `read(records) -> float | None`.  Adding a cell, a configuration
or a metric is adding files and manifest entries: nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "spgan_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: `spgan_tpu_torch` is not
    `spgan_tpu`."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_manifest(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def load_data(kind: str, name: str, root: Path = HERE) -> dict:
    """configs/<name>.json or traffic/<name>.json under `root`."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load_metric(name: str, root: Path = HERE):
    """metrics/<name>.py as a module (the name may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no metric reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_loop(name: str):
    return importlib.import_module(f"portbench.loops.{name}")


def find_cell(manifest: dict, workload: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end_of(manifest: dict, workload: str) -> List[dict]:
    return [m for m in manifest["end_to_end"] if _listed(m, workload)]


def per_layer_of(manifest: dict, workload: str) -> List[dict]:
    """The per-layer metrics of a cell: those that list it, and those with
    no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(manifest, workload)}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


class SetupClock:
    """The set-up split: each phase's seconds on its own standard-error
    line as it ends; `total()` is from process start (`t0`), less the
    phases marked as not counted (the reference's own work)."""

    def __init__(self, t0: float, log: Callable[[str], None]):
        self.t0, self.log = t0, log
        self.last = t0
        self.phases: Dict[str, float] = {}
        self.uncounted = 0.0

    def mark(self, phase: str, counted: bool = True) -> None:
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self.last
        if not counted:
            self.uncounted += now - self.last
        self.log(f"[setup] {phase}: {now - self.last:.3f} s"
                 + ("" if counted else " (not in setup_s)"))
        self.last = now

    def total(self) -> float:
        return time.perf_counter() - self.t0 - self.uncounted


def within(value: float, limit: float) -> bool:
    """A number compared passes while it is no NaN and at most its
    limit."""
    return value == value and value <= limit


def print_checks(result: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, c in result["checks"].items():
        ok = within(c["value"], c["limit"])
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'FAILED'}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return within(self.value, self.limit)


@dataclass
class Outcome:
    """What a timed loop hands back to the frame."""
    end_to_end: Dict[str, float]
    records: Dict[str, Any]
    attempted: int
    failed: int
    checks: List[Check]
    device: Dict[str, Any]
    breakdown: Optional[dict] = None


@dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    cell: dict
    config: dict
    traffic: dict
    setup: SetupClock
    limits: dict = field(default_factory=dict)


def limits_of(workload: str, root: Path = HERE) -> dict:
    """The limits of a cell's checks: limits/<workload>.json, each with
    the readings it was set from."""
    return {k: v["limit"] for k, v in
            load_data("limits", workload, root)["checks"].items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", manifest: Optional[dict] = None,
             root: Path = HERE):
    """Run one cell once: (the result object of the last line, the
    loop's Outcome)."""
    manifest = load_manifest() if manifest is None else manifest
    cell = find_cell(manifest, workload)
    config = load_data("configs", cell["config"], root)
    traffic = load_data("traffic", cell["traffic"], root)
    ctx = Context(workload=workload, seed=seed, seconds=seconds, trace=trace,
                  device=device, cell=cell, config=config, traffic=traffic,
                  setup=SetupClock(t0, log),
                  limits=limits_of(workload, root))
    out: Outcome = load_loop(traffic["loop"]).run(ctx)
    if trace:
        metrics = {}
        for m in per_layer_of(manifest, workload):
            value = load_metric(m["name"], root).read(out.records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in end_to_end_of(manifest, workload)
                   if m["name"] in out.end_to_end}
    correct = (all(c.ok for c in out.checks) and out.failed == 0
               and bool(out.checks))
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": out.device}
    if trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return result, out
