"""The program's own spans (spgan_tpu_torch/utils/trace.py) joined with the
profiler's device timeline: for each span name in a traced stretch, its
count, host seconds, device seconds and device-idle seconds.

  device   a device operation belongs to the innermost span whose host
           interval holds the start of its launch: the runtime call with
           the operation's correlation id, on whichever thread made it
           (torch.autograd.grad launches the backward from autograd's
           device thread while the calling thread waits inside the span)
  idle     the stretch's idle stretches, the gaps between the union of
           the device intervals and the lead and the tail of the stretch
           (bounded by the tracer's enable and disable instants), each
           whole to the innermost span open on the main thread at its
           midpoint

What no span holds is filed under "(outside)", so device and idle seconds
summed over the names close on the stretch's.  `roots` sums the same
seconds by the outermost span (a whole generate, a whole training step).

Reading the traced stretch of a cell with the tracer on:

    python3 -m portbench.spans --turns 2 --workload <cell> --seed <n> \\
        --seconds <s> --trace 1

runs the cell as `python3 -m portbench.run` does, with the tracer on
across its traced stretch (the device copies of the spans left out of the
breakdown, so the other readings are as with it off).  After that
stretch, so that their sessions leave nothing behind in it, the stretch
runs `--turns` pairs of times more under the profiler, tracer off and on
in turns (off, on, on, off, ...), for the tracer's cost.  After the
result line it prints one more: the span table, the five span readings,
the distances between the spans' starts and their profiler copies'
(median and largest), and the turns' walls.
"""
from __future__ import annotations

import bisect
import gc
import json
import sys
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.trace import _union

OUTSIDE = "(outside)"
# host events of the CUDA APIs (cudaLaunchKernel, cudaMemcpyAsync,
# cuLaunchKernel, ...): the launches, whose correlation ids the device
# operations carry
LAUNCH_PREFIX = "cu"


class Collector:
    """What the join reads from the profiler's raw events, gathered as
    they stream past: device operations (start, end, correlation id),
    runtime launches (correlation id -> host start) and the host copies
    of the program's spans (name, start)."""

    def __init__(self):
        self.device: List[Tuple[int, int, int]] = []
        self.launches: Dict[int, int] = {}
        self.copies: List[Tuple[str, int]] = []

    def feed(self, events):
        """Pass the raw events on, taking what the join needs and
        dropping the device copies of the program's spans."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        for k in events:
            name = k.name()
            if k.device_type() == cuda:
                if name.startswith("spgan."):
                    continue
                if not name.startswith("bench."):
                    self.device.append((k.start_ns(), k.end_ns(),
                                        k.correlation_id()))
            elif name.startswith(LAUNCH_PREFIX):
                self.launches[k.correlation_id()] = k.start_ns()
            elif name.startswith("spgan."):
                self.copies.append((name, k.start_ns()))
            yield k


def _tee(prof, sink: Collector):
    """A stand-in for `prof` whose raw events stream through `sink`."""
    results = SimpleNamespace(
        events=lambda: sink.feed(prof.profiler.kineto_results.events()))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _depths(spans: Sequence[dict]) -> List[int]:
    out: List[int] = []
    for r in spans:
        out.append(0 if r["parent"] < 0 else out[r["parent"]] + 1)
    return out


class _Innermost:
    """The innermost of a set of spans at any instant: the deepest span
    whose [start, end) holds it, by the stretches between consecutive
    span boundaries."""

    def __init__(self, spans: Sequence[dict], idx: Sequence[int],
                 depth: Sequence[int]):
        pts = sorted({spans[i]["start_ns"] for i in idx}
                     | {spans[i]["end_ns"] for i in idx})
        self.pts, self.owner = pts, []
        for a in pts[:-1]:
            best = -1
            for i in idx:
                r = spans[i]
                if r["start_ns"] <= a < r["end_ns"] and (
                        best < 0 or depth[i] > depth[best]):
                    best = i
            self.owner.append(best)

    def __call__(self, t: int) -> int:
        k = bisect.bisect_right(self.pts, t) - 1
        return self.owner[k] if 0 <= k < len(self.owner) else -1


def attribute(device: Sequence[Tuple[int, int, int]],
              launches: Dict[int, int], spans: Sequence[dict],
              t0: int, t1: int, main_thread: Optional[int] = None) -> dict:
    """Join a traced stretch [t0, t1] (Unix ns): device operations (start,
    end, correlation id), runtime launches (correlation id -> host
    start), and the tracer's records (trace.records(): name, start_ns,
    end_ns, parent, thread).  Returns

      names     {span name or OUTSIDE: {count, host_s, device_s, idle_s}},
                each operation and gap to the innermost span only
      roots     {outermost span name or OUTSIDE: {device_s, idle_s}}
      device_s  the operations' summed seconds; idle_s the stretch's idle
      unlinked  operations with no launch among the host events (filed
                under OUTSIDE)
    """
    # a span still open ends with the stretch
    spans = [r if r["end_ns"] is not None else dict(r, end_ns=t1)
             for r in spans]
    depth = _depths(spans)
    root = []
    for i, r in enumerate(spans):
        root.append(i if r["parent"] < 0 else root[r["parent"]])
    names = {r["name"] for r in spans} | {OUTSIDE}
    table = {n: {"count": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0}
             for n in sorted(names)}
    roots = {n: {"device_s": 0.0, "idle_s": 0.0} for n in sorted(
        {spans[i]["name"] for i in set(root)} | {OUTSIDE})}
    for r in spans:
        table[r["name"]]["count"] += 1
        table[r["name"]]["host_s"] += (r["end_ns"] - r["start_ns"]) / 1e9

    def file(i: int, key: str, seconds: float) -> None:
        table[spans[i]["name"] if i >= 0 else OUTSIDE][key] += seconds
        roots[spans[root[i]]["name"] if i >= 0 else OUTSIDE][key] += seconds

    everywhere = _Innermost(spans, range(len(spans)), depth)
    unlinked = 0
    for s, e, corr in device:
        at = launches.get(corr)
        if at is None:
            unlinked += 1
        file(everywhere(at) if at is not None else -1, "device_s",
             (e - s) / 1e9)
    main = _Innermost(spans, [i for i, r in enumerate(spans)
                              if main_thread is None
                              or r["thread"] == main_thread], depth)
    busy = _union([(max(s, t0), min(e, t1)) for s, e, _ in device
                   if e > t0 and s < t1])
    edges = [t0] + [x for b in busy for x in b] + [t1]
    idle = 0
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi > lo:
            idle += hi - lo
            file(main((lo + hi) // 2), "idle_s", (hi - lo) / 1e9)
    return {"names": table, "roots": roots,
            "device_s": sum(e - s for s, e, _ in device) / 1e9,
            "idle_s": idle / 1e9, "unlinked": unlinked}


def readings(att: dict, counters: Dict[str, int]) -> Dict[str, float]:
    """The span readings of a traced stretch: per batch of the engine
    (spgan.engine.batches) or per training iteration (spgan.train.steps),
    whichever the stretch counted."""
    n, r = att["names"], att["roots"]

    def get(table, name, key):
        return table.get(name, {}).get(key, 0.0)

    out: Dict[str, float] = {}
    batches = counters.get("spgan.engine.batches", 0)
    if batches:
        gen = "spgan.engine.generate"
        out["engine.to_uint8_idle_ms"] = 1e3 * get(
            n, "spgan.engine.to_uint8", "idle_s") / batches
        out["engine.generate_idle_ms"] = 1e3 * get(r, gen, "idle_s") / batches
        prep = sum(get(n, f"spgan.engine.{k}", "device_s")
                   for k in ("fields", "chunk_inputs", "scatter"))
        if get(r, gen, "device_s") > 0:
            out["engine.prep_device_share"] = 100.0 * prep / get(
                r, gen, "device_s")
    steps = counters.get("spgan.train.steps", 0)
    if steps:
        out["train.reg_device_ms"] = 1e3 * sum(
            get(n, f"spgan.train.{k}", "device_s")
            for k in ("r1", "ppl")) / steps
        out["train.update_ms"] = 1e3 * sum(
            get(n, f"spgan.train.{k}", key) for k in ("update", "ema")
            for key in ("device_s", "idle_s")) / steps
    return out


def start_offsets_us(spans: Sequence[dict],
                     copies: Sequence[Tuple[str, int]]) -> List[float]:
    """The distance, in µs, between each span's start and its profiler
    copy's (the k-th of a name against the k-th), in order."""
    out: List[float] = []
    for name in {r["name"] for r in spans}:
        a = sorted(r["start_ns"] for r in spans if r["name"] == name)
        b = sorted(t for n, t in copies if n == name)
        out += [abs(x - y) / 1e3 for x, y in zip(a, b)]
    return sorted(out)


def table_lines(att: dict) -> List[str]:
    rows = sorted(att["names"].items(), key=lambda kv: -kv[1]["device_s"])
    out = [f"{'span':32s} {'count':>6s} {'host ms':>10s} "
           f"{'device ms':>10s} {'idle ms':>10s}"]
    for name, v in rows:
        out.append(f"{name:32s} {v['count']:6d} {1e3 * v['host_s']:10.3f} "
                   f"{1e3 * v['device_s']:10.3f} {1e3 * v['idle_s']:10.3f}")
    return out


def _turns(run, sync, n: int) -> Dict[str, List[float]]:
    """The traced stretch's wall under the profiler, tracer off and on in
    turns (off, on, on, off, ...; n pairs)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from spgan_tpu_torch.utils import trace as tracer

    walls: Dict[str, List[float]] = {"off": [], "on": []}
    for i in range(2 * n):
        on = i % 4 in (1, 2)
        gc.collect()
        sync()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]):
            t = time.perf_counter()
            if on:
                tracer.enable()
            run()
            sync()
            if on:
                tracer.disable()
            walls["on" if on else "off"].append(time.perf_counter() - t)
        tracer.reset()
    return walls


def with_spans(profile, out: dict, turns: int = 0):
    """`portbench.trace.profile` with the tracer on across the traced
    stretch; the join lands in `out`."""
    from portbench import trace
    from spgan_tpu_torch.utils import trace as tracer

    def wrapped(run, records, sync=None):
        import torch

        sync = sync or torch.cuda.synchronize
        sink, box = Collector(), {}

        def traced():
            box["t0"] = tracer.enable()
            run()
            sync()
            box["t1"] = tracer.disable()

        tracer.reset()
        events = trace._events
        trace._events = lambda prof: events(_tee(prof, sink))
        try:
            breakdown = profile(traced, records, sync)
        finally:
            trace._events = events
        spans = tracer.records()
        att = attribute(sink.device, sink.launches, spans, box["t0"],
                        box["t1"], threading.main_thread().ident)
        counters = tracer.counters()
        offsets = start_offsets_us(spans, sink.copies)
        out.update(table=att, counters=counters,
                   readings=readings(att, counters),
                   start_offset_us={
                       "n": len(offsets),
                       "median": offsets[len(offsets) // 2] if offsets
                       else None,
                       "max": offsets[-1] if offsets else None},
                   wall_s=records["wall_s"])
        for line in table_lines(att):
            print(f"[spans] {line}", file=sys.stderr, flush=True)
        if turns:
            out["turns"] = _turns(run, sync, turns)
        return breakdown

    return wrapped


def main(argv=None) -> int:
    import argparse

    from portbench import run, trace

    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    ap.add_argument("--turns", type=int, default=0)
    args, rest = ap.parse_known_args(argv)
    out: dict = {}
    trace.profile = with_spans(trace.profile, out, args.turns)
    rc = run.main(rest)
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
