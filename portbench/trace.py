"""The traced stretch of a `--trace 1` run: torch.profiler over a few
steady units, reduced to the records the per-layer readers take.

Records (a plain dict; a reader takes what it needs and returns None when
its part is missing):

  kernels        {name: [device seconds, launches]} of every device
                 operation in the traced stretch
  busy_s         union of the device intervals, seconds
  wall_s         the traced stretch's wall time (host clock)
  n_kernels      device operations in the traced stretch
  sphere_conv    [(B, H, W, C, Cout, K2), ...] of each sphere-conv kernel
                 launch in the traced stretch (the program's wrapper
                 arguments)
  sphere_sample  [(B, H, W, C, K2, element bytes), ...] of each tap-sampler
                 launch in the traced stretch

The timed loops add the cell's own: the untraced stretch's units and seconds,
the FLOPs of a unit, the peaks of the cell's dtype.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

TOP = 10
NAME = 160   # characters of an operation's name kept in the breakdown


@contextlib.contextmanager
def launch_shapes(records: dict):
    """Record the operand shapes of each launch of the program's two
    hand-written kernels (their wrappers' `_launch`), while inside."""
    conv, sample = [], []
    records["sphere_conv"], records["sphere_sample"] = conv, sample
    patched = []
    try:
        from spgan_tpu_torch.ops.kernels import sphere_kernel, sphere_sample
    except ImportError:
        yield
        return

    def wrap(mod, rec):
        orig = getattr(mod, "_launch", None)
        if orig is None:
            return

        def launch(x, tables, *args, **kw):
            B, H, W, C = x.shape
            K2 = tables["y0"].shape[-1]
            if rec is conv:
                rec.append((B, H, W, C, int(args[0].shape[-1]), K2))
            else:
                rec.append((B, H, W, C, K2, x.element_size()))
            return orig(x, tables, *args, **kw)

        mod._launch = launch
        patched.append((mod, orig))

    wrap(sphere_kernel, conv)
    wrap(sphere_sample, sample)
    try:
        yield
    finally:
        for mod, orig in patched:
            mod._launch = orig


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _host_labels(cpu: List[Tuple[int, int, str]],
                 gaps: List[Tuple[int, int]]) -> List[str]:
    """What the host was doing in each gap (lo, hi): the innermost host
    event that covers the gap's middle, under the outermost benchmark span
    (`bench.*`) that covers it."""
    if not cpu:
        return ["(no host event)"] * len(gaps)
    start = np.array([c[0] for c in cpu], np.int64)
    end = np.array([c[1] for c in cpu], np.int64)
    out = []
    for lo, hi in gaps:
        mid = (lo + hi) // 2
        cover = [(int(end[i] - start[i]), cpu[i][2])
                 for i in np.nonzero((start <= mid) & (mid <= end))[0]]
        if not cover:
            out.append("(no host event)")
            continue
        spans = [c for c in cover if c[1].startswith("bench.")]
        inner = min(cover)[1]
        outer = max(spans)[1] if spans else None
        out.append(inner if outer in (None, inner) else f"{outer} > {inner}")
    return out


def _events(prof):
    """(start ns, end ns, name, on the device) of every event the
    profiler recorded, read from its raw results: building its
    FunctionEvent tree takes minutes for a training cycle's ~10^6
    events."""
    skip = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
            "profiler::_record_function_enter_new",
            "profiler::_record_function_exit"}
    cuda = torch.autograd.DeviceType.CUDA
    for k in prof.profiler.kineto_results.events():
        name = k.name()
        if name not in skip:
            yield k.start_ns(), k.end_ns(), name, k.device_type() == cuda


def profile(run: Callable[[], None], records: dict,
            sync: Optional[Callable[[], None]] = None) -> Dict[str, list]:
    """Run `run` under torch.profiler (host and device activity) with the
    kernels' launch shapes recorded; fill `records` and return the
    breakdown: the device operations that took most time and the longest
    device-idle gaps by what the host was doing."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync = sync or torch.cuda.synchronize
    sync()
    with launch_shapes(records):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            records["wall_s"] = time.perf_counter() - t0
    dev, cpu = [], []
    for s, t, name, on_device in _events(prof):
        if name.startswith("bench."):
            # the benchmark's own spans, which the profiler also draws on
            # the device's timeline
            if not on_device:
                cpu.append((s, t, name))
        elif on_device:
            dev.append((s, t, name))
        else:
            cpu.append((s, t, name))
    kernels: Dict[str, list] = {}
    for s, t, n in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (t - s) / 1e9
        k[1] += 1
    busy = _union([(s, t) for s, t, _ in dev])
    records["kernels"] = kernels
    records["busy_s"] = sum(t - s for s, t in busy) / 1e9
    records["n_kernels"] = len(dev)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    labels = _host_labels(cpu, [(lo, hi) for _, lo, hi in gaps])
    return {"device_ops": [[n[:NAME], v[0]] for n, v in top],
            "idle_gaps": [[label, d / 1e9]
                          for label, (d, _, _) in zip(labels, gaps)]}


def span(name: str):
    """A named host span around a call into one layer (visible in the
    traced stretch; a no-op cost outside the profiler)."""
    return torch.profiler.record_function(f"bench.{name}")
