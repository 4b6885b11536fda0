"""The join of the program's spans with the device timeline
(portbench/spans.py) on synthetic events, and the traced stretch's other
records unchanged by it."""
from __future__ import annotations

import contextlib
import random
from types import SimpleNamespace

import pytest
import torch

from portbench import spans, trace

MAIN, SIDE = 1, 2


def _span(name, start, end, parent=-1, thread=MAIN):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "unit": None, "thread": thread}


def _synthetic():
    """A generate (0-100) with one chunk (10-50), a to_uint8 (100-150), a
    span of another thread (120-140); operations launched in the chunk,
    in the generate, with no launch event, and after every span."""
    recs = [_span("spgan.engine.generate", 0, 100),
            _span("spgan.engine.chunk_inputs", 10, 50, parent=0),
            _span("spgan.engine.to_uint8", 100, 150),
            _span("spgan.side", 120, 140, thread=SIDE)]
    device = [(30, 60, 1), (70, 90, 2), (80, 85, 3), (165, 170, 4)]
    launches = {1: 20, 2: 55, 4: 160}
    return recs, device, launches


def test_attribute_synthetic():
    recs, device, launches = _synthetic()
    att = spans.attribute(device, launches, recs, 0, 200, main_thread=MAIN)
    n = {k: (v["device_s"] * 1e9, v["idle_s"] * 1e9)
         for k, v in att["names"].items()}
    # the chunk's launch is on no thread of the spans: its start decides
    assert n["spgan.engine.chunk_inputs"] == pytest.approx((30, 30))
    assert n["spgan.engine.generate"] == pytest.approx((20, 10))
    # the gap after the last operation of the generate, whose midpoint
    # the side thread's span also holds, goes to the main thread's span
    assert n["spgan.engine.to_uint8"] == pytest.approx((0, 75))
    assert n["spgan.side"] == pytest.approx((0, 0))
    # no launch event, a launch after every span, the stretch's tail
    assert n[spans.OUTSIDE] == pytest.approx((10, 30))
    assert att["unlinked"] == 1
    assert att["roots"]["spgan.engine.generate"]["device_s"] * 1e9 == \
        pytest.approx(50)
    assert att["names"]["spgan.engine.generate"]["count"] == 1
    assert att["names"]["spgan.engine.generate"]["host_s"] * 1e9 == \
        pytest.approx(100)


def test_attribute_without_device_work_is_all_idle():
    recs, _, _ = _synthetic()
    att = spans.attribute([], {}, recs, -50, 200, main_thread=MAIN)
    assert att["device_s"] == 0
    assert att["idle_s"] * 1e9 == pytest.approx(250)
    # the whole stretch is one gap, whose midpoint (75) is the generate's
    assert att["names"]["spgan.engine.generate"]["idle_s"] * 1e9 == \
        pytest.approx(250)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribute_totals_close(seed):
    rng = random.Random(seed)
    recs, t = [], 1000
    for _ in range(5):
        top = len(recs)
        recs.append(_span("spgan.engine.generate", t, t + 900))
        for c in range(3):
            recs.append(_span("spgan.engine.chunk_inputs", t + 100 + 250 * c,
                              t + 200 + 250 * c, parent=top))
        t += 1000
    device, launches = [], {}
    for corr in range(1, 200):
        s = rng.randrange(0, t + 500)
        device.append((s, s + rng.randrange(1, 80), corr))
        if rng.random() < 0.9:
            launches[corr] = max(0, s - rng.randrange(0, 400))
    att = spans.attribute(device, launches, recs, 0, t + 700)
    busy = sum(e - s for s, e in trace._union([(s, e) for s, e, _ in device]))
    assert sum(v["device_s"] for v in att["names"].values()) == \
        pytest.approx(att["device_s"], rel=1e-12)
    assert sum(v["idle_s"] for v in att["names"].values()) == \
        pytest.approx(att["idle_s"], rel=1e-12)
    assert att["idle_s"] * 1e9 == pytest.approx(t + 700 - busy)
    assert sum(v["device_s"] for v in att["roots"].values()) == \
        pytest.approx(att["device_s"], rel=1e-12)


def test_readings():
    recs, device, launches = _synthetic()
    att = spans.attribute(device, launches, recs, 0, 200, main_thread=MAIN)
    r = spans.readings(att, {"spgan.engine.batches": 2})
    assert r["engine.to_uint8_idle_ms"] == pytest.approx(75e-6 / 2)
    assert r["engine.generate_idle_ms"] == pytest.approx(40e-6 / 2)
    assert r["engine.prep_device_share"] == pytest.approx(60.0)
    assert "train.update_ms" not in r


class _Event:
    def __init__(self, name, start, end, on_device, activity, corr=0):
        self._v = (name, start, end, on_device, activity, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[5]


def _events(annotated):
    ev = [_Event("bench.generate", 0, 400, False, "user_annotation"),
          _Event("bench.generate", 5, 390, True, "gpu_user_annotation"),
          _Event("aten::mm", 10, 30, False, "cpu_op", 7),
          _Event("cudaLaunchKernel", 15, 20, False, "cuda_runtime", 11),
          _Event("gemm_kernel", 40, 90, True, "kernel", 11),
          _Event("cudaLaunchKernel", 100, 104, False, "cuda_runtime", 12),
          _Event("add_kernel", 150, 160, True, "kernel", 12),
          _Event("Memcpy DtoH (Device -> Pageable)", 300, 380, True,
                 "gpu_memcpy", 13)]
    if annotated:
        ev += [_Event("spgan.engine.generate", 12, 200, False,
                      "user_annotation"),
               _Event("spgan.engine.generate", 38, 170, True,
                      "gpu_user_annotation")]
    return ev


def _fake_profiler(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: iter(events))))

    @contextlib.contextmanager
    def fake(**kw):
        yield prof

    return fake


def test_profile_records_unchanged_by_the_spans(monkeypatch):
    got, events = [], trace._events
    for annotated in (False, True):
        monkeypatch.setattr(torch.profiler, "profile",
                            _fake_profiler(_events(annotated)))
        records = {}
        profile, out = trace.profile, {}
        if annotated:
            profile = spans.with_spans(trace.profile, out)
        profile(lambda: None, records, sync=lambda: None)
        got.append({k: records[k] for k in ("kernels", "busy_s",
                                             "n_kernels")})
    assert got[0] == got[1]
    assert got[0]["n_kernels"] == 3
    assert trace._events is events and out["table"]["device_s"] > 0
    assert "spgan.engine.generate" not in got[1]["kernels"]


def test_start_offsets():
    recs = [_span("spgan.a", 5000, 6000), _span("spgan.a", 1000, 2000),
            _span("spgan.b", 3000, 3100)]
    copies = [("spgan.a", 1020), ("spgan.a", 4990), ("spgan.b", 3004)]
    assert spans.start_offsets_us(recs, copies) == pytest.approx(
        [0.004, 0.01, 0.02])
    assert spans.start_offsets_us(recs, []) == []


@pytest.mark.parametrize("cell", ["render-tiny", "train-tiny"])
def test_traced_cell_with_spans(tmp_path, monkeypatch, cell):
    """A tiny cell's traced run with the tracer on (on the CPU: no device
    operation, so the whole stretch is idle): every batch or iteration
    recorded, its profiler copy found, the existing readings intact."""
    from portbench.tests import tiny

    root, out = tiny.make_root(tmp_path), {}
    monkeypatch.setattr(trace, "profile", spans.with_spans(trace.profile, out))
    r = tiny.run(root, cell, trace=True)
    names = out["table"]["names"]
    if cell == "render-tiny":
        assert names["spgan.engine.generate"]["count"] == 1
        assert out["counters"]["spgan.engine.batches"] == 1
        assert set(out["readings"]) >= {"engine.to_uint8_idle_ms",
                                        "engine.generate_idle_ms"}
        assert "engine.launches_per_image" in r["metrics"]
    else:
        assert names["spgan.train.step"]["count"] == 16
        assert out["counters"]["spgan.train.steps"] == 16
        assert names["spgan.train.r1"]["count"] == 1
        assert names["spgan.train.ppl"]["count"] == 4
        assert set(out["readings"]) == {"train.reg_device_ms",
                                        "train.update_ms"}
    assert out["table"]["device_s"] == 0
    assert out["table"]["idle_s"] == pytest.approx(
        sum(v["idle_s"] for v in names.values()))
    offsets = out["start_offset_us"]
    assert offsets["n"] == sum(v["count"] for v in names.values())
    assert 0 <= offsets["median"] <= offsets["max"]
