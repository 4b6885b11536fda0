"""The port's panorama server (spgan_tpu_torch/serve.py) on the CPU,
against the JAX package's (spgan_tpu/serve.py) at the tiny config of
tests/test_serve.py (channel_base 48, 2 SS layers, 128x672, batch 2): real
HTTP round trips on 127.0.0.1, the served pixels against JAX's
PanoramaEngine.generate_from_fields on the same weights and the same
injected numpy fields (float32 crops within 2e-4, PNG values within 1),
the /metadata keys, and single flight under concurrent requests."""
import json
import os
import subprocess
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spgan_tpu.config import Config as JConfig
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.serve import PanoramaService as JService
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.infer.managers import to_uint8
from spgan_tpu_torch.serve import PanoramaService, serve
from spgan_tpu_torch.utils.png import decode_image
from helpers.port_tiny import (cpu_budget, jax_layout, narrow, tiny,
                               write_yamls)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    with cpu_budget():
        yield


@pytest.fixture(scope="module")
def service():
    """The port's service on a server thread, on random weights."""
    cfg = tiny(Config(), batch_size=2)
    g = narrow(Generator.from_config(cfg))
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    svc = PanoramaService(g, params, cfg, device="cpu")
    httpd = serve(svc, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _get(url, timeout=300):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.headers.get("Content-Type"), r.read()


def _fields(svc, seed):
    rng = np.random.RandomState(seed)
    plan, eng = svc.engine.plan, svc.engine
    gl = rng.randn(eng.batch, 2, eng.g.ts.global_dim).astype(np.float32)
    gl[:, 1] = gl[:, 0]
    z = rng.randn(eng.batch, plan.z_field_h, plan.z_field_w,
                  eng.g.ts.local_dim).astype(np.float32)
    noises = [rng.randn(eng.batch, h, w, 1).astype(np.float32)
              for h, w in plan.noise_sizes]
    return gl, z, noises


def test_http_round_trip_and_cache(service):
    svc, base = service
    ctype, body = _get(base + "/healthz")
    assert ctype == "application/json" and json.loads(body) == {
        "status": "ok"}
    b0 = svc.stats["batches"]
    ctype, png = _get(base + "/generate?seed=7&index=1")
    assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
    img = decode_image(png)
    assert img.shape == (128, 672, 3) and img.dtype == np.uint8
    _, png0 = _get(base + "/generate?seed=7&index=2")   # index mod batch
    assert decode_image(png0).shape == (128, 672, 3)
    assert svc.stats["batches"] == b0 + 1              # the cached batch
    meta = json.loads(_get(base + "/metadata")[1])
    assert meta["lattice"] == [svc.engine.plan.num_steps_h,
                               svc.engine.plan.num_steps_w]
    assert meta["stats"]["batches"] == b0 + 1
    assert meta["use_pallas"] is False                 # the plain version
    code = None
    try:
        _get(base + "/nowhere")
    except urllib.error.HTTPError as e:
        code = e.code
    assert code == 404


def test_served_pixels_match_jax_engine(service, monkeypatch):
    """The port's service, its fields replaced by numpy ones, serves
    JAX's engine's render of the same fields from the same weights."""
    svc, base = service
    jcfg = tiny(JConfig(), batch_size=2)
    jg = narrow(JGenerator.from_config(jcfg))
    jsvc = JService(jg, jax_layout(svc.params), jcfg)
    gl, z, noises = _fields(svc, 5)
    want = np.asarray(jsvc.engine.crop_to_target(
        jsvc.engine.generate_from_fields(jsvc.params, gl, z, noises)))

    fields = (torch.tensor(gl), torch.tensor(z),
              [torch.tensor(n) for n in noises])
    monkeypatch.setattr(svc.engine, "sample_fields", lambda gen: fields)
    metas = []
    generate = svc.engine.generate
    monkeypatch.setattr(svc.engine, "generate", lambda params, gen: metas.
                        append(generate(params, gen)) or metas[-1])
    served = np.stack([decode_image(_get(
        base + f"/generate?seed=1005&index={i}")[1]) for i in range(2)])
    assert len(metas) == 1
    got = svc.engine.crop_to_target(metas[0]).numpy()
    assert got.shape == want.shape == (2, 128, 672, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_array_equal(served, to_uint8(got))
    jpix = to_uint8(want).astype(int)
    assert np.abs(served.astype(int) - jpix).max() <= 1
    assert (served == jpix).mean() > 0.999


def test_metadata_keys_match_jax(service):
    svc, base = service
    jcfg = tiny(JConfig(), batch_size=2)
    jsvc = JService(narrow(JGenerator.from_config(jcfg)), {}, jcfg)
    want = jsvc.metadata()
    got = json.loads(_get(base + "/metadata")[1])
    assert set(got) == set(want)
    assert set(got["stats"]) == set(want["stats"])
    for k in ("task", "height", "width", "batch", "lattice", "compute_dtype",
              "use_pallas"):
        assert got[k] == want[k], k


def test_single_flight_under_concurrent_requests(service, monkeypatch):
    """Four concurrent requests for one new seed render one batch; the
    engine is never entered by two threads at once."""
    svc, base = service
    inside, most, calls = [0], [0], [0]
    guard = threading.Lock()
    real = svc.engine.generate

    def counted(params, gen):
        with guard:
            inside[0] += 1
            calls[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            return real(params, gen)
        finally:
            with guard:
                inside[0] -= 1

    monkeypatch.setattr(svc.engine, "generate", counted)
    b0, r0 = svc.stats["batches"], svc.stats["requests"]
    with ThreadPoolExecutor(4) as ex:
        pngs = list(ex.map(lambda i: _get(
            base + f"/generate?seed=3&index={i % 2}")[1], range(4)))
    assert calls[0] == 1 and most[0] == 1
    assert svc.stats["batches"] == b0 + 1
    assert svc.stats["requests"] == r0 + 4
    assert pngs[0] == pngs[2] and pngs[1] == pngs[3]


def test_serve_main_cuda_without_a_card_raises(tmp_path):
    """`python -m spgan_tpu_torch.serve` runs on the card by default: with
    no card it raises before it binds a port.  The process, which also
    imports this slice's other modules, imports no jax."""
    args = write_yamls(tmp_path, batch_size=2)
    code = ("import sys\n"
            "import spgan_tpu_torch.geometry.global_conv\n"
            "import spgan_tpu_torch.infer.__main__\n"
            "import spgan_tpu_torch.infer.interactive\n"
            "import spgan_tpu_torch.infer.inversion\n"
            "from spgan_tpu_torch.serve import main\n"
            f"try:\n    main({args!r})\nexcept RuntimeError as e:\n"
            "    print('raised', 'CUDA' in str(e))\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'spgan_tpu.')) or m == 'spgan_tpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, check=True,
                         timeout=300).stdout.splitlines()
    assert out[-2:] == ["raised True", "[]"]
