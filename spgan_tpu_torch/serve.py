"""Panorama serving: a small HTTP inference server over the close-loop
panorama engine (counterpart of spgan_tpu/serve.py).

    python -m spgan_tpu_torch.serve --model-config configs/model/<m>.yaml \\
        --test-config configs/test/<t>.yaml [--ckpt PATH] [--port 8000] \\
        [--device cuda|cpu]

A request renders (or reuses) one batch of task.batch_size panoramas
seeded by its seed; one generation runs at a time (a lock around the
engine), and the last seed's batch stays cached.  Endpoints:

  GET /healthz                  -> {"status": "ok"}
  GET /generate?seed=N&index=I  -> PNG (panorama I mod batch of seed N)
  GET /metadata                 -> the engine's config and the counters

The PNG is the centred target crop quantised as the saved PNGs are
(managers.to_uint8: (clip((x + 1) / 2, 0, 1) * 255 + 0.5) as uint8),
encoded by utils/png.py.
The fields of seed N come from torch.Generator(device).manual_seed(N).
/metadata keeps the JAX package's keys; its "use_pallas" says here
whether the SS sphere convs run on the hand-written sphere-conv kernel
(true on cuda; on the CPU they run its plain PyTorch version).

Runs on cuda unless --device cpu.  Without --ckpt the generator has
random weights from task.seed.  `main` prints the port it bound (--port 0
binds a free one).
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from spgan_tpu_torch.compat.load import load_generator_params
from spgan_tpu_torch.config import Config, load_config
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.managers import to_uint8
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.utils.png import encode_png


class PanoramaService:
    """Single-flight generation with a one-seed batch cache."""

    def __init__(self, g: Generator, params: dict, cfg: Config,
                 device=None):
        self.cfg = cfg
        self.device = resolve(device)
        plan = build_close_loop_plan(g, cfg.task.height, cfg.task.width)
        self.engine = PanoramaEngine(
            g=g, plan=plan, batch=cfg.task.batch_size,
            patch_chunk=cfg.task.patch_chunk,
            grid_partial=cfg.train_params.partial,
            compute_dtype=cfg.train_params.compute_dtype,
            device=self.device)
        self.params = params
        self._lock = threading.Lock()
        self._cache_seed: Optional[int] = None
        self._cache: Optional[np.ndarray] = None
        self.stats = {"requests": 0, "batches": 0, "last_batch_secs": None}

    def warmup(self) -> float:
        """Render seed 0's batch (it stays cached); its seconds."""
        t0 = time.perf_counter()
        with self._lock:
            self._batch(0)
        return time.perf_counter() - t0

    def _batch(self, seed: int) -> np.ndarray:
        """Seed's uint8 target crops (B, H, W, 3); the caller holds the
        lock.  inference_mode is per thread, so each request enters it."""
        if self._cache_seed == seed:
            return self._cache
        t0 = time.perf_counter()
        with torch.inference_mode():
            gen = torch.Generator(device=self.device).manual_seed(seed)
            meta = self.engine.generate(self.params, gen)
            out = to_uint8(self.engine.crop_to_target(meta).cpu().numpy())
        self.stats["batches"] += 1
        self.stats["last_batch_secs"] = round(time.perf_counter() - t0, 4)
        self._cache_seed, self._cache = seed, out
        return out

    def generate_png(self, seed: int, index: int) -> bytes:
        with self._lock:
            batch = self._batch(seed)
            self.stats["requests"] += 1
        return encode_png(batch[index % batch.shape[0]])

    def metadata(self) -> dict:
        plan = self.engine.plan
        return {
            "task": "close_loop_panorama",
            "height": plan.target_h, "width": plan.target_w,
            "batch": self.engine.batch,
            "lattice": [plan.num_steps_h, plan.num_steps_w],
            "compute_dtype": self.engine.compute_dtype,
            "use_pallas": self.device.type == "cuda",
            "stats": dict(self.stats),
        }


def make_handler(service: PanoramaService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            u = urlparse(self.path)
            try:
                if u.path == "/healthz":
                    self._json({"status": "ok"})
                elif u.path == "/metadata":
                    self._json(service.metadata())
                elif u.path == "/generate":
                    q = parse_qs(u.query)
                    seed = int(q.get("seed", ["0"])[0])
                    idx = int(q.get("index", ["0"])[0])
                    self._send(service.generate_png(seed, idx), "image/png")
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001  (the server keeps going)
                traceback.print_exc()
                self._json({"error": str(e)}, 500)

    return Handler


def serve(service: PanoramaService, port: int = 8000) -> ThreadingHTTPServer:
    """A server on 127.0.0.1:port (0: a free port; see server_address);
    the caller runs serve_forever."""
    return ThreadingHTTPServer(("127.0.0.1", port), make_handler(service))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m spgan_tpu_torch.serve")
    ap.add_argument("--model-config", required=True)
    ap.add_argument("--test-config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = load_config(args.model_config, args.test_config)
    if cfg.train_params.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    g = Generator.from_config(cfg)
    if args.ckpt:
        params = load_generator_params(args.ckpt, g, device=dev)
    else:
        params = g.init(torch.Generator().manual_seed(cfg.task.seed),
                        device=dev)
        print(" [!] serving randomly initialized weights (no --ckpt)")
    svc = PanoramaService(g, params, cfg, device=dev)
    dt = svc.warmup()
    httpd = serve(svc, args.port)
    print(f" [*] warmup: {dt:.1f}s; serving on "
          f"127.0.0.1:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
