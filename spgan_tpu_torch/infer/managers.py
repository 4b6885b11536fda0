"""Test managers: task_specific_init / run_next / save_full_imgs / exit
(counterpart of spgan_tpu/infer/managers.py; reference
test_managers/base_test_manager.py:147-159), with the --speed-benchmark
timing of the reference's test.py:84-91 (per-call wall time ended by a
device synchronise, the first 10 calls discarded as warm-up).

task.engine picks how run_next renders: "folded" (the engine on this
process's device), "sharded" (the lattice split over the ranks of the
manager's mesh, the meta image on every rank) or "halo" (close-loop
only: the fields split by width over the ranks, infer/halo.py; the meta
image on rank 0).  Every rank of a world runs the manager with the same
seed; only rank 0 writes PNGs and the speed-benchmark files.

ImageGenerationManager renders whole images of a generator without a
patch lattice (StyleGAN3, models/stylegan3.py) through ImageEngine
(infer/image_engine.py), on one device.
"""
from __future__ import annotations

import ctypes
import datetime
import functools
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np
import torch

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.halo import make_width_sharded_generate
from spgan_tpu_torch.infer.image_engine import ImageEngine
from spgan_tpu_torch.infer.stitcher import (LatticePlan,
                                            build_close_loop_plan,
                                            build_infinite_plan)
from spgan_tpu_torch.infer.testing_vars import TestingVars
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.parallel.mesh import Mesh, make_mesh
from spgan_tpu_torch.utils import trace
from spgan_tpu_torch.utils.png import write_png

ENGINES = ("folded", "sharded", "halo")


def halo_seed(gen: torch.Generator) -> int:
    """The seed of one halo batch, drawn from the manager's generator (the
    same on every rank that seeded it alike)."""
    return int(torch.randint(0, 2 ** 62, (), generator=gen,
                             device=gen.device))


# the quantiser's build: no -march=native (its x86 path is SSE2), no FMA
TO_UINT8_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC",
                  "-std=c++17", "-pthread")
TO_UINT8_BYTES_PER_THREAD = 8 << 20
TO_UINT8_MAX_THREADS = 8


@functools.lru_cache(maxsize=None)
def _to_uint8_lib() -> ctypes.CDLL:
    from spgan_tpu_torch.utils import native

    lib = ctypes.CDLL(str(native.build_cxx(
        native.PKG_DIR / "native" / "to_uint8.cc", "the uint8 quantiser",
        TO_UINT8_FLAGS)))
    lib.spgan_to_uint8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int]
    lib.spgan_to_uint8.restype = ctypes.c_int
    return lib


def to_uint8_threads(nbytes: int, cpus: int) -> int:
    """The threads `to_uint8` splits an input of `nbytes` over: one per
    whole 8 MiB, at least 1, at most 8 and at most the `cpus` this
    process may run on."""
    return max(1, min(nbytes // TO_UINT8_BYTES_PER_THREAD,
                      TO_UINT8_MAX_THREADS, cpus))


def to_uint8(images: np.ndarray) -> np.ndarray:
    """(..., 3) in [-1, 1] -> uint8, quantized as the JAX package does:
    clip((x + 1) / 2, 0, 1) * 255 + 0.5, truncated.  A C-contiguous
    float32 array takes one native pass (native/to_uint8.cc, the same
    bytes; the GIL is released and the threads follow the size), counted
    by `spgan.engine.to_uint8.native` and `.threads`; anything else takes
    numpy."""
    with trace.span("spgan.engine.to_uint8"):
        if (images.dtype == np.float32 and images.flags.c_contiguous
                and images.flags.aligned):
            out = np.empty(images.shape, np.uint8)
            ran = _to_uint8_lib().spgan_to_uint8(
                images.ctypes.data, out.ctypes.data, images.size,
                to_uint8_threads(images.nbytes,
                                 len(os.sched_getaffinity(0))))
            trace.count("spgan.engine.to_uint8.native")
            trace.count("spgan.engine.to_uint8.threads", ran)
            return out
        arr = np.clip((images + 1.0) / 2.0, 0.0, 1.0)
        return (arr * 255.0 + 0.5).astype(np.uint8)


def save_image_batch(images: np.ndarray, save_root: str, start_id: int,
                     suffix: str = "") -> List[str]:
    """images: (B,H,W,3) in [-1,1] -> PNG files named by zero-padded
    global id, quantized by to_uint8 (on the host)."""
    os.makedirs(save_root, exist_ok=True)
    arr = to_uint8(images)
    paths = []
    for i in range(arr.shape[0]):
        p = os.path.join(save_root, f"{start_id + i:06d}{suffix}.png")
        write_png(p, arr[i])
        paths.append(p)
    return paths


@dataclass
class BaseManager:
    g: Generator
    params_ema: dict
    config: Config
    save_root: Optional[str] = None
    device: Optional[Union[str, torch.device]] = None  # default: cuda
    cur_global_id: int = 0
    accum_exec_times: List[float] = field(default_factory=list)
    engine: Optional[PanoramaEngine] = None
    full_image: Optional[np.ndarray] = None  # last uncropped meta batch
    # the world of task.engine sharded/halo (default: the process group's,
    # else a world of one)
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.device = resolve(self.device)
        if self.mesh is None:
            self.mesh = make_mesh(self.device)
        self._sharded_fn = self._halo_fn = None

    @property
    def plan(self) -> LatticePlan:
        return self.engine.plan

    def task_specific_init(self, seed: Optional[int] = None) -> None:
        if self.config.task.init_index is not None:
            self.cur_global_id = self.config.task.init_index

    def _build_engine(self, close_loop: bool) -> PanoramaEngine:
        """The engine, and the sharded or halo callable of task.engine,
        built once."""
        task, tp = self.config.task, self.config.train_params
        if task.engine not in ENGINES:
            raise ValueError(f"unknown task.engine {task.engine!r}; "
                             "supported: folded | sharded | halo")
        if task.engine == "halo" and not close_loop:
            raise ValueError(
                "task.engine='halo' needs the close-loop manager "
                "(width-sharded cylindrical fields)")
        build = build_close_loop_plan if close_loop else build_infinite_plan
        # parallel_batch_size (the reference's queue of patch calls batched
        # into one G call) is the engine's patch_chunk
        engine = PanoramaEngine(
            g=self.g, plan=build(self.g, task.height, task.width),
            batch=task.batch_size,
            patch_chunk=task.parallel_batch_size or task.patch_chunk,
            grid_partial=tp.partial, compute_dtype=tp.compute_dtype,
            device=self.device)
        if task.engine == "sharded":
            self._sharded_fn = engine.make_sharded_generate(self.mesh)
        elif task.engine == "halo":
            self._halo_fn = make_width_sharded_generate(
                self.g, engine.plan, self.mesh, task.batch_size, tp.partial,
                compute_dtype=tp.compute_dtype, device=self.device)
        return engine

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ---- TestingVars ----------------------------------------------------
    def create_vars(self, gen: torch.Generator) -> TestingVars:
        """Sample the inference state bag from `gen` (a generator on the
        manager's device)."""
        gl, z_field, noises = self.engine.sample_fields(gen)
        return TestingVars(
            meta_img=None, global_latent=gl.cpu().numpy(),
            local_latent=z_field.cpu().numpy(),
            meta_coords=self.engine._coords_field.cpu().numpy(),
            noises=[n.cpu().numpy() for n in noises])

    def generate_with_vars(self, vars: TestingVars) -> np.ndarray:
        """Full generation from an (edited) TestingVars bag."""
        meta = self.engine.generate_from_fields(
            self.params_ema, self._to_device(vars.global_latent),
            self._to_device(vars.local_latent),
            [self._to_device(n) for n in vars.noises])
        vars.meta_img = meta.cpu().numpy()
        self.full_image = vars.meta_img
        return vars.meta_img

    def regenerate(self, vars: TestingVars,
                   update_by_ss_map: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """Partial update: render the lattice again but write only the
        patches whose latent window overlaps the selection map (z-space,
        (zh, zw) 0/1); other regions keep their pixels."""
        if vars.meta_img is None:
            raise ValueError("regenerate needs vars.meta_img: call "
                             "generate_with_vars first")
        eng = self.engine
        plan = eng.plan
        positions = None
        if update_by_ss_map is not None:
            win, zw_total = plan.window, vars.local_latent.shape[2]
            positions = [
                p for p, (zr, zc) in enumerate(plan.z_starts)
                if (update_by_ss_map[zr:zr + win][
                    :, (zc + np.arange(win)) % zw_total] > 0).any()]
        with torch.inference_mode():
            patches = eng._render(
                self.params_ema, self._to_device(vars.global_latent),
                self._to_device(vars.local_latent),
                [self._to_device(n) for n in vars.noises])
            meta = torch.tensor(vars.meta_img, dtype=torch.float32,
                                device=self.device)   # a copy
            meta = eng._scatter(patches, meta=meta, positions=positions)
        vars.meta_img = meta.cpu().numpy()
        return vars.meta_img

    def run_next(self, gen: torch.Generator, save: bool = True,
                 write_gpu_time: bool = False) -> Optional[np.ndarray]:
        """One batch from `gen` through task.engine: render, copy the meta
        image to the host once, save the target crops (save=True).
        write_gpu_time: time the render, ended by a device synchronise,
        into accum_exec_times and the per-day
        speed_benchmark_<date>.txt next to the outputs.  Returns the
        crops; None on the ranks other than 0 of the halo engine (rank 0
        assembles)."""
        t0 = time.perf_counter()
        if self._halo_fn is not None:
            meta = self._halo_fn(self.params_ema, halo_seed(gen))
        elif self._sharded_fn is not None:
            meta = self._sharded_fn(self.params_ema,
                                    *self.engine.sample_fields(gen))
        else:
            meta = self.engine.generate(self.params_ema, gen)
        if write_gpu_time:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.accum_exec_times.append(dt)
            if self.save_root is not None and self.mesh.is_root:
                os.makedirs(self.save_root, exist_ok=True)
                day = datetime.date.today().strftime("%d-%m-%Y")
                with open(os.path.join(self.save_root,
                                       f"speed_benchmark_{day}.txt"),
                          "a") as f:
                    f.write(f"{dt:.6f}")
        self.cur_global_id += self.engine.batch
        if meta is None:
            self.full_image = None
            return None
        self.full_image = meta.cpu().numpy()
        out = self.engine.crop_to_target(self.full_image)
        if save and self.save_root is not None and self.mesh.is_root:
            save_image_batch(out, self.save_root,
                             self.cur_global_id - out.shape[0])
        return out

    def save_full_imgs(self) -> None:
        """Save the last batch's uncropped meta images as <id>full.png
        (after run_next: ids cur_global_id - batch + i); rank 0 only."""
        if not self.mesh.is_root:
            return
        if self.full_image is None or self.save_root is None:
            raise ValueError("save_full_imgs needs a rendered batch and a "
                             "save_root")
        start = self.cur_global_id - self.full_image.shape[0]
        save_image_batch(self.full_image, self.save_root, start,
                         suffix="full")

    def get_exec_time_stats(self, warmup: int = 10):
        """Mean and std of the per-call times after the first `warmup`
        (all of them when there are no more)."""
        t = np.asarray(self.accum_exec_times[warmup:]
                       or self.accum_exec_times)
        return float(t.mean()), float(t.std())

    def exit(self) -> None:
        return


@dataclass
class CloseLoopPanoramaManager(BaseManager):
    """Seamless 360-degree panoramas (reference
    test_managers/close_loop_infinite_generation.py)."""

    def task_specific_init(self, seed: Optional[int] = None) -> None:
        super().task_specific_init(seed)
        self.engine = self._build_engine(close_loop=True)


@dataclass
class InfiniteGenerationManager(BaseManager):
    """Planar arbitrary-size canvases (reference
    test_managers/infinite_generation.py)."""

    def task_specific_init(self, seed: Optional[int] = None) -> None:
        super().task_specific_init(seed)
        self.engine = self._build_engine(close_loop=False)


@dataclass
class ImageGenerationManager(BaseManager):
    """Whole images of a generator without a patch lattice (StyleGAN3):
    batches of task.batch_size new latents from the manager's generator,
    each image saved whole.  task.engine must be folded; the TestingVars,
    inversion and editing paths belong to the panorama managers."""

    def task_specific_init(self, seed: Optional[int] = None) -> None:
        super().task_specific_init(seed)
        if self.config.task.engine != "folded":
            raise ValueError("ImageGenerationManager renders on one device: "
                             f"task.engine 'folded', got "
                             f"{self.config.task.engine!r}")
        task, res = self.config.task, self.g.img_resolution
        if (task.height, task.width) != (res, res):
            raise ValueError(f"task.height x task.width {task.height}x"
                             f"{task.width}: the generator renders "
                             f"{res}x{res}")
        self.engine = ImageEngine(g=self.g, batch=self.config.task.batch_size,
                                  device=self.device)

    def create_vars(self, gen: torch.Generator) -> TestingVars:
        raise NotImplementedError("TestingVars hold a panorama's latent "
                                  "fields; an image generator has none")

    def generate_with_vars(self, vars: TestingVars) -> np.ndarray:
        raise NotImplementedError("TestingVars hold a panorama's latent "
                                  "fields; an image generator has none")
