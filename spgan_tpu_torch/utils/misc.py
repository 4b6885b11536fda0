"""Small utilities (counterpart of spgan_tpu/utils/misc.py: the class-path
resolver of the yaml configs, seeding, the code snapshot of a training
run and an advisory file lock)."""
from __future__ import annotations

import importlib
import os
import random
import time
from typing import Any

PACKAGE = "spgan_tpu_torch"

# The reference's own dotted paths (its configs/*.yaml) and the JAX
# package's resolve to this package's classes, so the shipped yamls and an
# unmodified reference yaml work unchanged.
REFERENCE_PATH_ALIASES = {
    "models.spgan.spgan.InfinityGanGenerator":
        "spgan_tpu_torch.models.generator.Generator",
    "models.stylegan2discriminator.StyleGan2Discriminator":
        "spgan_tpu_torch.models.discriminator.Discriminator",
    "test_managers.close_loop_infinite_generation."
    "InfiniteGenerationManagerPatchCoordsCloseLoop":
        "spgan_tpu_torch.infer.close_loop.CloseLoopPanoramaManager",
    "test_managers.infinite_generation.InfiniteGenerationManager":
        "spgan_tpu_torch.infer.infinite.InfiniteGenerationManager",
}


def import_func(dotted: str) -> Any:
    """The class or function a config's dotted path names (g_arch, d_arch,
    task_manager), always inside this package: a reference path goes
    through the alias table and a ``spgan_tpu.`` path becomes the same path
    under ``spgan_tpu_torch.``, so resolving a config never imports the
    JAX package.  Any other path raises ValueError."""
    path = REFERENCE_PATH_ALIASES.get(dotted, dotted)
    if path.startswith("spgan_tpu."):
        path = PACKAGE + path[len("spgan_tpu"):]
    module, _, name = path.rpartition(".")
    if not module.startswith(PACKAGE + "."):
        raise ValueError(f"{dotted!r} does not resolve inside {PACKAGE}")
    try:
        return getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"{dotted!r} -> {path!r} does not resolve inside "
                         f"{PACKAGE}: {e}") from e


def manually_seed(seed: int) -> None:
    """Seed python's, numpy's and torch's global generators (the JAX
    package seeds python and numpy; its jax keys are explicit, as the
    port's torch.Generator draws are)."""
    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


# the source files a training run snapshots
BACKUP_EXTS = (".py", ".cc", ".cu", ".cuh", ".yaml", ".yml")


def backup_files(cur_dir: str, backup_dir: str) -> int:
    """Copy the source files under `cur_dir` into `backup_dir` (the
    training run's code snapshot, as the reference's libs/backup.py);
    returns how many."""
    import shutil

    n = 0
    for root, dirs, files in os.walk(cur_dir):
        dirs[:] = [d for d in dirs
                   if d not in {".git", "logs", "__pycache__", "tests",
                                ".fid-cache", "_build"}]
        for f in files:
            if f.endswith(BACKUP_EXTS):
                src = os.path.join(root, f)
                dst = os.path.join(backup_dir, os.path.relpath(src, cur_dir))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)
                n += 1
    return n


class FileLock:
    """Advisory lock file (`path` + ".lock") around shared log writes: a
    `with` block waits, polling every `poll` s, until it creates the lock
    file; after `timeout` s it takes a lock it finds as stale."""

    def __init__(self, path: str, timeout: float = 30.0, poll: float = 0.1):
        self.lock_path = path + ".lock"
        self.timeout = timeout
        self.poll = poll
        self._fd = None

    def __enter__(self):
        deadline = time.time() + self.timeout
        while True:
            try:
                self._fd = os.open(self.lock_path,
                                   os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                return self
            except FileExistsError:
                if time.time() > deadline:
                    try:  # stale: take it
                        os.unlink(self.lock_path)
                    except FileNotFoundError:
                        pass
                time.sleep(self.poll)

    def __exit__(self, *exc):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
            try:
                os.unlink(self.lock_path)
            except FileNotFoundError:
                pass
        return False
