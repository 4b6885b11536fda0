"""Rolling training checkpoints with resume (counterpart of
spgan_tpu/train/checkpoint.py, which uses Orbax), on ``torch.save``.

A checkpoint directory holds one file per step, ``<step>.pt``, written to
a temporary name, synced and renamed into place, so a kill mid-write
leaves the earlier checkpoints intact (a leftover temporary file is
ignored).  The newest ``max_to_keep`` are kept; ``save_best`` writes
named snapshots (``best_fid.pt``) beside them, which the rolling deletion
leaves alone.  Each file holds a format tag, the step, the PPL running
mean and every tensor of the TrainState on the CPU under its flat
``a/b/0/c`` key: ``params_g/...``, ``params_d/...``,
``params_g_ema/...`` and ``opt_g|opt_d/mu|nu|count/...`` (an SGD state
has no tensors).  Files are read back with
``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import os
import re
import tempfile
from dataclasses import fields
from typing import Any, Dict, List, Optional

import torch

from spgan_tpu_torch.train.state import TrainState
from spgan_tpu_torch.tree import flatten

FORMAT = "spgan_tpu_torch.TrainState/1"
_NAME = re.compile(r"^(\d+)\.pt$")
_TREES = ("params_g", "params_d", "params_g_ema")
_OPTS = ("opt_g", "opt_d")


class CheckpointLayoutError(RuntimeError):
    """A checkpoint's tensors do not match the current TrainState's layout
    (keys or shapes), e.g. after a change to the optimizer state."""


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of `state` under its flat key."""
    out: Dict[str, torch.Tensor] = {}
    for name in _TREES:
        out.update(flatten(getattr(state, name), f"{name}/"))
    for name in _OPTS:
        opt = getattr(state, name)
        for f in fields(opt):
            out.update(flatten(getattr(opt, f.name), f"{name}/{f.name}/"))
    return out


def _rebuild(template: Any, prefix: str, tensors: Dict[str, torch.Tensor]):
    if isinstance(template, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", tensors)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, f"{prefix}{i}/", tensors)
                for i, v in enumerate(template)]
    return tensors[prefix[:-1]].to(template.device)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint file's payload (format, step, mean_path_length,
    tensors); raises ValueError for a file of another format."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not is_checkpoint_payload(payload):
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    return payload


def is_checkpoint_payload(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get("format") == FORMAT


def write_state(path: str, state: TrainState) -> None:
    """`state` as a checkpoint file at `path`: written to a temporary file
    beside it, synced, then renamed into place."""
    payload = {"format": FORMAT, "step": int(state.step),
               "mean_path_length": state.mean_path_length.detach().cpu(),
               "tensors": {k: v.detach().cpu()
                           for k, v in state_tensors(state).items()}}
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.",
                               suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_best(ckpt_root: str, name: str, state: TrainState) -> str:
    """`state` as <ckpt_root>/<name>.pt (best_fid, best_fid_ext2,
    best_fid_ext2_<it>), in the rolling checkpoints' format: steps()
    does not list it and the rolling deletion never removes it, and
    ``python -m spgan_tpu_torch.infer --ckpt <ckpt_root>/<name>.pt``
    renders its EMA generator.  Returns the path."""
    path = os.path.join(os.path.abspath(ckpt_root), f"{name}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_state(path, state)
    return path


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 2):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{step}.pt")

    def steps(self) -> List[int]:
        """The steps with a complete checkpoint, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.ckpt_dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Write `state` as the checkpoint of `step` (the loop passes
        state.step), then drop all but the newest max_to_keep."""
        write_state(self.path(step), state)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, template: TrainState) -> TrainState:
        """The newest checkpoint in `template`'s structure, on its
        devices."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        payload = read_checkpoint(self.path(step))
        saved = payload["tensors"]
        want = state_tensors(template)
        missing = sorted(set(want) - set(saved))
        extra = sorted(set(saved) - set(want))
        shapes = [k for k in want if k in saved
                  and saved[k].shape != want[k].shape]
        if missing or extra or shapes:
            opt_hint = any(k.startswith(_OPTS)
                           for k in missing + extra + shapes)
            raise CheckpointLayoutError(
                f"checkpoint at step {step} in {self.ckpt_dir} has a stale "
                f"layout: {len(missing)} keys expected by the current "
                f"TrainState are absent (first: {missing[:8]}), "
                f"{len(extra)} saved keys are no longer expected (first: "
                f"{extra[:8]}), {len(shapes)} keys differ in shape (first: "
                f"{shapes[:8]})."
                + (" The differing keys are in the OPTIMIZER state: this "
                   "checkpoint predates an optimizer layout change; delete "
                   "the stale checkpoint directory or restart training from "
                   "scratch." if opt_hint else ""))

        def opt(name: str):
            t = getattr(template, name)
            return type(t)(**{f.name: _rebuild(getattr(t, f.name),
                                                f"{name}/{f.name}/", saved)
                              for f in fields(t)})

        return TrainState(
            step=payload["step"],
            **{name: _rebuild(getattr(template, name), f"{name}/", saved)
               for name in _TREES},
            opt_g=opt("opt_g"), opt_d=opt("opt_d"),
            mean_path_length=payload["mean_path_length"].to(
                template.mean_path_length.device))
