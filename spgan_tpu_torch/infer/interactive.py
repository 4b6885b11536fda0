"""Interactive panorama editing REPL (``python -m spgan_tpu_torch.infer
... --interactive``; counterpart of spgan_tpu/infer/interactive.py).

A line-oriented command loop over a close-loop or planar manager that
samples, edits and partially regenerates panoramas and saves and loads
the TestingVars bag.  Every render writes the whole meta image as a PNG
(utils/png.py) named by its render count.

Commands (also printed by `help`):
  gen [seed]                 sample fresh vars and render
  show                       re-render current vars and save a PNG
  reroll global [seed]       new global latent, full regenerate
  reroll region R0 C0 R1 C1 [seed]
                             resample the local latent in the z-space
                             rectangle [R0:R1, C0:C1) and regenerate only
                             the patches whose window overlaps it
  reroll noise [seed]        resample all noise fields, full regenerate
  place RECORDS.npz FRAC     paste an inversion record at FRAC of the width
                             (infer/inversion.py's InversionResult.save, or
                             local_latent / noise_{i} keys)
  save PATH.npz / load PATH.npz
                             persist / restore the TestingVars bag
  quit                       exit

Seeds seed a torch.Generator on the manager's device; without one, the
REPL counts up from 1.  A command that fails prints a ` [!]` line and
the loop goes on.  `run_interactive` reads any line iterator, so a
script on stdin drives it as a TTY does.
"""
from __future__ import annotations

import os
import shlex
import sys
from typing import IO, Callable, Optional

import numpy as np
import torch

from spgan_tpu_torch.infer.managers import save_image_batch
from spgan_tpu_torch.infer.testing_vars import TestingVars, load_record

HELP = __doc__[__doc__.index("Commands"):__doc__.index("Seeds seed")]


def run_interactive(mgr, save_root: str, stream: Optional[IO] = None,
                    out: Callable[[str], None] = print) -> int:
    """Drive `mgr` (a manager after task_specific_init) from `stream`
    (default stdin).  Returns the number of rendered images."""
    stream = stream if stream is not None else sys.stdin
    os.makedirs(save_root, exist_ok=True)
    tv: Optional[TestingVars] = None
    n_rendered = 0
    seed_ctr = 0

    def render(sel: Optional[np.ndarray] = None):
        nonlocal n_rendered
        img = (mgr.generate_with_vars(tv) if sel is None
               else mgr.regenerate(tv, update_by_ss_map=sel))
        path = save_image_batch(img, save_root, start_id=n_rendered)[0]
        n_rendered += 1
        out(f" [*] saved {path}")

    def generator(tok: Optional[str]) -> torch.Generator:
        nonlocal seed_ctr
        if tok is None:
            seed_ctr += 1
            seed = seed_ctr
        else:
            seed = int(tok)
        return torch.Generator(device=mgr.device).manual_seed(seed)

    def randn(gen: torch.Generator, shape, like: np.ndarray) -> np.ndarray:
        return torch.randn(shape, generator=gen, device=mgr.device).cpu() \
            .numpy().astype(like.dtype)

    def need_vars():
        if tv is None:
            raise ValueError("no vars yet: `gen` first")

    if hasattr(stream, "isatty") and stream.isatty():
        out(HELP)
    for line in stream:
        try:
            toks = shlex.split(line.strip())
            if not toks:
                continue
            cmd, args = toks[0], toks[1:]
            if cmd in ("quit", "exit", "q"):
                break
            elif cmd == "help":
                out(HELP)
            elif cmd == "gen":
                tv = mgr.create_vars(generator(args[0] if args else None))
                render()
            elif cmd == "show":
                need_vars()
                render()
            elif cmd == "reroll":
                need_vars()
                what = args[0]
                if what == "global":
                    gen = generator(args[1] if len(args) > 1 else None)
                    gl = randn(gen, tv.global_latent.shape[::2],
                               tv.global_latent)
                    tv.update_global_latent(np.repeat(gl[:, None], 2, axis=1))
                    render()
                elif what == "region":
                    r0, c0, r1, c1 = (int(a) for a in args[1:5])
                    gen = generator(args[5] if len(args) > 5 else None)
                    zh, zw = tv.local_latent.shape[1:3]
                    sel = np.zeros((zh, zw))
                    sel[r0:r1, c0:c1] = 1
                    new_z = np.array(tv.local_latent)
                    new_z[:, r0:r1, c0:c1] = randn(
                        gen, (new_z.shape[0], r1 - r0, c1 - c0,
                              new_z.shape[-1]), new_z)
                    tv.update_local_latent(new_z, sel)
                    render(sel)
                elif what == "noise":
                    gen = generator(args[1] if len(args) > 1 else None)
                    tv.update_noises([randn(gen, n.shape, n)
                                      for n in tv.noises])
                    render()
                else:
                    out(f" [!] unknown reroll target {what!r}")
            elif cmd == "place":
                need_vars()
                rec_path, frac = args[0], float(args[1])
                tv.replace_by_records(mgr.plan, [load_record(rec_path)],
                                      [frac])
                render()
            elif cmd == "save":
                need_vars()
                tv.save(args[0])
                out(f" [*] vars -> {args[0]}")
            elif cmd == "load":
                tv = TestingVars.load(args[0])
                out(f" [*] vars <- {args[0]}")
            else:
                out(f" [!] unknown command {cmd!r}: `help` lists them")
        except (ValueError, IndexError, KeyError, FileNotFoundError) as e:
            out(f" [!] {type(e).__name__}: {e}")
    return n_rendered
