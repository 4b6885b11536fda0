"""Latent inversion: optimise a local latent window, a global SS
conditioning, W+ styles and the per-layer noise maps so that the generator
reconstructs a target patch (counterpart of spgan_tpu/infer/inversion.py).

    L = L2(G(z, gz, n, w+), target) + noise_weight * noise_regularize(n)
        [+ lpips_weight * LPIPS(G(...), target) when an LPIPS net is given]

The generator runs as the JAX package's inversion runs it: the SS and the
TS skip convs on the per-pixel patch grids of `cp` (the port's
tables_mode "grid"), through autograd, in float32 with TF32 off.  Adam is
optax's: one global step count, every leaf updated every step (torch's
Adam on leaf tensors, betas (0.9, 0.999), eps 1e-8).  After each step
every noise map is divided by its population std (+ 1e-8).

The result's ``save`` writes the layout ``--inv-records`` reads (z,
wplus, losses, noise00...).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from spgan_tpu_torch.evalkit.fid import tf32_off
from spgan_tpu_torch.evalkit.lpips import LPIPS
from spgan_tpu_torch.geometry.coords import CoordsPartial
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.models.losses import noise_regularize


@dataclass
class InversionResult:
    local_latent: np.ndarray          # (zh, zw, C)
    noises: list                      # per TS layer (h, w, 1)
    wplus: np.ndarray                 # (n_latent, D)
    losses: np.ndarray                # reconstruction loss of each step

    def record(self) -> Dict:
        return {"local_latent": self.local_latent, "noises": self.noises,
                "wplus": self.wplus}

    def save(self, path: str) -> None:
        """Write the record in the layout --inv-records reads (a batch axis
        of 1 on z, wplus and each noiseNN)."""
        arrs = {"z": np.asarray(self.local_latent)[None],
                "wplus": np.asarray(self.wplus)[None],
                "losses": np.asarray(self.losses)}
        for i, n in enumerate(self.noises):
            arrs[f"noise{i:02d}"] = np.asarray(n)[None]
        np.savez(path, **arrs)


def _initial(g: Generator, params: dict, gen: torch.Generator,
             device) -> Dict:
    """The starting point drawn from `gen`, in the JAX package's order:
    the 1024-sample mean w, z, gz, then one map per TS layer."""
    zs = g.ss.coord_grid.ss_spatial_size
    kw = dict(generator=gen, device=device)
    w_mean = g.ts.mean_latent(params["ts"], gen, 1024)[0]
    z = torch.randn((1, zs, zs, g.ts.local_dim), **kw)
    gz = torch.randn((1, g.ts.global_dim), **kw)
    noises = [torch.randn((1, s, s, 1), **kw)
              for s in g.ts.stitch_geometry().outfeat_sizes]
    return {"w_mean": w_mean, "z": z, "gz": gz, "noises": noises}


def inversion_loss(g: Generator, params: dict, v: Dict,
                   target: torch.Tensor, cp: CoordsPartial,
                   coords: torch.Tensor, noise_weight: float = 1e3,
                   lpips: Optional[LPIPS] = None, lpips_weight: float = 1.0):
    """(loss, reconstruction L2) of the variables v ({"z", "gz", "wplus",
    "noises"}): the SS modulated by gz, the TS styled by wplus."""
    structure = g.ss_on_grids(params, v["gz"], v["z"], coords, cp)
    img = g.ts_on_grids(params, structure, v["wplus"], cp,
                        noises=v["noises"])
    rec = torch.mean(torch.square(img - target))
    loss = rec
    if lpips is not None:
        loss = loss + lpips_weight * lpips(img, target).mean()
    return loss + noise_weight * noise_regularize(v["noises"]), rec


def invert_patch(g: Generator, params: dict, target: torch.Tensor,
                 cp: CoordsPartial, coords: torch.Tensor,
                 steps: int = 200, lr: float = 0.05,
                 noise_weight: float = 1e3,
                 lpips: Optional[LPIPS] = None,
                 lpips_weight: float = 1.0,
                 gen: Optional[torch.Generator] = None,
                 init: Optional[Dict] = None) -> InversionResult:
    """target: (1, P, P, 3) in [-1, 1] on the params' device; coords: (1,
    zh, zw, coord_dim) raw; cp: the patch's crop.

    Starts from the mean latent (W+ = the mean w at every layer) and
    draws z, gz and the noises from `gen` (a generator on the target's
    device; default seeded 0), or takes all four from `init` (numpy:
    "w_mean" (D,), "z" (1,zh,zw,C), "gz" (1,D), "noises" [(1,s,s,1)]).
    lpips: an LPIPS net on the same device adds its mean distance."""
    dev = target.device
    if init is None:
        gen = gen if gen is not None else torch.Generator(dev).manual_seed(0)
        with torch.no_grad():
            start = _initial(g, params, gen, dev)
    else:
        start = {k: (torch.tensor(np.asarray(v, np.float32), device=dev)
                     if k != "noises" else
                     [torch.tensor(np.asarray(n, np.float32), device=dev)
                      for n in v])
                 for k, v in init.items()}
    z = start["z"].clone().requires_grad_(True)
    gz = start["gz"].clone().requires_grad_(True)
    wplus = start["w_mean"].reshape(1, 1, -1).repeat(
        1, g.ts.n_latent, 1).requires_grad_(True)
    noises = [n.clone().requires_grad_(True) for n in start["noises"]]
    opt = torch.optim.Adam([z, gz, wplus] + noises, lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)

    losses = []
    with tf32_off():
        for _ in range(steps):
            opt.zero_grad()
            loss, rec = inversion_loss(
                g, params, {"z": z, "gz": gz, "wplus": wplus,
                            "noises": noises},
                target, cp, coords, noise_weight, lpips, lpips_weight)
            loss.backward()
            opt.step()
            with torch.no_grad():
                for n in noises:
                    n.div_(n.std(correction=0) + 1e-8)
            losses.append(float(rec.detach()))

    return InversionResult(
        local_latent=z[0].detach().cpu().numpy(),
        noises=[n[0].detach().cpu().numpy() for n in noises],
        wplus=wplus[0].detach().cpu().numpy(),
        losses=np.asarray(losses))
