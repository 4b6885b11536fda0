"""The training cell's reference: the first three iterations of the
plain copy's training step (`spgan/train/step.py`), float32 with TF32
off, from the same seed, weights, feed and draws as the program's, and
the comparison of what each side's steps left behind.

What is compared (`gaps`), each as the gap between the program's number
and the reference's:

  loss_gap    the first iteration's D loss, the one loss taken before
              any update: |program - reference| / |reference|
  g_loss_gap  the first iteration's G loss (the adversarial phase's, after
              the first D update), the same way
  grad_gap    the first gradient as each optimizer got it, read from its
              state after the first iteration (Adam's first moment, whose
              beta1 is 0: the last gradient it took, the PPL gradient for
              G and the R1 gradient for D): per leaf the gap of the norms
              over the larger of the reference's norm of that leaf and of
              the median leaf; the worst leaf
  change_gap  the parameters' change over three iterations (G, D and the
              EMA of G): the gap of the median leaf's change norm over
              the reference's; leaves whose reference gradient is under a
              thousandth of the median leaf's are left out (under Adam
              they move by round-off alone)

The later losses, the R1 and PPL penalties, the worst leaf's change and
the second (plain) iteration's gradients, those of the main phases, are
not compared: the reference run twice on one seed moves them by as much as
the control does, or no fault moves them ten times as far as sound runs
(cuDNN's float32 kernels do not fix their summation order, and Adam's
first steps, lr * g / |g|, carry a near-zero gradient's rounding into a
whole step).  `detail` reports them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import build
from portbench.harness import Check
from portbench.reference import precision
from portbench.reference.render import float32_exact

LOSSES_EVERY_STEP = ("d_total_loss", "g_total_loss")
LOSSES_FIRST_STEP = ("r1", "path", "mean_path_length")
# the losses compared, by "<key>@<iteration>"
COMPARED = {"loss_gap": "d_total_loss@1", "g_loss_gap": "g_total_loss@1"}
FLOOR = 1e-3   # a leaf's reference gradient under FLOOR * the median's


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order (the trees of both sides share it)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in leaves(x)]
    return [tree]


def _norms(tree) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double()))
                     for t in leaves(tree)])


def _change_norms(a, b) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(y.double() - x.double()))
                     for x, y in zip(leaves(a), leaves(b))])


def summarize(states: list, metrics: List[dict]) -> dict:
    """What a side's first three iterations left: the start state and the
    state after each iteration, their metrics."""
    state0, state1, state2, state3 = states
    first = metrics[0]
    return {
        "losses": [{k: float(m[k]) for k in LOSSES_EVERY_STEP}
                   for m in metrics],
        "first": {k: float(first[k]) for k in LOSSES_FIRST_STEP},
        "grad": {"g": _norms(state1.opt_g.mu), "d": _norms(state1.opt_d.mu)},
        "main_grad": {"g": _norms(state2.opt_g.mu),
                      "d": _norms(state2.opt_d.mu)},
        "change": {
            "g": _change_norms(state0.params_g, state3.params_g),
            "d": _change_norms(state0.params_d, state3.params_d),
            "ema": _change_norms(state0.params_g_ema, state3.params_g_ema)},
    }


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-12)


def _worst_leaf(p: np.ndarray, r: np.ndarray, keep=None) -> float:
    if keep is not None:
        p, r = p[keep], r[keep]
    if len(r) == 0:
        return 0.0
    den = np.maximum(r, np.median(r))
    den = np.where(den > 0, den, 1.0)
    return float(np.max(np.abs(p - r) / den))


def loss_gaps(got: dict, want: dict) -> Dict[str, float]:
    """Each loss's relative gap, by "<key>@<step>"."""
    out = {f"{k}@{i + 1}": _rel(gp[k], wp[k])
           for i, (gp, wp) in enumerate(zip(got["losses"], want["losses"]))
           for k in gp}
    out.update({f"{k}@1": _rel(got["first"][k], want["first"][k])
                for k in LOSSES_FIRST_STEP})
    return out


def _kept(want: dict) -> Dict[str, np.ndarray]:
    keep = {s: want["grad"][s] >= FLOOR * np.median(want["grad"][s])
            for s in ("g", "d")}
    keep["ema"] = keep["g"]
    return keep


def gaps(got: dict, want: dict) -> Dict[str, float]:
    losses = loss_gaps(got, want)
    keep = _kept(want)
    grad = max(_worst_leaf(got["grad"][s], want["grad"][s])
               for s in ("g", "d"))
    change = max(_rel(float(np.median(got["change"][s][keep[s]])),
                      float(np.median(want["change"][s][keep[s]])))
                 for s in ("g", "d", "ema"))
    return {**{name: losses[k] for name, k in COMPARED.items()},
            "grad_gap": grad, "change_gap": change}


def detail(got: dict, want: dict) -> Dict[str, float]:
    """What is not compared, for the record: every loss's gap, the worst
    leaf's change gap, and each side's gradient gaps by the worst and by
    the median leaf."""
    keep = _kept(want)
    out = dict(loss_gaps(got, want))
    for k in ("grad", "main_grad"):
        for s in ("g", "d"):
            out[f"{k}.{s}"] = _worst_leaf(got[k][s], want[k][s])
            out[f"{k}.{s}.median_leaf"] = _rel(
                float(np.median(got[k][s])), float(np.median(want[k][s])))
    out["change_worst_leaf"] = max(
        _worst_leaf(got["change"][s], want["change"][s], keep[s])
        for s in ("g", "d", "ema"))
    return out


def checks(got: dict, want: dict, limits: dict) -> List[Check]:
    return [Check(k, v, limits[k]) for k, v in gaps(got, want).items()]


def iteration_generator(seed: int, it: int, device) -> torch.Generator:
    """The draws of iteration `it`, as the training loop seeds them."""
    s = np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def schedule(cfg, it: int):
    """(do_r1, do_ppl) of absolute iteration `it`, the loop's rule."""
    tp = cfg.train_params
    return (it % tp.d_reg_every == 0,
            it % tp.g_reg_every == 0 and it >= tp.g_path_start)


def first_steps(cfg_json: dict, traffic: dict, seed: int, scale: float,
                device, rounding: str = "float32") -> dict:
    """The reference's summary of its first three iterations; rounding as
    render.render_sample takes it (the control)."""
    from portbench.reference.spgan.config import Config
    from portbench.reference.spgan.models import discriminator as d_mod
    from portbench.reference.spgan.models import generator as gen_mod
    from portbench.reference.spgan.train import state as st
    from portbench.reference.spgan.train.step import make_train_step

    cfg = build.make_config(Config, cfg_json, {})
    g = build.make_generator(gen_mod, cfg, cfg_json)
    d = d_mod.Discriminator.from_config(cfg)
    params_g = build.generator_params(cfg_json, seed, device, scale)
    params_d = build.discriminator_params(cfg_json, seed, device)
    opt_g, opt_d = st.make_optimizers(cfg)
    start = traffic["start_iteration"]
    state = st.TrainState(
        step=start, params_g=params_g, params_d=params_d,
        params_g_ema=build.clone_tree(params_g),
        opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
        mean_path_length=torch.zeros((), device=device))
    step = make_train_step(cfg, g, d)
    b = cfg.train_params.batch_size
    states, metrics = [state], []
    with float32_exact(), precision.rounded(rounding, device):
        for it in range(start, start + 3):
            real, ac = build.real_batch(seed, it, b, cfg, device)
            state, m = step(state, real, ac,
                            iteration_generator(seed, it, device),
                            *schedule(cfg, it))
            states.append(state)
            metrics.append(m)
    return summarize(states, metrics)
