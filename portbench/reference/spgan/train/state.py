"""Training state: G/D params, optimizers, EMA, PPL running mean
(counterpart of spgan_tpu/train/state.py).

Optimizer parity: Adam with the lazy-regularizer discount: for a module
regularized every N steps, lr *= N/(N+1) and betas = (0 ** ratio,
0.99 ** ratio) with ratio = N/(N+1) (the benchmark's configurations
train with Adam).  lr_sch halves every update from each of its
milestones on.  EMA decay 0.5 ** (32/10000).
Parameters, moments and counts are trees of tensors (see tree.py); every
update is functional (new tensors, the old state stays valid).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from portbench.reference.spgan.config import Config
from portbench.reference.spgan.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class AdamState:
    mu: Any
    nu: Any
    count: Any  # int32 0-d tensor PER LEAF (torch keeps per-param step)


@dataclass
class TrainState:
    step: int
    params_g: Any
    params_d: Any
    params_g_ema: Any
    opt_g: Any       # AdamState
    opt_d: Any
    mean_path_length: torch.Tensor


def reg_ratio(reg_every: int) -> float:
    return reg_every / (reg_every + 1.0)


@dataclass(frozen=True)
class TorchAdam:
    """Adam with torch.optim.Adam's PER-PARAMETER lazy-state semantics.

    A phase leaves some parameters out of its graph (the D coord-AC head
    gets no gradient in the R1 phase) and torch skips a None-grad parameter
    entirely: no step-count increment, no moment decay, no update.  Here a
    leaf is skipped when its gradient is None or identically zero, or when
    the optional `active` tree (python bools) says so; the zero test runs
    on the device, with no host sync.  torch.optim.Adam itself keeps one
    state per parameter object but cannot take that explicit mask, so the
    port keeps its own.

    Per active leaf (no weight decay):
      m <- b1*m + (1-b1)*g ; v <- b2*v + (1-b2)*g^2 ; c <- c+1
      update = -lr * (m / (1-b1^c)) / (sqrt(v / (1-b2^c)) + eps)
    """

    lr: float
    b1: float
    b2: float
    eps: float = 1e-8

    def init(self, params: Any) -> AdamState:
        return AdamState(
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
            count=tree_map(lambda p: torch.zeros((), dtype=torch.int32,
                                                 device=p.device), params))

    def update(self, params: Any, grads: Any, state: AdamState,
               active: Optional[Any] = None):
        """Returns (updates, new state): updates is a list in tree_leaves
        order, None where a leaf is skipped.  grads: a tree of tensors or
        None (skipped); active: an optional tree of python bools that
        overrides the zero test (True: stepped even with a zero grad)."""
        b1, b2, lr, eps = self.b1, self.b2, self.lr, self.eps
        p_l = tree_leaves(params)
        g_l = tree_leaves(grads)
        a_l = (tree_leaves(active) if active is not None
               else [None] * len(p_l))
        out = {"u": [], "mu": [], "nu": [], "count": []}
        for p, g, a, m, n, c in zip(p_l, g_l, a_l, tree_leaves(state.mu),
                                    tree_leaves(state.nu),
                                    tree_leaves(state.count)):
            if a is False or (a is None and g is None):
                # skipped: known on the host, nothing changes
                for k, v in (("u", None), ("mu", m), ("nu", n), ("count", c)):
                    out[k].append(v)
                continue
            if g is None:
                g = torch.zeros_like(p)
            if a is None:       # active iff the gradient is not all zero
                act = (g != 0).any()
                c = c + act.to(torch.int32)
                m = torch.where(act, b1 * m + (1 - b1) * g, m)
                n = torch.where(act, b2 * n + (1 - b2) * g * g, n)
            else:
                c = c + 1
                m = b1 * m + (1 - b1) * g
                n = b2 * n + (1 - b2) * g * g
            cf = c.float()
            bc1 = torch.where(c > 0, 1.0 - b1 ** cf, torch.ones_like(cf))
            bc2 = torch.where(c > 0, 1.0 - b2 ** cf, torch.ones_like(cf))
            upd = -lr * ((m / bc1) / (torch.sqrt(n / bc2) + eps))
            if a is None:
                upd = torch.where(act & (c > 0), upd, torch.zeros_like(m))
            out["u"].append(upd)
            out["mu"].append(m)
            out["nu"].append(n)
            out["count"].append(c)
        return out["u"], AdamState(mu=tree_unflatten(params, out["mu"]),
                                   nu=tree_unflatten(params, out["nu"]),
                                   count=tree_unflatten(params, out["count"]))

    def step(self, params: Any, grads: Any, state: AdamState,
             active: Optional[Any] = None, **apply_kw):
        """update, then apply_updates: returns (new params, new state)."""
        upd, state = self.update(params, grads, state, active)
        return apply_updates(params, upd, **apply_kw), state


def apply_updates(params: Any, updates: List[Optional[torch.Tensor]],
                  frozen: Optional[Any] = None,
                  factor: Optional[float] = None) -> Any:
    """params + updates, leaf by leaf (updates in tree_leaves order; None
    leaves the parameter as it is).  frozen: a tree of python bools whose
    True leaves keep their value (the JAX step zeroes their update after
    the optimizer, so the optimizer's moments still advance); factor: the
    lr schedule's factor, multiplying every update."""
    f_l = (tree_leaves(frozen) if frozen is not None
           else [False] * len(updates))
    out = []
    for p, u, fz in zip(tree_leaves(params), updates, f_l):
        if u is None or fz:
            out.append(p)
            continue
        if factor is not None:
            u = u * factor
        out.append(p + u.to(p.dtype))
    return tree_unflatten(params, out)


def make_optimizers(cfg: Config):
    tp = cfg.train_params
    g_ratio = reg_ratio(tp.g_reg_every)
    d_ratio = reg_ratio(tp.d_reg_every)
    if tp.optimizer != "adam":
        raise ValueError(f"the reference trains with Adam, not "
                         f"{tp.optimizer!r}")
    opt_g = TorchAdam(tp.lr * g_ratio, b1=0.0 ** g_ratio, b2=0.99 ** g_ratio)
    opt_d = TorchAdam(tp.lr * d_ratio * tp.d_weight, b1=0.0 ** d_ratio,
                      b2=0.99 ** d_ratio)
    return opt_g, opt_d


def lr_schedule_factor(cfg: Config, step: int) -> Optional[float]:
    """MultiStepLR(gamma=0.5) factor at iteration `step`: 0.5 per milestone
    of lr_sch that step has reached (both optimizers step their schedulers
    once an iteration); None without lr_sch."""
    tp = cfg.train_params
    if not tp.lr_sch:
        return None
    f = 1.0
    for m in tp.lr_sch:
        if step >= m:
            f *= 0.5
    return f


EMA_ACCUM = 0.5 ** (32.0 / (10 * 1000))


def ema_update(ema_params: Any, params: Any,
               accum: float = EMA_ACCUM) -> Any:
    """par_ema = accum * par_ema + (1 - accum) * par."""
    return tree_map(lambda e, p: e * accum + p * (1.0 - accum),
                    ema_params, params)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [g for g in tree_leaves(tree) if g is not None]
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))
