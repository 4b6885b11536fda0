"""GAN losses and regularizers (counterpart of spgan_tpu/models/losses.py).

R1 and PPL take double gradients through torch.autograd.grad with
create_graph=True; every op on both paths (the straight-through samplers
included) is plain tensor algebra, so the double backward exists.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def d_logistic_loss(real_pred: torch.Tensor,
                    fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_pred).mean()


def d_r1_penalty(d_fn: Callable, params: dict, real_img: torch.Tensor,
                 **d_kwargs) -> torch.Tensor:
    """Mean over samples of the squared gradient norm of sum(D(real)) w.r.t.
    the real image.  d_fn(params, img, **d_kwargs) -> {"d_patch": (B,1)}
    (d_kwargs carry the ac labels and the train flag of the projection
    head); the graph is kept, so the penalty differentiates w.r.t.
    params."""
    img = real_img.detach().requires_grad_(True)
    out = d_fn(params, img, **d_kwargs)["d_patch"].sum()
    (grad,) = torch.autograd.grad(out, img, create_graph=True)
    return grad.square().reshape(grad.shape[0], -1).sum(1).mean()


def grad_reduce(grad: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(g^2)) over every non-batch axis: (B,)."""
    return torch.sqrt(grad.square().mean(dim=tuple(range(1, grad.ndim))))


def ppl_lengths(synth_fn: Callable, styles: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """Path length per sample: |d <synth(styles), noise> / d styles|,
    reduced by grad_reduce.  `noise` is the perturbation image, already
    including the 1/sqrt(H*W) scale (the training step draws it with the
    step's other draws).  The graph is kept."""
    img = synth_fn(styles)
    (g,) = torch.autograd.grad((img * noise).sum(), styles, create_graph=True)
    return grad_reduce(g)


def g_path_regularize(lengths: torch.Tensor, mean_path_length: torch.Tensor,
                      decay: float = 0.01):
    """Returns (penalty, new_mean); the running mean moves by
    decay * (batch mean - mean), and the returned mean is detached."""
    path_mean = mean_path_length + decay * (lengths.mean() - mean_path_length)
    penalty = (lengths - path_mean).square().mean()
    return penalty, path_mean.detach()


def coord_ac_loss(pred: torch.Tensor, label: torch.Tensor,
                  vert_only: bool = True,
                  hori_only: bool = False) -> torch.Tensor:
    """L1 between predicted and true crop coordinates (vertical only with
    the shipped config)."""
    if vert_only:
        return (pred[:, 0] - label[:, 0]).abs().mean()
    if hori_only:
        return (pred[:, 1] - label[:, 1]).abs().mean()
    return (pred - label).abs().mean()

