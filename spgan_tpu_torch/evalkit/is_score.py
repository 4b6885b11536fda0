"""Inception Score (counterpart of spgan_tpu/evalkit/is_score.py; the
reference's libs/inception_score.py:14-71): exp of the mean KL between
p(y|x), the softmax of the fc logits, and p(y), per split."""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from spgan_tpu_torch.evalkit.fid import tf32_off


@torch.no_grad()
def inception_score(image_batches: Iterable, inception: torch.nn.Module,
                    splits: int = 1) -> Tuple[float, float]:
    """(mean, std) over `splits` of the score of image batches (B, H, W, 3)
    in [-1, 1]; `inception` is an InceptionV3FID with_logits."""
    dev = next(inception.parameters()).device
    probs = []
    for b in image_batches:
        with tf32_off():
            logits = inception(torch.as_tensor(b).to(dev, torch.float32))
        probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
    preds = np.concatenate(probs, 0)
    n = preds.shape[0]
    scores = []
    for k in range(splits):
        part = preds[k * (n // splits):(k + 1) * (n // splits)]
        py = part.mean(0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))
