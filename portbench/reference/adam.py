"""A plain Adam over a few training steps of a reference model, in
float32: the loss and logits of each step from ``loss_of``, gradients by
autograd, then

    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

(Kingma and Ba, 2015; torch's and optax's defaults), as
``reference/train.py`` steps the conditioned-graph model.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def adam_steps(loss_of: Callable, w0: Dict[str, torch.Tensor],
               batches: List[dict], lr: float, betas=(0.9, 0.999),
               eps: float = 1e-8):
    """Train ``len(batches)`` steps from ``w0``; ``loss_of(w, batch)``
    gives (loss, logits) and draws its step's dropout. Returns (losses,
    the first step's gradients, the change of every parameter over all
    the steps, the first step's logits)."""
    names = list(w0)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w0.items()}
    nu = {k: torch.zeros_like(v) for k, v in w0.items()}
    b1, b2 = betas
    losses, grad1, logits1 = [], {}, None
    for t, bt in enumerate(batches, 1):
        loss, logits = loss_of(w, bt)
        if t == 1:
            logits1 = logits.detach().clone()
        grads = torch.autograd.grad(loss, [w[n] for n in names],
                                    allow_unused=True)
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = torch.zeros_like(w[n]) if g is None else g
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = (mu[n] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[n] / (1 - b2 ** t)) + eps)
                w[n].sub_(lr * step)
                if t == 1:
                    grad1[n] = g.detach().clone()
        losses.append(float(loss.detach()))
    change = {n: (w[n].detach() - w0[n]) for n in names}
    return losses, grad1, change, logits1
