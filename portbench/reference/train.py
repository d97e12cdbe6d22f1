"""The reference's first training steps: forward, loss, gradients by
autograd and a plain Adam, in float32 (or the fp8 control).

Adam (Kingma and Ba, 2015) with torch's and optax's defaults:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference.dropout import draw
from portbench.reference.model import Reference, soft_margin_loss


def run_steps(ref: Reference, w0: Dict[str, torch.Tensor], batches: List[dict],
              lr: float, rate: float, gen_seed: int, device,
              betas=(0.9, 0.999), eps: float = 1e-8):
    """Train ``len(batches)`` steps from ``w0``. Each batch holds
    question, qlen, feats, boxes, answers (dense) and mask. Returns
    (losses, the first step's gradients, the change of every parameter
    over all the steps, the first step's logits)."""
    names = list(w0)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w0.items()}
    nu = {k: torch.zeros_like(v) for k, v in w0.items()}
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    b1, b2 = betas
    losses, grad1, logits1 = [], None, None
    for t, bt in enumerate(batches, 1):
        b, k, f = bt["feats"].shape
        d = draw(gen, b, k, f + 4, ref.m["out_dim"], rate, device)
        logits = ref.forward(w, bt["question"], bt["qlen"], bt["feats"],
                             bt["boxes"], d)
        loss = soft_margin_loss(logits, bt["answers"], bt["mask"])
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
                    grad1 = grad1 or {}
                    grad1[n] = g.detach().clone()
        losses.append(float(loss.detach()))
    change = {n: (w[n].detach() - w0[n]) for n in names}
    return losses, grad1, change, logits1
