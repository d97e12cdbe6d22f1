"""Loss and metric functions.

Counterpart of ``vqa_project_tpu/ops/losses.py``:

- the soft-target multi-label BCE-with-logits of
  ``nn.MultiLabelSoftMarginLoss`` (mean over classes, then over the
  batch), with an optional per-sample validity mask;
- the official VQA score min(#votes[pred] / 3, 1), summed over a batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def soft_margin_per_sample(logits: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """(B, C) logits and soft labels -> (B,) class-mean of
    ``y * softplus(-x) + (1 - y) * softplus(x)``, in float32."""
    x = logits.float()
    y = targets.float()
    elem = y * F.softplus(-x) + (1.0 - y) * F.softplus(x)
    return elem.mean(dim=-1)


def multilabel_soft_margin_loss(
        logits: torch.Tensor, targets: torch.Tensor,
        sample_mask: Optional[torch.Tensor] = None,
        count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar float32 loss: the mean of ``soft_margin_per_sample`` over
    the rows whose ``sample_mask`` is > 0 (all rows without a mask).

    The mask is applied by ``where``, not by multiplication: a padded row
    may hold logits that are inf or NaN, and 0 * inf would poison the
    mean (and its gradient).

    ``count`` (0-d float32) replaces the mask's sum as the denominator: a
    data-parallel rank passes the GLOBAL batch's valid count, so that the
    ranks' losses, and their gradients, sum to the global masked mean's.
    """
    per_sample = soft_margin_per_sample(logits, targets)
    if sample_mask is None:
        return per_sample.mean()
    m = sample_mask.float()
    per_sample = torch.where(m > 0, per_sample, torch.zeros_like(per_sample))
    return per_sample.sum() / torch.clamp(m.sum() if count is None else count,
                                          min=1.0)


def vqa_score(logits: torch.Tensor, n_votes: torch.Tensor,
              sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar float32: the sum over the batch of min(votes[argmax] / 3, 1);
    rows whose mask is 0 count 0."""
    pred = torch.argmax(logits, dim=-1)
    votes = torch.gather(n_votes.float(), -1, pred[:, None])[:, 0]
    score = torch.clamp(votes / 3.0, max=1.0)
    if sample_mask is not None:
        score = score * sample_mask.float()
    return score.sum()
