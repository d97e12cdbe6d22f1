"""Train and eval steps.

Counterpart of ``vqa_project_tpu/train/steps.py`` in host mode: batches
carry dense images, answers and votes (``data.loader.Batcher``), and one
step is forward, masked loss, backward, Adam and the score. The sparse
label helpers (``densify_labels``, ``sparse_vqa_score``) are the JAX
package's device-side ones, for batches that carry only sparse entries.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vqa_project_tpu_torch.ops.losses import (multilabel_soft_margin_loss,
                                              vqa_score)

_KEYS = ("question", "image", "qlen", "answers", "votes", "mask")


def densify_labels(idx: torch.Tensor, val: torch.Tensor,
                   n_classes: int) -> torch.Tensor:
    """Scatter sparse (B, S) index/value label entries into dense (B, C)
    float32. Pad entries point at column n_classes-1, which is cleared
    afterwards (the unused '+1' answer slot)."""
    dense = torch.zeros((idx.shape[0], n_classes), dtype=torch.float32,
                        device=idx.device)
    dense.scatter_(1, idx.long(), val.float())
    dense[:, n_classes - 1] = 0.0
    return dense


def sparse_vqa_score(logits: torch.Tensor, vote_idx: torch.Tensor,
                     vote_val: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Official VQA score from sparse vote entries, min(votes[pred]/3, 1)
    summed over the batch, without the dense (B, C) votes."""
    pred = torch.argmax(logits, dim=-1)
    hit = (vote_idx.long() == pred[:, None]).float()
    picked = (hit * vote_val.float()).sum(dim=-1)
    score = torch.clamp(picked / 3.0, max=1.0)
    if mask is not None:
        score = torch.where(mask > 0, score, torch.zeros_like(score))
    return score.sum()


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """The fields a step reads, as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in _KEYS}


def train_step(model, optimizer, scheduler, batch: Dict[str, np.ndarray],
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One step: train-mode forward (dropout from ``generator``), the
    masked soft-margin loss, backward, the optimizer and the scheduler.

    Returns 0-d tensors on the model's device (reading them waits for
    the step): loss, score (the summed VQA score of the train-mode
    logits, padded rows 0) and valid (the count of unpadded rows).
    """
    dev = next(model.parameters()).device
    b = to_device(batch, dev)
    logits, _, _ = model(b["question"], b["image"], b["qlen"], train=True,
                         generator=generator)
    loss = multilabel_soft_margin_loss(logits, b["answers"], b["mask"])
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    with torch.no_grad():
        score = vqa_score(logits, b["votes"], b["mask"])
    return {"loss": loss.detach(), "score": score, "valid": b["mask"].sum()}


def eval_step(model, batch: Dict[str, np.ndarray]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval forward: (preds (B,) int32, summed VQA score). The last
    column, the answer vocabulary's pad slot, never wins: it has no word
    and is never a label."""
    dev = next(model.parameters()).device
    b = to_device(batch, dev)
    logits, _, _ = model(b["question"], b["image"], b["qlen"])
    logits[:, -1] = float("-inf")
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    return preds, vqa_score(logits, b["votes"], b["mask"])
