"""Train and eval steps, in host mode and with a device feature cache.

Counterpart of ``vqa_project_tpu/train/steps.py``. Ingest modes:

- device-cache mode: region features and boxes live on the device
  (a ``(features, boxes)`` pair or a ``QuantizedFeatureCache``); a batch
  carries token ids, lengths, image rows and SPARSE answer/vote entries
  (``data.loader.pack_index_batch``), and the step gathers its images
  as the model's node rows in one launch (``make_image_fn``, a
  ``NodeImage``) and densifies its labels on the device;
- host mode: the batch carries dense images, answers and votes.

One training step is forward, masked loss, backward, Adam and the score;
``eval_epoch`` runs a whole resident eval epoch with no fetch inside its
loop.

Across data-parallel ranks (``parallel.Mesh``) each rank steps on its
rows of the global batch: its loss is its masked sum over the GLOBAL
valid count, and the gradients are summed over the ranks before Adam
(``parallel.all_reduce_grads``, one flat buffer, f32 or bf16), so every
rank applies the global masked mean's gradient: JAX's rule
(``train/steps.py::_build_bf16_reduce_step``), which DDP's average of
per-rank means is not wherever the ranks' valid counts differ.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vqa_project_tpu_torch.config import device_guard, torch_dtype
from vqa_project_tpu_torch.data.loader import DENSE_KEYS, pack_index_batch
from vqa_project_tpu_torch.ops.gather_rows import NodeImage, gather_image_rows
from vqa_project_tpu_torch.ops.losses import (multilabel_soft_margin_loss,
                                              vqa_score)
from vqa_project_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from vqa_project_tpu_torch.parallel.sharded_cache import ShardedFeatureCache


class QuantizedFeatureCache(NamedTuple):
    """int8 device feature table with per-box dequantization scales
    (``ops.quant.quantize_feature_table``): a quarter of the f32 table's
    memory, half of bf16's. The gather dequantizes the rows to
    ``out_dtype``, which must be the model's compute dtype; the model is
    unchanged."""

    features: torch.Tensor   # (N, K, F) int8
    scales: torch.Tensor     # (N, K) float32
    boxes: torch.Tensor      # (N, K, 4) float32
    out_dtype: str           # dequantization target


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


def make_image_fn(feature_cache, compute_dtype: str,
                  merged_block: bool = False) -> Optional[Callable]:
    """``rows (B,) int32 -> NodeImage`` for a device feature cache, or
    None in host mode (no cache).

    One launch of ``gather_image_rows`` writes the model's input: the
    node rows feat||bbox in ``compute_dtype`` (an int8 cache dequantized
    there), in rows padded for the merged block when ``merged_block``,
    and the f32 boxes. An int8 cache must dequantize to ``compute_dtype``.
    """
    if feature_cache is None:
        return None
    if isinstance(feature_cache, ShardedFeatureCache):
        return feature_cache.gather_fn(compute_dtype, merged_block)
    node_dtype = torch_dtype(compute_dtype)
    if isinstance(feature_cache, QuantizedFeatureCache):
        features, scales, boxes, out = feature_cache
        if torch_dtype(out) != node_dtype:
            raise ValueError(f"the int8 cache dequantizes to {out}, the "
                             f"model computes in {compute_dtype}")
    else:
        (features, boxes), scales = feature_cache, None

    def image_fn(rows) -> NodeImage:
        with device_guard(rows.device):
            return gather_image_rows(features, boxes, rows, scales,
                                     node_dtype, padded=merged_block)

    return image_fn


def supports_bf16_reduce(feature_cache) -> Tuple[bool, Optional[str]]:
    """(ok, why): the bf16 gradient all-reduce takes a replicated device
    cache or host mode; ``why`` names the cache it refuses. One rule for
    ``train_step``'s refusal and ``fit``'s degrade to float32 (JAX's
    ``supports_bf16_reduce`` less its model-parallel mesh)."""
    if isinstance(feature_cache, ShardedFeatureCache):
        return False, f"a {type(feature_cache).__name__} feature cache"
    return True, None


def unpack_index_batch(batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of ``data.loader.pack_index_batch``, on the device; every
    field contiguous."""
    ints, floats = batch["ints"], batch["floats"]
    s = (floats.shape[1] - 1) // 2
    t = ints.shape[1] - 2 - 2 * s
    fields = {
        "question": ints[:, :t],
        "qlen": ints[:, t],
        "image_row": ints[:, t + 1],
        "ans_idx": ints[:, t + 2:t + 2 + s],
        "vote_idx": ints[:, t + 2 + s:],
        "ans_score": floats[:, :s],
        "vote_val": floats[:, s:2 * s],
        "mask": floats[:, 2 * s],
    }
    return {k: v.contiguous() for k, v in fields.items()}


def to_device(batch: Dict[str, object],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """The fields a step reads, as tensors on ``device``: an index
    batch's packed pair (``ints``/``floats``; a host index batch is
    packed first) or a host batch's dense fields."""
    if "image_row" in batch:
        batch = pack_index_batch(batch)
    keys = ("ints", "floats") if "ints" in batch else DENSE_KEYS
    out = {}
    for k in keys:
        v = batch[k]
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    return out


def _assemble_inputs(batch: Dict[str, torch.Tensor],
                     image_fn: Optional[Callable], n_answers: int):
    """(question, image, qlen, mask, answers_fn, score_fn) of a device
    batch: host mode reads the dense fields, cache mode gathers the
    images and densifies the labels on the device."""
    if "ints" in batch:
        batch = {**batch, **unpack_index_batch(batch)}
    if image_fn is None:
        if "image" not in batch:
            raise ValueError("an index batch needs a device feature cache")
        return (batch["question"], batch["image"], batch["qlen"],
                batch["mask"], lambda: batch["answers"],
                lambda logits, mask=None: vqa_score(logits, batch["votes"],
                                                    mask))
    image = image_fn(batch["image_row"])
    return (batch["question"], image, batch["qlen"], batch["mask"],
            lambda: densify_labels(batch["ans_idx"], batch["ans_score"],
                                   n_answers),
            lambda logits, mask=None: sparse_vqa_score(
                logits, batch["vote_idx"], batch["vote_val"], mask))


def train_step(model, optimizer, scheduler, batch: Dict[str, object],
               generator: Optional[torch.Generator] = None,
               image_fn: Optional[Callable] = None,
               mesh: Optional[Mesh] = None, n_valid: Optional[float] = None,
               grad_reduce_dtype: str = "float32"
               ) -> Dict[str, torch.Tensor]:
    """One step: train-mode forward (dropout from ``generator``), the
    masked soft-margin loss, backward, the optimizer and the scheduler.

    ``batch`` is a host batch (numpy or tensors) or, with ``image_fn``
    from ``make_image_fn``, an index batch (packed or not). Returns 0-d
    tensors on the model's device (reading them waits for the step):
    loss, score (the summed VQA score of the train-mode logits, padded
    rows 0) and valid (the count of unpadded rows).

    Inside a process group (``mesh.distributed``) ``batch`` is this
    rank's rows and ``n_valid`` the global batch's valid count: the loss
    is this rank's share of the global masked mean, and the gradients are
    summed over the ranks in ``grad_reduce_dtype`` before the optimizer
    (bf16 only at world > 1, refused for a sharded cache by the caller);
    the returned loss, score and valid are this rank's shares.
    """
    dp = mesh is not None and mesh.distributed
    if dp and n_valid is None:
        raise ValueError("a data-parallel step needs the global batch's "
                         "valid count (n_valid)")
    if dp and mesh.world > 1 and grad_reduce_dtype == "bfloat16":
        ok, why = supports_bf16_reduce(getattr(image_fn, "feature_cache",
                                               None))
        if not ok:
            raise ValueError(
                f"grad_reduce_dtype=bfloat16 does not support {why}: it "
                "needs a replicated device feature cache or host-mode "
                "batches")
    dev = next(model.parameters()).device
    question, image, qlen, mask, answers_fn, score_fn = _assemble_inputs(
        to_device(batch, dev), image_fn, model.cfg.out_dim)
    logits, _, _ = model(question, image, qlen, train=True,
                         generator=generator)
    # a fill, not a copy: the global count reaches the card as a launch
    # argument
    count = (torch.full((), float(n_valid), dtype=torch.float32, device=dev)
             if dp else None)
    loss = multilabel_soft_margin_loss(logits, answers_fn(), mask, count)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if dp:
        all_reduce_grads(model, mesh, grad_reduce_dtype)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    with torch.no_grad():
        score = score_fn(logits, mask)
    return {"loss": loss.detach(), "score": score, "valid": mask.sum()}


def _eval_forward(model, b, image_fn):
    question, image, qlen, mask, _, score_fn = _assemble_inputs(
        b, image_fn, model.cfg.out_dim)
    logits, adjacency, _ = model(question, image, qlen)
    # the last column, the answer vocabulary's pad slot, never wins: it
    # has no word and is never a label
    logits[:, -1] = float("-inf")
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    return preds, score_fn(logits, mask), adjacency


def eval_step(model, batch: Dict[str, object],
              image_fn: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eval forward of a host batch, or of an index batch with
    ``image_fn``: (preds (B,) int32, summed VQA score, adjacency
    (B, K, K) f32), on the model's device."""
    dev = next(model.parameters()).device
    return _eval_forward(model, to_device(batch, dev), image_fn)


def stack_epoch_batches(batches: Sequence[Dict[str, np.ndarray]],
                        device) -> Tuple[Dict[str, torch.Tensor], int]:
    """Index batches as one resident epoch: each is packed
    (``pack_index_batch``), the (S, B, ...) stack of ints and float bits
    goes to ``device`` in ONE copy, and the result is the pair of views
    ``{"ints": (S, B, Wi) int32, "floats": (S, B, Wf) float32}`` with
    S = the number of batches."""
    if not batches:
        raise ValueError("an empty epoch")
    if "image_row" not in batches[0]:
        raise ValueError("a resident epoch needs index batches "
                         "(a device feature cache)")
    packed = [pack_index_batch(b) for b in batches]
    ints = np.stack([p["ints"] for p in packed])
    floats = np.ascontiguousarray(np.stack([p["floats"] for p in packed]))
    buf = torch.from_numpy(np.concatenate(
        [ints, floats.view(np.int32)], axis=-1)).to(device)
    wi = ints.shape[-1]
    return ({"ints": buf[..., :wi],
             "floats": buf[..., wi:].view(torch.float32)}, len(batches))


def eval_epoch(model, epoch: Dict[str, torch.Tensor],
               image_fn: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward over every batch of a resident epoch
    (``stack_epoch_batches``): (summed VQA score, 0-d f32; preds (S, B)
    int32), both on the device. The loop over steps fetches nothing; the
    caller fetches the two results once."""
    if image_fn is None:
        raise ValueError("a resident eval epoch needs a device feature "
                         "cache")
    ints, floats = epoch["ints"], epoch["floats"]
    s_steps, b = ints.shape[:2]
    total = torch.zeros((), dtype=torch.float32, device=ints.device)
    preds = torch.empty((s_steps, b), dtype=torch.int32, device=ints.device)
    for s in range(s_steps):
        p, score, _ = _eval_forward(
            model, {"ints": ints[s], "floats": floats[s]}, image_fn)
        preds[s] = p
        total += score
    return total, preds
