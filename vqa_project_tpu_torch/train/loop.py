"""The training loop.

Counterpart of ``vqa_project_tpu/train/loop.py::fit`` in host mode (what
``run.py --train`` / ``--trainval`` call): shuffled fixed-shape batches,
one ``train_step`` each, the loss and accuracy logged per window of
``log_interval`` steps (one device-to-host fetch per window), the epoch
accuracy, and every ``eval_interval`` steps a 10-batch mini-validation
plus a checkpoint. (Resuming from a checkpoint, and evaluation to
``result.json``, come with the CLI.)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from vqa_project_tpu_torch.config import (ModelConfig, TrainConfig,
                                          resolve_device)
from vqa_project_tpu_torch.data.datasets import GraphVQADataset
from vqa_project_tpu_torch.data.loader import Batcher
from vqa_project_tpu_torch.models.graph_vqa import GraphVQAModel
from vqa_project_tpu_torch.train.metrics import MetricLogger
from vqa_project_tpu_torch.train.state import (make_optimizer,
                                               save_checkpoint)
from vqa_project_tpu_torch.train.steps import eval_step, train_step


def build_model(model_cfg: ModelConfig, ds: GraphVQADataset, *,
                device="cuda", seed: int = 1000) -> GraphVQAModel:
    """The model at the dataset's widths (vocabulary, embedding, feature,
    answer and object counts, question length), weights from ``seed``
    and the dataset's word embeddings."""
    cfg = dataclasses.replace(
        model_cfg, vocab_size=ds.q_words,
        emb_dim=ds.pretrained_wemb.shape[1], feat_dim=ds.feat_dim,
        out_dim=ds.n_answers, n_obj=ds.n_obj, max_qlen=ds.max_qlen)
    model = GraphVQAModel(cfg, device=device, seed=seed)
    with torch.no_grad():
        model.wembed.weight.copy_(torch.from_numpy(ds.pretrained_wemb))
    return model


def _batches_forever(batcher: Batcher):
    while True:
        yield from batcher


def mini_validation(model, val_iter, n_batches: int = 10) -> float:
    """Accuracy (%) over ``n_batches`` random validation batches; the
    denominator counts only unpadded rows."""
    correct, n_valid = 0.0, 0.0
    for _ in range(n_batches):
        batch = next(val_iter)
        n_valid += float(batch["mask"].sum())
        _, score = eval_step(model, batch)
        correct += float(score)
    return correct / max(n_valid, 1.0) * 100.0


def fit(train_cfg: TrainConfig, model_cfg: ModelConfig,
        train_ds: GraphVQADataset,
        val_ds: Optional[GraphVQADataset] = None, *, device="cuda",
        jsonl_path: Optional[str] = None
        ) -> Tuple[GraphVQAModel, torch.optim.Optimizer, float]:
    """Train for ``train_cfg.epochs`` epochs; returns (model, optimizer,
    accuracy % of the last epoch). Batches are shuffled per epoch from
    ``train_cfg.seed`` and the last partial batch is dropped; dropout
    draws from one generator on the device, seeded likewise. With
    ``val_ds``, every ``eval_interval`` steps runs a mini-validation and
    writes ``{save_dir}/{name}_{epoch+1}.ckpt``; ``jsonl_path`` receives
    one record per logged window."""
    dev = resolve_device(device)
    bs = train_cfg.batch_size
    model = build_model(model_cfg, train_ds, device=dev,
                        seed=train_cfg.seed)
    loader = Batcher(train_ds, bs, shuffle=True, seed=train_cfg.seed,
                     drop_last=True)
    steps_per_epoch = len(loader)
    optimizer, scheduler = make_optimizer(model, train_cfg, steps_per_epoch)
    generator = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    step = 0
    val_iter = None
    if val_ds is not None:
        val_iter = _batches_forever(Batcher(val_ds, bs, shuffle=True,
                                            seed=train_cfg.seed + 1))
    logger = MetricLogger(train_cfg.log_interval, jsonl_path, batch_size=bs)

    def checkpoint(ep: int, step_in_epoch: int) -> None:
        save_checkpoint(
            os.path.join(train_cfg.save_dir, f"{train_cfg.name}_{ep + 1}.ckpt"),
            model, optimizer, scheduler, step=step, epoch=ep + 1,
            generator=generator, model_cfg=model.cfg, train_cfg=train_cfg,
            extra={"step_in_epoch": int(step_in_epoch)})

    epoch_acc = 0.0
    for ep in range(train_cfg.epochs):
        totals = np.zeros(3)           # loss, score, valid rows
        n_steps = 0
        window = []

        def flush_window():
            # one device-to-host fetch for the whole window
            vals = torch.stack([torch.stack([m["loss"], m["score"],
                                             m["valid"]]) for m in window])
            sums = vals.double().sum(dim=0).cpu().numpy()
            totals[:] += sums
            logger.log_window(epoch=ep, step=step, loss_sum=float(sums[0]),
                              score_sum=float(sums[1]), n=len(window),
                              examples=float(sums[2]),
                              lr=scheduler.get_last_lr()[0])
            window.clear()

        for batch in loader:
            window.append(train_step(model, optimizer, scheduler, batch,
                                     generator))
            step += 1
            n_steps += 1
            if len(window) >= logger.log_interval:
                flush_window()
            if (val_iter is not None and train_cfg.eval_interval
                    and n_steps % train_cfg.eval_interval == 0):
                acc = mini_validation(model, val_iter)
                print(f"Validation accuracy: {acc:.2f} %", flush=True)
                checkpoint(ep, n_steps % steps_per_epoch)
        if window:
            flush_window()
        epoch_acc = 100.0 * totals[1] / max(totals[2], 1.0)
        print("Epoch %02d done, average loss: %.3f, average accuracy: "
              "%.2f%%" % (ep + 1, totals[0] / max(n_steps, 1), epoch_acc),
              flush=True)
    logger.close()
    return model, optimizer, epoch_acc
