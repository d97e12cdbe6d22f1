"""Optimizer, learning-rate schedule and checkpoints.

Counterpart of ``vqa_project_tpu/train/state.py``: Adam (betas 0.9 /
0.999, eps 1e-8, as torch's and optax's defaults) with the reference's
MultiStepLR, and one checkpoint format, a full dict with the weights
under the reference's state_dict names, written to a unique temporary
name and renamed into place so a reader never sees half a file.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import tempfile
from typing import Optional

import torch

from vqa_project_tpu_torch.config import TrainConfig


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig,
                   steps_per_epoch: int):
    """(Adam, MultiStepLR) with the milestones in steps (epoch milestone
    x steps_per_epoch), stepped once per step: update u (1-based) uses
    lr * gamma^(number of milestones m with u > m), as the JAX package's
    optax piecewise-constant schedule does."""
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    spe = max(int(steps_per_epoch), 1)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[int(m) * spe for m in cfg.lr_milestones],
        gamma=cfg.lr_gamma)
    return optimizer, scheduler


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    scheduler=None, *, step: int = 0, epoch: int = 0,
                    generator: Optional[torch.Generator] = None,
                    model_cfg=None, train_cfg=None,
                    extra: Optional[dict] = None) -> None:
    """One full dict: ``state_dict`` (CPU, reference names), optimizer
    and scheduler state, step, epoch (the next one to run), the dropout
    generator's state, both configs and ``extra``. Written to a unique
    temporary file beside ``path``, then renamed onto it."""
    sched = None
    if scheduler is not None:
        sched = scheduler.state_dict()
        # a plain dict: torch.load(weights_only=True) refuses Counter
        sched["milestones"] = dict(sched["milestones"])
    payload = {
        "state_dict": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict() if optimizer else None,
        "scheduler": sched,
        "step": int(step),
        "epoch": int(epoch),
        "generator": generator.get_state() if generator else None,
        "model_config": (dataclasses.asdict(model_cfg)
                         if model_cfg is not None else None),
        "train_config": (dataclasses.asdict(train_cfg)
                         if train_cfg is not None else None),
        "extra": dict(extra or {}),
    }
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(path: str, model: Optional[torch.nn.Module] = None,
                    optimizer=None, scheduler=None,
                    generator: Optional[torch.Generator] = None) -> dict:
    """Read a checkpoint of ``save_checkpoint`` and restore whatever of
    model, optimizer, scheduler and generator is given; returns the
    payload (step, epoch, extra, configs)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if model is not None:
        model.load_state_dict(payload["state_dict"])
    if optimizer is not None and payload.get("optimizer") is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None and payload.get("scheduler") is not None:
        sched = dict(payload["scheduler"])
        sched["milestones"] = collections.Counter(sched["milestones"])
        scheduler.load_state_dict(sched)
    if generator is not None and payload.get("generator") is not None:
        generator.set_state(payload["generator"])
    return payload
