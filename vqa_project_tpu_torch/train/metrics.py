"""Windowed training metrics to stdout and JSONL.

Copy of ``vqa_project_tpu/train/metrics.py::MetricLogger``: every
``log_interval`` steps (40 by default, the reference's loss averaging)
one reference-style line and one JSON record with the window's mean
loss, VQA accuracy, steps/s and QA pairs/s per chip (``n_chips`` ranks
share the global batch). Only rank 0 writes the JSONL file; every rank
logs the same global numbers, whose per-rank shares ``window_sums``
adds up with one all_reduce per window.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vqa_project_tpu_torch.parallel import multihost


def window_sums(window: List[Dict[str, torch.Tensor]]) -> np.ndarray:
    """(loss, score, valid) summed over a window of ``train_step``
    results and over the ranks, in float64 on the host: one stack, one
    all_reduce (across ranks) and one fetch for the whole window."""
    vals = torch.stack([torch.stack([m["loss"], m["score"], m["valid"]])
                        for m in window])
    multihost.all_reduce_sum(vals)
    return vals.double().sum(dim=0).cpu().numpy()


class MetricLogger:
    def __init__(self, log_interval: int = 40,
                 jsonl_path: Optional[str] = None, n_chips: int = 1,
                 batch_size: int = 0):
        self.log_interval = max(1, log_interval)
        self.n_chips = max(1, n_chips)
        self.batch_size = batch_size
        self._f = None
        if jsonl_path and multihost.is_primary():
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._f = open(jsonl_path, "a")
        self.reset_window()

    def reset_window(self):
        self._loss = 0.0
        self._score = 0.0
        self._count = 0
        self._examples = 0.0
        self._t0 = time.perf_counter()

    def log_window(self, *, epoch: int, step: int, loss_sum: float,
                   score_sum: float, n: int,
                   examples: Optional[float] = None,
                   lr: Optional[float] = None):
        """Record a window of n steps whose sums were fetched at once.
        examples: the valid sample count (defaults to n * batch_size)."""
        self._loss += loss_sum
        self._score += score_sum
        self._count += n
        self._examples += (examples if examples is not None
                           else n * self.batch_size)
        self._flush(epoch, step, lr)

    def _flush(self, epoch: int, step: int, lr: Optional[float] = None):
        dt = time.perf_counter() - self._t0
        steps_per_sec = self._count / max(dt, 1e-9)
        qa_per_sec = steps_per_sec * self.batch_size
        rec = {
            "epoch": epoch,
            "step": step,
            "loss": self._loss / self._count,
            "vqa_acc": 100.0 * self._score / max(1.0, self._examples),
            "steps_per_sec": steps_per_sec,
            "qa_pairs_per_sec_per_chip": qa_per_sec / self.n_chips,
        }
        if lr is not None:
            rec["lr"] = lr
        print("Epoch %02d(%05d), ave loss: %.7f, ave accuracy: %.2f%% "
              "[%.1f qa/s/chip]" % (
                  epoch + 1, step, rec["loss"], rec["vqa_acc"],
                  rec["qa_pairs_per_sec_per_chip"]), flush=True)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        self.reset_window()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
