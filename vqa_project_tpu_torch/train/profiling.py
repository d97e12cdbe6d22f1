"""Tracing and step timing.

Counterpart of ``vqa_project_tpu/train/profiling.py`` with its four
names:

- ``trace(log_dir)``: ``torch.profiler`` around a region (the CPU, and
  the card's kernels when CUDA is up), written into ``log_dir`` as a
  Chrome trace that TensorBoard's profiler plugin and Perfetto read;
- ``annotate(name)``: a named region in that trace;
- ``force_sync(x)``: wait until ``x`` is computed;
- ``StepTimer``: wall-clock step times with a warm-up left out, and the
  JAX package's summary (steps, mean, p50, p95, QA pairs/s per card).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler.profile`` around the region; on exit its Chrome
    trace is written into ``log_dir`` (``<host>_<pid>.<ns>.pt.trace.json``).
    Yields the profiler, whose ``key_averages()`` can be read after."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region (a ``record_function`` span in the trace)."""
    return torch.profiler.record_function(name)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def force_sync(x) -> None:
    """Wait for ``x`` (a tensor, or the first tensor in a dict, list or
    tuple): ``torch.cuda.synchronize`` of its card, or for a CPU tensor a
    one-element read."""
    t = _first_tensor(x)
    if t is None:
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    else:
        t.detach().reshape(-1)[:1].tolist()


class StepTimer:
    """Accumulates per-step wall times (``with timer: ...``, one block a
    step, the first ``warmup`` left out); ``summary`` reports them.
    Ending each block in ``force_sync`` makes a step's time its
    completion, not its enqueue."""

    def __init__(self, warmup: int = 3, batch_size: int = 0,
                 n_chips: int = 1):
        self.warmup = warmup
        self.batch_size = batch_size
        self.n_chips = max(1, n_chips)
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        """{steps, mean_ms, p50_ms, p95_ms, and with a batch size
        qa_pairs_per_sec_per_chip}, or {} before the first timed step."""
        if not self._times:
            return {}
        t = np.asarray(self._times)
        out = {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
        }
        if self.batch_size:
            out["qa_pairs_per_sec_per_chip"] = float(
                self.batch_size / t.mean() / self.n_chips)
        return out
