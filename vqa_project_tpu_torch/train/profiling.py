"""Tracing and step timing.

Counterpart of ``vqa_project_tpu/train/profiling.py`` with its four
names:

- ``trace(log_dir)``: ``torch.profiler`` around a region (the CPU, and
  the card's kernels when CUDA is up), written into ``log_dir`` as a
  Chrome trace that TensorBoard's profiler plugin and Perfetto read;
- ``annotate(name)``: a named region, kept in the process's ring of
  spans (``recent_spans``, ``clear_spans``) whether or not a profiler
  runs, and a region in the profiler's trace while one runs;
- ``count(name, value)``: a host counter's record, kept in a ring of
  its own (``recent_counts``, ``clear_counts``);
- ``force_sync(x)``: wait until ``x`` is computed;
- ``StepTimer``: wall-clock step times with a warm-up left out, and the
  JAX package's summary (steps, mean, p50, p95, QA pairs/s per card).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# every span the process closed, oldest first: (name, parent name or None,
# root_id, thread id, t0_ns, t1_ns, profiled)
_SPANS: "collections.deque" = collections.deque(maxlen=1 << 17)
_ROOT_IDS = itertools.count()
# every counter record, oldest first: (name, value, t_ns)
_COUNTS: "collections.deque" = collections.deque(maxlen=1 << 17)
_THREAD = threading.local()


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


class annotate:
    """Named region: ``with annotate(name): ...``.

    On exit it appends ``(name, parent, root_id, thread_id, t0_ns, t1_ns,
    profiled)`` to the process's ring of spans (the last 131,072; read by
    ``recent_spans``), on ``time.perf_counter_ns``'s clock. ``parent`` is
    the name of the span open around it on its thread, or None;
    ``root_id`` numbers the outermost span of a thread, and the spans
    nested in it share it. Only while a profiler runs (at enter) is the
    region also a ``record_function`` in its trace, and ``profiled``
    True; otherwise it makes no dispatcher call. It never synchronizes
    nor touches a tensor."""

    __slots__ = ("name", "parent", "root", "t0", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_THREAD, "stack", None)
        if stack is None:
            stack = _THREAD.stack = []
        if stack:
            self.parent, self.root = stack[-1].name, stack[-1].root
        else:
            self.parent, self.root = None, next(_ROOT_IDS)
        stack.append(self)
        self.record = None
        if _autograd_profiler._is_profiler_enabled:
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.record is not None:
            self.record.__exit__(*exc)
        _THREAD.stack.pop()
        _SPANS.append((self.name, self.parent, self.root,
                       threading.get_ident(), self.t0, t1,
                       self.record is not None))
        return False


def recent_spans() -> List[Tuple]:
    """A copy of the ring of spans, oldest first (``annotate``)."""
    return list(_SPANS)


def clear_spans() -> None:
    """Empty the ring of spans."""
    _SPANS.clear()


def count(name: str, value: int) -> None:
    """Append ``(name, value, t_ns)`` to the ring of counts (the last
    131,072), on ``annotate``'s clock. Host arithmetic only: it never
    touches a tensor. The loader's ``Batcher`` counts ``batch.rows`` and
    ``batch.padded_rows``: the token and region rows of each batch it
    makes for MCAN, and those of them that are padding."""
    _COUNTS.append((name, int(value), time.perf_counter_ns()))


def recent_counts() -> List[Tuple]:
    """A copy of the ring of counts, oldest first (``count``)."""
    return list(_COUNTS)


def clear_counts() -> None:
    """Empty the ring of counts."""
    _COUNTS.clear()


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
