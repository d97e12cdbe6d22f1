"""The set-up steps, the measured window and the traced stretch of a
training cell, as ``drivers/train.py`` runs them, for ``mcan_train``.

``step(batch)`` runs one ``train_step`` and returns its result;
``batches`` yields device batches; ``sums(window)`` is the
``window_sums`` fetch made every ``log_interval`` steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness.setup import sync
from portbench.harness.trace import Profile, Spans


def warm_up(ctx, step, batches, sums, model, optimizer, head):
    """The workload's ``warmup_steps``, of which the first
    ``check_steps`` are those the reference follows. Returns (the first
    step's output of the module ``head``, the checked steps' losses as
    0-d tensors, Adam's first moment after the first step by parameter
    name, the parameters after the checked steps)."""
    wl = ctx.cell.workload
    names = {p: n for n, p in model.named_parameters()}
    first = []
    hook = head.register_forward_hook(
        lambda mod, args, out: first.append(out.detach().clone()))
    window, losses, mu1, after = [], [], {}, None
    for i in range(wl["warmup_steps"]):
        window.append(step(next(batches)))
        if i == 0:
            hook.remove()
            mu1 = {names[p]: st["exp_avg"].detach().clone()
                   for p, st in optimizer.state.items() if "exp_avg" in st}
        if i < wl["check_steps"]:
            losses.append(window[-1]["loss"])
        if i + 1 == wl["check_steps"]:
            after = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
        if len(window) >= wl["log_interval"]:
            sums(window)
            window = []
    if window:
        sums(window)
    return first[0], losses, mu1, after


def measure(ctx, step, batches, sums) -> dict:
    """The window: whole steps until ``ctx.seconds`` have passed, to the
    completion of the last; a traced run times the harness's spans on
    the host clock there, then profiles ``trace_steps`` more steps.
    Returns steps, elapsed_s, span_totals and the profiled stretch's
    records (None untraced)."""
    wl = ctx.cell.workload
    log_every = wl["log_interval"]
    spans = Spans(ctx.trace)
    window, steps = [], 0
    t_start = time.perf_counter()
    chunks = [t_start]
    while True:
        with spans("data_wait"):
            batch = next(batches)
        with spans("train_step"):
            window.append(step(batch))
        steps += 1
        if len(window) >= log_every:
            with spans("fetch"):
                sums(window)
            window = []
            chunks.append(time.perf_counter())
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    if window:
        sums(window)
        window = []
    sync(ctx.device)
    elapsed = time.perf_counter() - t_start
    ctx.log(f"window: {steps} steps in {elapsed:.4f} s; {log_every}-step "
            f"chunks (ms): {np.round(np.diff(chunks) * 1e3, 1).tolist()}")
    out = {"steps": steps, "elapsed_s": elapsed,
           "span_totals": dict(spans.total), "traced": None}
    if not ctx.trace:
        return out
    spans.record = True
    prof = Profile(ctx.device, ctx.tmpdir)
    prof.start()
    for _ in range(wl["trace_steps"]):
        with spans("data_wait"):
            batch = next(batches)
        with spans("train_step"):
            window.append(step(batch))
        if len(window) >= log_every:
            with spans("fetch"):
                sums(window)
            window = []
    if window:
        sums(window)
    prof.stop()
    out["traced"] = prof.records()
    return out


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
