"""Training from the device-resident feature table, as ``train.fit``
runs it: shuffled index batches from ``Batcher``, prefetched to the card
(``prefetch_to_device``), the image gather of ``make_image_fn``, the
Adam and schedule of ``make_optimizer``, dropout from one generator on
the card, one ``train_step`` a batch and one fetch of ``window_sums``
every ``log_interval`` steps.

Set-up builds the one training object (model, optimizer, schedule,
generator, loader) and drives it through its first steps, which warm up
every shape; the first ``check_steps`` are those the reference follows.
The window then runs whole steps of the same object until ``--seconds``
have passed. End to end: ``train_qa_per_s``, the QA pairs of every step
of the window over the window's time, to the completion of its last
step. A traced run times the harness's spans in the window on the host
clock, and profiles ``trace_steps`` further steps after it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.counts import ops as counts
from portbench.harness import checks
from portbench.harness.data import dataset, shuffled_rows, torch_seed
from portbench.harness.setup import (forever, inputs, no_tf32, program_model,
                                     sync)
from portbench.harness.trace import Profile, Spans
from portbench.harness.weights import make_weights
from portbench.reference.model import Reference, dense_labels
from portbench.reference.train import run_steps

B1 = 0.9


def reference_batches(table, feats, boxes, rows_list, m, dev):
    """The reference's view of the checked steps: every field worked out
    from the question table and the feature table by row."""
    out = []
    for rows in rows_list:
        img = torch.from_numpy(table.image_row[rows].astype(np.int64)).to(dev)
        out.append({
            "question": torch.from_numpy(table.tokens[rows]).to(dev),
            "qlen": torch.from_numpy(table.qlen[rows]).to(dev),
            "feats": feats[img].float(), "boxes": boxes[img].float(),
            "answers": dense_labels(
                torch.from_numpy(table.ans_idx[rows]).to(dev),
                torch.from_numpy(table.ans_score[rows]).to(dev),
                m["out_dim"]),
            "mask": torch.ones(len(rows), device=dev)})
    return out


def _checked_rows(ctx, table):
    wl = ctx.cell.workload
    b, n = wl["batch_size"], wl["check_steps"]
    order = shuffled_rows(table.n_questions, torch_seed(ctx.seed, "shuffle"),
                          epoch=1)
    return [order[i * b:(i + 1) * b] for i in range(n)]


def _reference(ctx, table, feats, boxes, precision):
    m, wl = ctx.cell.model, ctx.cell.workload
    batches = reference_batches(table, feats, boxes,
                                _checked_rows(ctx, table), m, ctx.device)
    w0 = make_weights(m, ctx.seed, ctx.device)
    with no_tf32():
        return run_steps(Reference(m, precision), w0, batches,
                         ctx.cell.config["train"]["lr"], m["dropout"],
                         torch_seed(ctx.seed, "dropout"), ctx.device)


def control(ctx):
    """The reference with fp8 operands in the program's place."""
    if ctx.control != "fp8":
        raise ValueError(f"a training cell's control is fp8, not {ctx.control}")
    feats, boxes, table = inputs(ctx)
    low = _reference(ctx, table, feats, boxes, "fp8")
    ref = _reference(ctx, table, feats, boxes, "float32")
    return {"e2e": {}, "attempted": len(ref[0]), "failed": 0,
            "numbers": checks.train_numbers(*low, *ref, ctx.log)}


def run(ctx):
    if ctx.control:
        return control(ctx)
    from vqa_project_tpu_torch.data.loader import Batcher, prefetch_to_device
    from vqa_project_tpu_torch.config import TrainConfig
    from vqa_project_tpu_torch.train.metrics import window_sums
    from vqa_project_tpu_torch.train.state import make_optimizer
    from vqa_project_tpu_torch.train.steps import make_image_fn, train_step

    c, m, wl, dev = ctx.cell, ctx.cell.model, ctx.cell.workload, ctx.device
    b, log_every = wl["batch_size"], wl["log_interval"]
    feats, boxes, table = inputs(ctx)
    ds = dataset(table, feats.shape[0], m["n_obj"], m["feat_dim"],
                 m["vocab_size"], m["emb_dim"])
    ctx.log(f"inputs ready at {time.perf_counter() - ctx.t0:.3f} s")
    model = program_model(m, make_weights(m, ctx.seed, dev), dev)
    ctx.log(f"model ready at {time.perf_counter() - ctx.t0:.3f} s")
    tcfg = TrainConfig(lr=c.config["train"]["lr"], batch_size=b, log_interval=log_every,
                       prefetch=wl["prefetch"])
    loader = Batcher(ds, b, shuffle=True, drop_last=True, materialize=False,
                     seed=torch_seed(ctx.seed, "shuffle"))
    optimizer, scheduler = make_optimizer(model, tcfg, len(loader))
    generator = torch.Generator(device=dev).manual_seed(
        torch_seed(ctx.seed, "dropout"))
    image_fn = make_image_fn((feats, boxes), m["compute_dtype"])
    batches = prefetch_to_device(forever(loader), dev, tcfg.prefetch)
    names = {p: n for n, p in model.named_parameters()}

    if ctx.fault == "unchanged":
        optimizer.step = lambda *a, **k: None

    def step(batch):
        if ctx.fault == "halfbatch":
            batch["floats"][b // 2:, -1] = 0.0
        return train_step(model, optimizer, scheduler, batch, generator,
                          image_fn)

    # the first step's logits, as the model's last layer gives them
    first = []
    hook = model.out_2.register_forward_hook(
        lambda mod, args, out: first.append(out.detach().clone()))
    # set-up: the checked steps first, then the rest of the warm-up
    window, mu1 = [], {}
    for i in range(wl["warmup_steps"]):
        _, batch = next(batches)
        window.append(step(batch))
        if i == 0:
            hook.remove()
            mu1 = {names[p]: st["exp_avg"].detach().clone()
                   for p, st in optimizer.state.items() if "exp_avg" in st}
        if i + 1 == wl["check_steps"]:
            after = {n: p.detach().clone() for n, p in model.named_parameters()}
            losses_p = [float(o["loss"]) for o in window]
        if len(window) >= log_every:
            window_sums(window)
            window = []
    if window:
        window_sums(window)
        window = []
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"set-up {setup_s:.3f} s")

    # a traced run times its spans on the host clock in the window, and
    # profiles trace_steps more steps once the window has closed
    spans = Spans(ctx.trace)
    steps = 0
    t_start = time.perf_counter()
    chunks = [t_start]
    while True:
        with spans("data_wait"):
            _, batch = next(batches)
        with spans("train_step"):
            window.append(step(batch))
        steps += 1
        if len(window) >= log_every:
            with spans("fetch"):
                window_sums(window)
            window = []
            chunks.append(time.perf_counter())
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    if window:
        window_sums(window)
        window = []
    sync(dev)
    elapsed = time.perf_counter() - t_start
    rate = steps * b / elapsed
    ctx.log(f"window: {steps} steps of {b} in {elapsed:.4f} s; "
            f"{log_every}-step chunks (ms): "
            f"{np.round(np.diff(chunks) * 1e3, 1).tolist()}")
    traced = None
    if ctx.trace:
        span_totals = dict(spans.total)
        spans.record = True
        prof = Profile(dev, ctx.tmpdir)
        prof.start()
        for i in range(wl["trace_steps"]):
            with spans("data_wait"):
                _, batch = next(batches)
            with spans("train_step"):
                window.append(step(batch))
            if len(window) >= log_every:
                with spans("fetch"):
                    window_sums(window)
                window = []
        if window:
            window_sums(window)
        prof.stop()
        traced = prof.records()
    batches.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    grad_p = {n: v / (1.0 - B1) for n, v in mu1.items()}
    del model, optimizer, scheduler, generator, image_fn, batches, mu1
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(ctx, table, feats, boxes, "float32")
    w0 = make_weights(m, ctx.seed, dev)
    change_p = {n: after[n] - w0[n] for n in after}
    numbers = checks.train_numbers(losses_p, grad_p, change_p, first[0],
                                   *ref, ctx.log)

    records = None
    if traced is not None:
        qsum = float(table.qlen.mean()) * b
        t_len = wl["trace_steps"]
        records = {**traced, "family": "train", "traced_units": t_len,
                   "units": steps, "elapsed_s": elapsed,
                   "span_totals": span_totals,
                   "least_s": t_len * counts.least_seconds(
                       counts.train_ops(m, b, qsum)),
                   "unit_flops": counts.model_flops(m, b, qsum, True)}
    return {"e2e": {"train_qa_per_s": rate, "setup_s": setup_s},
            "attempted": steps, "failed": 0, "numbers": numbers,
            "memory_peak_bytes": peak, "records": records}
