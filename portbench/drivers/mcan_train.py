"""MCAN-large training from the device-resident region table, as
``train.fit`` runs it with ``ModelConfig.arch = "mcan"``: shuffled index
batches from ``Batcher``, prefetched to the card, the region gather of
``make_image_fn`` over a ``RegionCache`` (the features and each image's
region count), the Adam and schedule of ``make_optimizer``, dropout from
one generator on the card, one ``train_step`` a batch (replayed as one
CUDA graph from its third call) and a ``window_sums`` fetch every
``log_interval`` steps.

Set-up imports the model first (a program without MCAN fails here, at
once), draws the table and the weights, builds the training objects and
runs the warm-up (``harness/window.py``), whose first ``check_steps``
the reference (``reference/mcan.py``) follows. End to end:
``train_qa_per_s``, the QA pairs of the window's steps over its time. A
traced run also reads the product kernels' device time against their
least time (``counts/mcan.py``), and the loader's padded-row counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.counts import mcan as counts
from portbench.harness import checks
from portbench.harness.data import (dataset, question_table, shuffled_rows,
                                    torch_seed)
from portbench.harness.mcan import (make_weights, n_params, program_config,
                                    region_table)
from portbench.harness.setup import forever, no_tf32, sync
from portbench.harness.window import measure, peak_bytes, warm_up
from portbench.reference.mcan import MCANReference, run_steps
from portbench.reference.model import dense_labels

B1 = 0.9


def _tables(ctx):
    """(features on the card, region counts, question table)."""
    m, wl = ctx.cell.model, ctx.cell.workload
    split = ctx.cell.config["data"][wl["split"]]
    feats, regions = region_table(split["images"], m, ctx.seed, ctx.device)
    table = question_table(split["questions"], split["images"],
                           m["vocab_size"], m["answer_size"], m["max_token"],
                           wl["qlen_pmf"], ctx.seed)
    return feats, regions, table


def _reference(ctx, feats, table, precision):
    m, wl = ctx.cell.model, ctx.cell.workload
    b, dev = wl["batch_size"], ctx.device
    order = shuffled_rows(table.n_questions, torch_seed(ctx.seed, "shuffle"),
                          epoch=1)
    batches = []
    for i in range(wl["check_steps"]):
        rows = order[i * b:(i + 1) * b]
        img = torch.from_numpy(table.image_row[rows].astype(np.int64)).to(dev)
        batches.append({
            "question": torch.from_numpy(table.tokens[rows]).to(dev),
            "feats": feats[img].float(),
            "answers": dense_labels(
                torch.from_numpy(table.ans_idx[rows]).to(dev),
                torch.from_numpy(table.ans_score[rows]).to(dev),
                m["answer_size"] + 1)[:, :m["answer_size"]],
            "mask": torch.ones(len(rows), device=dev)})
    w0 = make_weights(m, ctx.seed, dev)
    with no_tf32():
        return run_steps(MCANReference(m, precision), w0, batches,
                         ctx.cell.config["train"]["lr"],
                         torch_seed(ctx.seed, "dropout"), dev)


def control(ctx):
    """The reference with fp8 operands in the program's place."""
    if ctx.control != "fp8":
        raise ValueError(f"a training cell's control is fp8, not {ctx.control}")
    feats, _, table = _tables(ctx)
    low = _reference(ctx, feats, table, "fp8")
    ref = _reference(ctx, feats, table, "float32")
    return {"e2e": {}, "attempted": len(ref[0]), "failed": 0,
            "numbers": checks.train_numbers(*low, *ref, ctx.log)}


def run(ctx):
    from vqa_project_tpu_torch.models.mcan import MCANModel
    from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
    from vqa_project_tpu_torch.data.loader import Batcher, prefetch_to_device
    from vqa_project_tpu_torch.train.metrics import window_sums
    from vqa_project_tpu_torch.train.state import make_optimizer
    from vqa_project_tpu_torch.train.steps import (RegionCache, make_image_fn,
                                                   train_step)
    if ctx.control:
        return control(ctx)
    c, m, wl, dev = ctx.cell, ctx.cell.model, ctx.cell.workload, ctx.device
    b = wl["batch_size"]
    feats, regions, table = _tables(ctx)
    ds = dataset(table, feats.shape[0], m["img_feat_pad_size"],
                 m["img_feat_size"] + 4, m["vocab_size"],
                 m["word_embed_size"])
    ctx.log(f"inputs ready at {time.perf_counter() - ctx.t0:.3f} s")
    model = MCANModel(ModelConfig(**program_config(m)), device=dev, seed=0)
    model.load_state_dict(make_weights(m, ctx.seed, dev))
    ctx.log(f"model ready at {time.perf_counter() - ctx.t0:.3f} s")
    tcfg = TrainConfig(lr=c.config["train"]["lr"], batch_size=b,
                       log_interval=wl["log_interval"],
                       prefetch=wl["prefetch"])
    loader = Batcher(ds, b, shuffle=True, drop_last=True, materialize=False,
                     seed=torch_seed(ctx.seed, "shuffle"),
                     region_counts=regions)
    optimizer, scheduler = make_optimizer(model, tcfg, len(loader))
    generator = torch.Generator(device=dev).manual_seed(
        torch_seed(ctx.seed, "dropout"))
    image_fn = make_image_fn(
        RegionCache(feats, torch.from_numpy(regions).to(dev)),
        m["compute_dtype"])
    prefetched = prefetch_to_device(forever(loader), dev, tcfg.prefetch)
    batches = (batch for _, batch in prefetched)

    if ctx.fault == "unchanged":
        optimizer.step = lambda *a, **k: None

    def step(batch):
        if ctx.fault == "halfbatch":
            batch["floats"][b // 2:, -1] = 0.0
        return train_step(model, optimizer, scheduler, batch, generator,
                          image_fn)

    logits_p, losses_p, mu1, after = warm_up(
        ctx, step, batches, window_sums, model, optimizer, model.proj)
    losses_p = [float(x) for x in losses_p]
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"set-up {setup_s:.3f} s")

    win = measure(ctx, step, batches, window_sums)
    prefetched.close()
    peak = peak_bytes(dev)

    grad_p = {n: v / (1.0 - B1) for n, v in mu1.items()}
    del model, optimizer, scheduler, generator, image_fn, batches, mu1
    del prefetched
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(ctx, feats, table, "float32")
    w0 = make_weights(m, ctx.seed, dev)
    change_p = {n: after[n] - w0[n] for n in after}
    numbers = checks.train_numbers(losses_p, grad_p, change_p, logits_p,
                                   *ref, ctx.log)

    records = None
    if win["traced"] is not None:
        live = counts.live_sums(table.qlen, regions[table.image_row], b)
        t_len = wl["trace_steps"]
        records = {**win["traced"], "family": "train", "traced_units": t_len,
                   "units": win["steps"], "elapsed_s": win["elapsed_s"],
                   "span_totals": win["span_totals"],
                   "least_s": t_len * counts.least_seconds(
                       counts.train_ops(m, b, live, n_params(m))),
                   "unit_flops": counts.model_flops(m, b, live),
                   "products_least_s": t_len * counts.products_least_seconds(
                       m, b, live)}
    rate = win["steps"] * b / win["elapsed_s"]
    return {"e2e": {"train_qa_per_s": rate, "setup_s": setup_s},
            "attempted": win["steps"], "failed": 0, "numbers": numbers,
            "memory_peak_bytes": peak, "records": records}
