"""Nemotron-H training over region tokens from the device-resident
region table, as ``train.fit`` runs it with ``ModelConfig.arch =
"nemotron_h"``: shuffled index batches from ``Batcher``, prefetched to
the card, the region gather of ``make_image_fn`` over a ``RegionCache``
(the features and each image's region count), the Adam and schedule of
``make_optimizer``, one ``train_step`` a batch (replayed as one CUDA
graph, Adam inside, from its second call) and a ``window_sums`` fetch
every ``log_interval`` steps, which also records the MoE blocks' row
counts.

Set-up imports the model first (a program without Nemotron-H fails
here, at once), draws the table and the weights, builds the training
objects and runs the warm-up (``harness/window.py``), whose first
``check_steps`` the reference (``reference/nemotron_h.py``) follows; the
first step's router choices are read by a hook on each router (that
step runs eagerly). Before the reference runs, the checked batches'
features are gathered and the table is freed. End to end:
``train_qa_per_s``. Compared besides the training numbers:
``route_mismatch``. A traced run also reads the grouped expert kernel's
device time, and the library products' beside it, against their least
times (``counts/nemotron_h.py``), over the rows the program counted.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.counts import mcan as live_counts
from portbench.counts import nemotron_h as counts
from portbench.harness import checks
from portbench.harness.data import (dataset, question_table, shuffled_rows,
                                    torch_seed)
from portbench.harness.mcan import region_table
from portbench.harness.nemotron import (make_weights, n_params,
                                        program_config, spec)
from portbench.harness.setup import forever, no_tf32, sync
from portbench.harness.window import measure, peak_bytes
from portbench.reference.nemotron_h import (NemotronHReference,
                                            route_mismatch, run_steps)
from portbench.reference.model import dense_labels

B1 = 0.9
# sequences the reference runs at once: its scan keeps every position's
# state for the backward
ROWS_AT_ONCE = 8


def _tables(ctx, m):
    """(features on the card, region counts, question table)."""
    wl = ctx.cell.workload
    split = ctx.cell.config["data"][wl["split"]]
    feats, regions = region_table(split["images"], m, ctx.seed, ctx.device)
    table = question_table(split["questions"], split["images"],
                           m["vocab_size"], m["answer_size"], m["max_token"],
                           wl["qlen_pmf"], ctx.seed)
    return feats, regions, table


def _checked(ctx, m, feats, regions, table):
    """The reference's batches: the loader's first ``check_steps``
    batches by its shuffle rule, their features in float32."""
    wl, dev = ctx.cell.workload, ctx.device
    b = wl["batch_size"]
    order = shuffled_rows(table.n_questions, torch_seed(ctx.seed, "shuffle"),
                          epoch=1)
    batches = []
    for i in range(wl["check_steps"]):
        rows = order[i * b:(i + 1) * b]
        img = table.image_row[rows].astype(np.int64)
        batches.append({
            "question": torch.from_numpy(table.tokens[rows]).to(dev),
            "feats": feats[torch.from_numpy(img).to(dev)].float(),
            "counts": torch.from_numpy(regions[img].astype(np.int64)).to(dev),
            "answers": dense_labels(
                torch.from_numpy(table.ans_idx[rows]).to(dev),
                torch.from_numpy(table.ans_score[rows]).to(dev),
                m["answer_size"] + 1)[:, :m["answer_size"]],
            "mask": torch.ones(len(rows), device=dev)})
    return batches


def _reference(ctx, m, batches, precision):
    w0 = make_weights(m, ctx.seed, ctx.device)
    with no_tf32():
        return run_steps(NemotronHReference(m, precision), w0, batches,
                         ctx.cell.config["train"]["lr"],
                         ctx.cell.workload.get("rows_at_once", ROWS_AT_ONCE))


def _warm_up(ctx, step, batches, sums, model, optimizer, head):
    """``harness/window.py::warm_up``, with its copies of Adam's first
    moment and of the parameters kept on the host: on the card they
    would take the room of the step's graph."""
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
            mu1 = {names[p]: st["exp_avg"].detach().to("cpu", copy=True)
                   for p, st in optimizer.state.items() if "exp_avg" in st}
        if i < wl["check_steps"]:
            losses.append(window[-1]["loss"])
        if i + 1 == wl["check_steps"]:
            after = {n: p.detach().to("cpu", copy=True)
                     for n, p in model.named_parameters()}
        if len(window) >= wl["log_interval"]:
            sums(window)
            window = []
    if window:
        sums(window)
    return first[0], losses, mu1, after


def _lengths(batch):
    return batch["counts"] + (batch["question"] != 0).sum(-1)


def control(ctx):
    """The reference with fp8 operands in the program's place."""
    if ctx.control != "fp8":
        raise ValueError(
            f"a training cell's control is fp8, not {ctx.control}")
    m = spec(ctx.cell.config)
    feats, regions, table = _tables(ctx, m)
    batches = _checked(ctx, m, feats, regions, table)
    del feats
    low, low_routes = _reference(ctx, m, batches, "fp8")
    ref, routes = _reference(ctx, m, batches, "float32")
    numbers = checks.train_numbers(*low, *ref, ctx.log)
    n = _lengths(batches[0])
    length = m["img_feat_pad_size"] + m["max_token"]
    # the control's choices, left-padded as the program holds them
    padded = []
    for block in low_routes:
        t = torch.zeros((len(block), length, block[0].shape[1]),
                        dtype=torch.int64, device=ctx.device)
        for i, r in enumerate(block):
            t[i, length - r.shape[0]:] = r
        padded.append(t)
    numbers["route_mismatch"] = route_mismatch(padded, routes, n)
    return {"e2e": {}, "attempted": len(ref[0]), "failed": 0,
            "numbers": numbers}


def run(ctx):
    from vqa_project_tpu_torch.models.nemotron_h import NemotronHModel
    from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
    from vqa_project_tpu_torch.data.loader import Batcher, prefetch_to_device
    from vqa_project_tpu_torch.train import profiling
    from vqa_project_tpu_torch.train.metrics import window_sums
    from vqa_project_tpu_torch.train.state import make_optimizer
    from vqa_project_tpu_torch.train.steps import (RegionCache, make_image_fn,
                                                   train_step)
    if ctx.control:
        return control(ctx)
    c, wl, dev = ctx.cell, ctx.cell.workload, ctx.device
    m = spec(c.config)
    b = wl["batch_size"]
    feats, regions, table = _tables(ctx, m)
    ds = dataset(table, feats.shape[0], m["img_feat_pad_size"],
                 m["img_feat_size"] + 4, m["vocab_size"], m["hidden_size"])
    ctx.log(f"inputs ready at {time.perf_counter() - ctx.t0:.3f} s")
    with torch.device("meta"):
        model = NemotronHModel(ModelConfig(**program_config(m)),
                               device="meta")
    model = model.to_empty(device=dev)
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

    # the first step's router choices, one (B, P, k) a MoE block
    routes = []
    hooks = [layer.mixer.gate.register_forward_hook(
        lambda mod, args, out: routes.append(
            out[0].detach().view(b, -1, out[0].shape[-1]).clone()))
        for layer in model.backbone.layers if layer.kind == "E"]

    def step(batch):
        if ctx.fault == "halfbatch":
            batch["floats"][b // 2:, -1] = 0.0
        out = train_step(model, optimizer, scheduler, batch, generator,
                         image_fn)
        while hooks:
            hooks.pop().remove()
        return out

    logits_p, losses_p, mu1, after = _warm_up(
        ctx, step, batches, window_sums, model, optimizer, model.classifier)
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
    checked = _checked(ctx, m, feats, regions, table)
    del feats
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref, ref_routes = _reference(ctx, m, checked, "float32")
    w0 = make_weights(m, ctx.seed, dev)
    change_p = {n: after[n] - w0[n].cpu() for n in after}
    del w0
    numbers = checks.train_numbers(losses_p, grad_p, change_p, logits_p,
                                   *ref, ctx.log)
    numbers["route_mismatch"] = route_mismatch(routes, ref_routes,
                                               _lengths(checked[0]))

    records = None
    if win["traced"] is not None:
        live = live_counts.live_sums(table.qlen, regions[table.image_row], b)
        made = {"moe.routed_rows": 0, "moe.held_rows": 0}
        for name, value, _ in profiling.recent_counts():
            if name in made:
                made[name] += value
        # the held share of the live pairs the program routed, times the
        # live pairs of a batch, a block
        share = made["moe.held_rows"] / max(made["moe.routed_rows"], 1)
        held = (share * counts.seq_sums(live)["positions"]
                * m["num_experts_per_tok"])
        t_len = wl["trace_steps"]
        records = {**win["traced"], "family": "train", "traced_units": t_len,
                   "units": win["steps"], "elapsed_s": win["elapsed_s"],
                   "span_totals": win["span_totals"],
                   "least_s": t_len * counts.least_seconds(
                       counts.train_ops(m, b, live, held, n_params(m))),
                   "unit_flops": counts.model_flops(m, b, live, held),
                   "nemotron_products_least_s": t_len
                   * counts.library_least_seconds(m, b, live, held),
                   "held_experts": m["n_routed_experts"],
                   "expert_gemm_least_s": t_len * counts.n_moe(m)
                   * counts.least_seconds(counts.expert_ops(m, held))}
    rate = win["steps"] * b / win["elapsed_s"]
    return {"e2e": {"train_qa_per_s": rate, "setup_s": setup_s},
            "attempted": win["steps"], "failed": 0, "numbers": numbers,
            "memory_peak_bytes": peak, "records": records}
