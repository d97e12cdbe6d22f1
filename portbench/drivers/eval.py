"""Evaluation to ``result.json``, as ``cli.run --eval`` runs it:
``train.loop.evaluate`` on the resident path (the device table handed in
as its cache), ``questions_per_call`` questions a call in batches of
``batch_size``, the EvalAI result list written into TMPDIR.

Set-up makes the table and the model and warms the path with one short
call. The window runs whole calls until ``--seconds`` have passed. End
to end: ``eval_questions_per_s``, the questions of every call over the
time from the first call's start to the last call's end. A traced run
profiles one more call after the window. Every call's
answers are compared with the reference (and its accuracy with the
score of its own answers, on an earlier line). The control (``--control
fp8``) is the reference computed with fp8 operands in the program's
place.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench.counts import ops as counts
from portbench.harness import checks
from portbench.harness.data import dataset
from portbench.harness.setup import inputs, no_tf32, program_model, sync
from portbench.harness.trace import Profile
from portbench.harness.weights import make_weights
from portbench.reference.model import Reference, eval_logits

BLOCK = 512


def reference_logits(ctx, table, feats, boxes, rows, precision="float32"):
    """(N, out) eval logits of the reference over question ``rows``, the
    pad answer at -inf, in blocks."""
    m, dev = ctx.cell.model, ctx.device
    w = make_weights(m, ctx.seed, dev)
    ref = Reference(m, precision)
    out = []
    with no_tf32():
        for i in range(0, len(rows), BLOCK):
            r = rows[i:i + BLOCK]
            img = torch.from_numpy(table.image_row[r].astype(np.int64)).to(dev)
            out.append(eval_logits(
                ref, w, torch.from_numpy(table.tokens[r]).to(dev),
                torch.from_numpy(table.qlen[r]).to(dev),
                feats[img].float(), boxes[img].float()))
    return torch.cat(out)


def score_of(table, rows, ids: np.ndarray) -> float:
    """The summed VQA score min(votes / 3, 1) of answers ``ids``."""
    hit = table.vote_idx[rows] == ids[:, None]
    votes = (hit * table.vote_val[rows]).sum(axis=1)
    return float(np.minimum(votes / 3.0, 1.0).sum())


def run(ctx):
    c, m, wl, dev = ctx.cell, ctx.cell.model, ctx.cell.workload, ctx.device
    b, n = wl["batch_size"], wl["questions_per_call"]
    feats, boxes, table = inputs(ctx)
    rows = np.arange(n)
    if ctx.control == "fp8":
        ref = reference_logits(ctx, table, feats, boxes, rows)
        low = reference_logits(ctx, table, feats, boxes, rows, "fp8")
        ids = low.argmax(1)[:, None]
        ctx.log(f"widest answer gap {checks.rank_gap(ref, ids)!r}")
        return {"e2e": {}, "attempted": n, "failed": 0, "numbers": {
            "answer_gap_rms": checks.rank_gap_rms(ref, ids)}}
    from vqa_project_tpu_torch.train import loop
    ds = dataset(table, feats.shape[0], m["n_obj"], m["feat_dim"],
                 m["vocab_size"], m["emb_dim"])
    ctx.log(f"inputs ready at {time.perf_counter() - ctx.t0:.3f} s")
    model = program_model(m, make_weights(m, ctx.seed, dev), dev)
    ctx.log(f"model ready at {time.perf_counter() - ctx.t0:.3f} s")
    if ctx.fault == "answer":
        emit = loop._emit

        def altered(ds_, host, preds, result):
            preds = np.array(preds)
            preds[0] = (preds[0] + 1) % (m["out_dim"] - 1)
            emit(ds_, host, preds, result)
        loop._emit = altered
    path = os.path.join(ctx.tmpdir, "result.json")

    def call(batches):
        return loop.evaluate(model, ds, b, result_path=path,
                             max_batches=batches, cache=(feats, boxes),
                             device=dev)

    call(wl["warmup_batches"])
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"set-up {setup_s:.3f} s")

    calls, traced = [], None
    t_start = time.perf_counter()
    marks = [t_start]
    while True:
        acc, result, _ = call(n // b)
        calls.append((acc, result))
        marks.append(time.perf_counter())
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t_start
    window_calls = len(calls)
    ctx.log(f"window: {window_calls} calls of {n} questions in {elapsed:.4f} s;"
            f" calls (ms): {np.round(np.diff(marks) * 1e3, 1).tolist()}")
    if ctx.trace:
        # one more call, profiled once the window has closed
        prof = Profile(dev, ctx.tmpdir)
        prof.start()
        acc, result, _ = call(n // b)
        calls.append((acc, result))
        prof.stop()
        traced = prof.records()
    if ctx.fault == "answer":
        loop._emit = emit
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_logits(ctx, table, feats, boxes, rows)
    qid = table.qid[rows]
    a_wtoi = ds.a_wtoi
    gap_rms, widest, score_gap, missing = 0.0, 0.0, 0.0, 0
    for acc, result in calls:
        got = {r["question_id"]: a_wtoi.get(r["answer"], -1) for r in result}
        missing += sum(1 for q in qid if q not in got)
        ids = np.array([got.get(int(q), -1) for q in qid], np.int64)
        ids_d = torch.from_numpy(ids).to(dev)[:, None]
        gap_rms = max(gap_rms, checks.rank_gap_rms(ref, ids_d))
        widest = max(widest, checks.rank_gap(ref, ids_d))
        score_gap = max(score_gap, abs(acc / 100.0 * n
                                       - score_of(table, rows, ids)))
    ctx.log(f"widest answer gap {widest!r}; accuracy against the score of "
            f"the answers, largest gap {score_gap!r} questions")
    records = None
    if traced is not None:
        qsum = float(table.qlen[rows].mean()) * b
        batches = n // b
        records = {**traced, "family": "eval", "traced_units": 1,
                   "units": window_calls, "elapsed_s": elapsed,
                   "least_s": batches * counts.least_seconds(
                       counts.forward_ops(m, b, qsum)),
                   "unit_flops": batches * counts.model_flops(
                       m, b, qsum, False)}
    return {"e2e": {"eval_questions_per_s": window_calls * n / elapsed,
                    "setup_s": setup_s},
            "attempted": len(calls) * n, "failed": missing,
            "numbers": {"answer_gap_rms": gap_rms},
            "memory_peak_bytes": peak, "records": records}
