"""The readers of the program's spans (``metrics/_spans.py``): the window
is the last ``units`` unprofiled records of the family's top-level span,
the warm-up before it and the profiled stretch after it left out; a
short ring, another family, a missing span or a program without the ring
read None; a traced CPU run of each cell reads every one of them, and
the spans fit inside the harness's own."""

import time

import pytest
import torch

from portbench import run as runner
from portbench.harness import cell as cellmod
from portbench.metrics import _spans
from test_portbench_trace import SEED, SMALL

MS = 1_000_000  # ns


def _step(t, profiled=False, root=0):
    """One step at t ms: a 1 ms wait, then a 10 ms train_step holding a
    2 ms forward; the worker's 3 ms assembly starts with it."""
    return [("loader.wait", None, root, 1, t * MS, (t + 1) * MS, profiled),
            ("train_step.forward", "train_step", root + 1, 1, (t + 2) * MS,
             (t + 4) * MS, profiled),
            ("train_step", None, root + 1, 1, (t + 1) * MS, (t + 11) * MS,
             profiled),
            ("loader.assemble", None, root + 2, 2, (t + 1) * MS,
             (t + 4) * MS, profiled)]


def _ring(warmup=3, window=4, profiled=2):
    ring, t = [], 0
    for i in range(warmup + window + profiled):
        ring += _step(t, profiled=i >= warmup + window, root=3 * i)
        t += 20 if i < warmup else 11 if i < warmup + window else 50
    return ring


REC = {"family": "train", "units": 4}


def test_the_window_is_the_last_unprofiled_units():
    ring = _ring()
    # warm-up steps at 0, 20, 40 (the last ends at 51); the window's at
    # 60, 71, 82, 93
    assert _spans.window(ring, "train_step", 4) == (51 * MS, 104 * MS)
    read = lambda name: _spans.ms_per_unit(REC, "train", name, ring)
    assert read("train_step.forward") == pytest.approx(2.0)
    assert read("train_step") == pytest.approx(10.0)
    assert read("loader.wait") == pytest.approx(1.0)
    assert read("loader.assemble") == pytest.approx(3.0)
    # with no warm-up the window opens at the first step's start: its
    # wait lies before
    ring = _ring(warmup=0)
    assert _spans.window(ring, "train_step", 4) == (1 * MS, 44 * MS)
    assert _spans.ms_per_unit(REC, "train", "loader.wait",
                              ring) == pytest.approx(3 * 1.0 / 4)


def test_the_profiled_stretch_and_the_warmup_stay_out():
    ring = _ring(warmup=0, window=4, profiled=0)
    alone = _spans.ms_per_unit(REC, "train", "train_step.forward", ring)
    more = _ring(warmup=5, window=4, profiled=7)
    assert _spans.ms_per_unit(REC, "train", "train_step.forward",
                              more) == pytest.approx(alone)


@pytest.mark.parametrize("case", ["short", "family", "span", "empty",
                                  "units"])
def test_none_where_there_is_nothing_to_read(case):
    ring, rec, name = _ring(), dict(REC), "train_step.forward"
    if case == "short":
        ring = _ring(warmup=0, window=3, profiled=5)
    elif case == "family":
        rec["family"] = "eval"
    elif case == "span":
        name = "train_step.optimizer"
    elif case == "empty":
        ring = []
    else:
        rec["units"] = 0
    assert _spans.ms_per_unit(rec, rec["family"], name, ring) is None


def test_a_program_without_the_ring_reads_none(monkeypatch):
    from vqa_project_tpu_torch.train import profiling
    monkeypatch.delattr(profiling, "recent_spans")
    assert _spans.ring() is None
    for name in ("train.forward_ms", "eval.emit_ms"):
        cell = "vqa2.train" if name.startswith("train") else "vqa2.eval"
        rec = {"family": name.split(".")[0], "units": 1}
        assert cellmod.load(cell).reader(name).read(rec) is None


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", ["vqa2.train", "vqa2.eval"])
def test_a_traced_run_reads_every_span_metric(name):
    cell = cellmod.load(name, overrides=SMALL)
    out = runner.run(cell, SEED, 1.0, True, "cpu", t0=time.perf_counter(),
                     log=lambda *a: None)
    assert out["correct"] is True, out["checks"]
    rec, got = out["records"], out["metrics"]
    spans = [m["name"] for m in cell.per_layer
             if m["source"] == "program_span"]
    assert len(spans) == (6 if name == "vqa2.train" else 5)
    for m in spans:
        assert got[m]["unit"] == "ms" and got[m]["value"] > 0, m
    v = {m: got[m]["value"] for m in spans}
    ring = _spans.ring()
    top = _spans.TOP[rec["family"]]
    w0, w1 = _spans.window(ring, top, rec["units"])
    count = lambda s: sum(1 for r in ring if r[0] == s and w0 <= r[4] < w1)
    if name == "vqa2.train":
        # one of each child a step
        for s in ("train_step.inputs", "train_step.forward",
                  "train_step.backward", "train_step.optimizer"):
            assert count(s) == rec["units"], s
        # the harness's spans, as train.issue_ms and train.data_wait_ms
        # read them (those readers want device time, which the CPU has not)
        harness = {k: 1e3 * t / rec["units"]
                   for k, t in rec["span_totals"].items()}
        parts = (v["train.inputs_ms"] + v["train.forward_ms"]
                 + v["train.backward_ms"] + v["train.optimizer_ms"])
        assert parts <= harness["train_step"]
        assert v["train.loader_wait_ms"] <= harness["data_wait"]
    else:
        for s in ("evaluate.assemble", "evaluate.epoch", "evaluate.fetch",
                  "evaluate.emit", "evaluate.write"):
            assert count(s) == rec["units"], s
        assert sum(v.values()) <= 1e3 * rec["elapsed_s"] / rec["units"]
