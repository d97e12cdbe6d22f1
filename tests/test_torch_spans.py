"""The port's spans on the CPU: ``train.profiling.annotate`` keeps each
span in the process's ring (name, parent, root id, thread, clock, and
whether a profiler ran), enters the profiler only while one runs, and
places its spans, nested, in a ``trace``'s Chrome trace; ``train_step``,
``prefetch_to_device`` and ``evaluate`` open their spans at the layer
boundaries, once a step, a batch or a call."""

import glob
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.data.loader import Batcher, prefetch_to_device
from vqa_project_tpu_torch.train import (build_model, loop,
                                         make_feature_cache, make_optimizer,
                                         make_image_fn, train_step)
from vqa_project_tpu_torch.train import profiling

NAME, PARENT, ROOT, THREAD, T0, T1, PROFILED = range(7)
N_OBJ, FEAT, QLEN, BS = 8, 24, 10, 8
GEN = dict(n_images=12, n_questions=96, n_obj=N_OBJ, feat_dim=FEAT,
           q_vocab=20, n_answers=8, seed=1000, max_qlen=QLEN)
MODEL = dict(emb_dim=16, hid_dim=24, combined_dim=16, n_kernels=3,
             neighbourhood_size=4, dropout=0.1, max_qlen=QLEN,
             compute_dtype="float32")
TRAIN_CHILDREN = ("train_step.inputs", "train_step.forward",
                  "train_step.backward", "train_step.optimizer")
EVAL_CHILDREN = ("evaluate.assemble", "evaluate.epoch", "evaluate.fetch",
                 "evaluate.emit", "evaluate.write")


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def splits():
    return generate_synthetic_vqa(**GEN)


def _named(spans, prefix):
    return [s for s in spans if s[NAME].startswith(prefix)]


def _inside(child, parent):
    return parent[T0] <= child[T0] <= child[T1] <= parent[T1]


def test_nesting_parent_root_and_thread():
    def nest():
        with profiling.annotate("outer"):
            with profiling.annotate("mid"):
                with profiling.annotate("inner"):
                    pass
            with profiling.annotate("mid2"):
                pass

    nest()
    worker = threading.Thread(target=nest)
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    nest()
    spans = profiling.recent_spans()
    assert len(spans) == 12
    # a span closes after its children: the outermost ends each group
    groups = [spans[i:i + 4] for i in (0, 4, 8)]
    threads = [g[0][THREAD] for g in groups]
    assert threads[0] == threads[2] == threading.get_ident() != threads[1]
    roots = [g[0][ROOT] for g in groups]
    assert roots[0] < roots[1] < roots[2]
    for g in groups:
        inner, mid, mid2, outer = g
        assert [s[NAME] for s in g] == ["inner", "mid", "mid2", "outer"]
        assert [s[PARENT] for s in g] == ["mid", "outer", "outer", None]
        assert {s[ROOT] for s in g} == {outer[ROOT]}
        assert {s[THREAD] for s in g} == {outer[THREAD]}
        assert not any(s[PROFILED] for s in g)
        assert _inside(inner, mid) and _inside(mid, outer)
        assert _inside(mid2, outer) and mid[T1] <= mid2[T0]


def test_threads_lose_no_span_and_share_no_root():
    n_threads, steps = 2 * (os.cpu_count() or 4), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def steps_of_three():
            for _ in range(steps):
                with profiling.annotate("step"):
                    with profiling.annotate("step.a"):
                        pass
                    with profiling.annotate("step.b"):
                        pass

        workers = [threading.Thread(target=steps_of_three)
                   for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    spans = profiling.recent_spans()
    assert len(spans) == 3 * n_threads * steps
    tops = [s for s in spans if s[NAME] == "step"]
    assert len({s[ROOT] for s in tops}) == n_threads * steps
    by_root = {s[ROOT]: s for s in tops}
    for s in spans:
        top = by_root[s[ROOT]]
        assert s[THREAD] == top[THREAD] and _inside(s, top)
        assert s[PARENT] == (None if s is top else "step")


def test_a_span_is_recorded_when_its_block_raises():
    with pytest.raises(KeyError):
        with profiling.annotate("outer"):
            with profiling.annotate("failing"):
                raise KeyError("x")
    with profiling.annotate("after"):
        pass
    spans = profiling.recent_spans()
    assert [(s[NAME], s[PARENT]) for s in spans] == [
        ("failing", "outer"), ("outer", None), ("after", None)]


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    for _ in range(3):
        with profiling.annotate("step"):
            with profiling.annotate("step.part"):
                pass
    assert entered == []
    assert [s[NAME] for s in profiling.recent_spans()] == [
        "step.part", "step"] * 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("profiled"):
            pass
    assert entered == ["profiled"]
    assert profiling.recent_spans()[-1][PROFILED] is True


def test_the_profiler_flag_exists():
    # a rename in torch would silently keep every span out of the trace
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_spans_sit_nested_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(64).sum()
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by = {e["name"]: e for e in events
          if e.get("cat") == "user_annotation"
          and e.get("name") in ("outer", "inner")}
    assert set(by) == {"outer", "inner"}
    o, i = by["outer"], by["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    spans = profiling.recent_spans()
    assert [(s[NAME], s[PROFILED]) for s in spans] == [
        ("inner", True), ("outer", True)]


@pytest.mark.parametrize("mode", ["host", "cache"])
def test_train_step_makes_one_of_each_child(splits, mode):
    ds = splits["train"]
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    optimizer, scheduler = make_optimizer(model, TrainConfig(), 10)
    cache = (make_feature_cache(ds, TrainConfig(batch_size=BS), "float32",
                                "cpu") if mode == "cache" else None)
    image_fn = make_image_fn(cache, "float32")
    gen = torch.Generator().manual_seed(0)
    batcher = Batcher(ds, BS, shuffle=True, drop_last=True,
                      materialize=cache is None)
    steps = 3
    for _, batch in zip(range(steps), batcher):
        train_step(model, optimizer, scheduler, batch, gen, image_fn)
    spans = _named(profiling.recent_spans(), "train_step")
    tops = [s for s in spans if s[NAME] == "train_step"]
    assert len(tops) == steps
    for top in tops:
        assert top[PARENT] is None
        kids = [s for s in spans if s[ROOT] == top[ROOT] and s is not top]
        assert sorted(s[NAME] for s in kids) == sorted(TRAIN_CHILDREN)
        assert all(s[PARENT] == "train_step" and _inside(s, top)
                   for s in kids)
        kids.sort(key=lambda s: s[T0])
        assert tuple(s[NAME] for s in kids) == TRAIN_CHILDREN
        assert all(a[T1] <= b[T0] for a, b in zip(kids, kids[1:]))


def _eval_model(splits):
    ds = splits["val"]
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    cache = make_feature_cache(ds, TrainConfig(batch_size=BS), "float32",
                               "cpu")
    return ds, model, cache


def test_resident_evaluate_makes_its_six_spans(splits, tmp_path,
                                               monkeypatch):
    ds, model, cache = _eval_model(splits)
    emit, under = loop._emit, []

    def replaced(*args):
        with profiling.annotate("probe"):
            emit(*args)
        under.append(profiling.recent_spans()[-1][PARENT])

    monkeypatch.setattr(loop, "_emit", replaced)
    calls = 2
    for _ in range(calls):
        loop.evaluate(model, ds, BS, cache=cache, device="cpu",
                      result_path=str(tmp_path / "result.json"))
    n_batches = -(-ds.n_questions // BS)
    assert under == ["evaluate.emit"] * (n_batches * calls)
    spans = [s for s in profiling.recent_spans() if s[NAME] != "probe"]
    tops = [s for s in spans if s[NAME] == "evaluate"]
    assert len(tops) == calls
    for top in tops:
        kids = [s for s in spans if s[ROOT] == top[ROOT] and s is not top]
        kids.sort(key=lambda s: s[T0])
        assert tuple(s[NAME] for s in kids) == EVAL_CHILDREN
        assert all(s[PARENT] == "evaluate" and _inside(s, top)
                   for s in kids)


def test_streaming_evaluate_makes_only_its_call_and_write(splits,
                                                          tmp_path):
    ds, model, _ = _eval_model(splits)
    loop.evaluate(model, ds, BS, cache=None, device="cpu",
                  result_path=str(tmp_path / "result.json"))
    spans = _named(profiling.recent_spans(), "evaluate")
    assert sorted(s[NAME] for s in spans) == ["evaluate", "evaluate.write"]


def test_prefetch_records_waits_and_assembly_on_the_worker(splits):
    ds = splits["train"]
    batcher = Batcher(ds, BS, materialize=False)
    got = 0
    for _ in prefetch_to_device(iter(batcher), "cpu", depth=2):
        got += 1
        # every yielded batch came through at least one get
        assert len(_named(profiling.recent_spans(), "loader.wait")) >= got
    assert got == len(batcher)
    spans = profiling.recent_spans()
    waits = _named(spans, "loader.wait")
    assembled = _named(spans, "loader.assemble")
    main = threading.get_ident()
    assert all(s[THREAD] == main and s[PARENT] is None for s in waits)
    # one a batch, and a last that finds the iterator's end
    assert len(assembled) == got + 1
    assert all(s[THREAD] != main and s[PARENT] is None for s in assembled)
    assert len({s[ROOT] for s in assembled}) == len(assembled)


def test_the_ring_keeps_the_newest():
    cap = profiling._SPANS.maxlen
    assert cap == 1 << 17
    for i in range(cap + 5):
        with profiling.annotate("s"):
            pass
    spans = profiling.recent_spans()
    assert len(spans) == cap
    roots = [s[ROOT] for s in spans]
    assert roots == sorted(roots) and roots[-1] - roots[0] == cap - 1
    profiling.clear_spans()
    assert profiling.recent_spans() == []


def test_a_data_parallel_step_sums_its_gradients_in_its_own_span(splits):
    import torch.distributed as dist
    from vqa_project_tpu_torch.parallel.mesh import make_mesh
    from vqa_project_tpu_torch.parallel.multihost import free_port
    ds = splits["train"]
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    optimizer, scheduler = make_optimizer(model, TrainConfig(), 10)
    batch = next(iter(Batcher(ds, BS, materialize=True)))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, "cpu")
        train_step(model, optimizer, scheduler, batch,
                   torch.Generator().manual_seed(0), mesh=mesh,
                   n_valid=float(batch["mask"].sum()))
    finally:
        dist.destroy_process_group()
    spans = profiling.recent_spans()
    (red,) = _named(spans, "train_step.allreduce")
    (back,) = _named(spans, "train_step.backward")
    assert red[PARENT] == "train_step.backward" and _inside(red, back)
    assert red[ROOT] == back[ROOT]


def _profiled_ops(ds, model, optimizer, scheduler, region_counts=None):
    """The aten ops of making one index batch and stepping on it."""
    image_fn = make_image_fn(make_feature_cache(
        ds, TrainConfig(batch_size=BS), "float32", "cpu"), "float32")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        batch = next(iter(Batcher(ds, BS, materialize=False,
                                  region_counts=region_counts)))
        train_step(model, optimizer, scheduler, batch,
                   torch.Generator().manual_seed(0), image_fn)
    return sorted(e.name for e in prof.events() if e.name.startswith("aten::"))


def test_neither_the_allreduce_span_nor_the_row_count_adds_to_a_one_card_step(
        splits):
    """A one-card step opens no ``train_step.allreduce``, and region
    counts given to the Batcher (MCAN's padded-row count) add no op to
    making a batch and stepping on it: the count is host arithmetic."""
    ds = splits["train"]
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    optimizer, scheduler = make_optimizer(model, TrainConfig(), 10)
    # the first step makes Adam's state; the ring may hold counts of
    # MCAN runs earlier in this process
    _profiled_ops(ds, model, optimizer, scheduler)
    profiling.clear_counts()
    plain = _profiled_ops(ds, model, optimizer, scheduler)
    # each step records adam.graphed (0 off the card), and nothing else
    assert [n for n, _, _ in profiling.recent_counts()] == ["adam.graphed"]
    profiling.clear_counts()
    counted = _profiled_ops(ds, model, optimizer, scheduler, np.full(
        ds.store.features.shape[0], N_OBJ - 2, np.int32))
    made = profiling.recent_counts()
    profiling.clear_counts()
    assert counted == plain
    assert [n for n, _, _ in made] == ["batch.rows", "batch.padded_rows",
                                       "adam.graphed"]
    assert made[1][1] == made[0][1] - sum(
        int(x) for x in ds.table.qlen[:BS]) - BS * (N_OBJ - 2)
    assert not _named(profiling.recent_spans(), "train_step.allreduce")
