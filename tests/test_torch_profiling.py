"""The port's ``train/profiling.py`` and ``async_save_checkpoint`` on
the CPU: StepTimer's summary equals the JAX package's on the same step
times, ``annotate``'s names appear in a ``trace``'s Chrome trace and in
its profiler's events, ``force_sync`` takes any tensor tree, and an
asynchronous save reads back equal to a synchronous one."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from vqa_project_tpu.train import profiling as j_profiling
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.models import GraphVQAModel
from vqa_project_tpu_torch.train import profiling
from vqa_project_tpu_torch.train.state import (async_save_checkpoint,
                                               load_checkpoint,
                                               make_optimizer,
                                               save_checkpoint,
                                               wait_for_async_saves)
from vqa_project_tpu_torch.train.steps import train_step

CFG = ModelConfig(vocab_size=20, emb_dim=16, feat_dim=20, hid_dim=24,
                  out_dim=9, combined_dim=16, n_kernels=3,
                  neighbourhood_size=4, n_obj=9, dropout=0.0, max_qlen=6,
                  compute_dtype="float32")


def _timed(timer_cls, times, monkeypatch, module, **kw):
    """A StepTimer of ``module`` fed ``times`` (seconds) as its steps."""
    clock = iter(np.cumsum([0.0] + [x for t in times for x in (t, 0.5)]))
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = timer_cls(**kw)
    for _ in times:
        with timer:
            pass
    return timer.summary()


@pytest.mark.parametrize("kw", [dict(warmup=3, batch_size=8),
                                dict(warmup=1, batch_size=8, n_chips=2),
                                dict(warmup=0), dict(warmup=9)],
                         ids=["warmup3", "chips2", "no_batch", "all_warmup"])
def test_step_timer_summary_equals_jax(kw, monkeypatch):
    times = list(np.random.default_rng(3).uniform(0.001, 0.02, size=9))
    mine = _timed(profiling.StepTimer, times, monkeypatch, profiling, **kw)
    theirs = _timed(j_profiling.StepTimer, times, monkeypatch, j_profiling,
                    **kw)
    assert mine == theirs
    if kw["warmup"] < len(times):
        assert set(mine) >= {"steps", "mean_ms", "p50_ms", "p95_ms"}
        assert mine["steps"] == len(times) - kw["warmup"]
        assert ("qa_pairs_per_sec_per_chip" in mine) == ("batch_size" in kw)
    else:
        assert mine == {}


def _step_inputs(rng, b=4):
    return {"question": rng.integers(1, CFG.vocab_size, (b, CFG.max_qlen)),
            "image": rng.uniform(size=(b, CFG.n_obj, CFG.feat_dim)
                                 ).astype(np.float32),
            "qlen": rng.integers(1, CFG.max_qlen + 1, b).astype(np.int32),
            "answers": (rng.uniform(size=(b, CFG.out_dim)) > 0.7
                        ).astype(np.float32),
            "votes": np.zeros((b, CFG.out_dim), np.float32),
            "mask": np.ones(b, np.float32)}


def test_trace_holds_the_annotated_names(tmp_path):
    model = GraphVQAModel(CFG, device="cpu", seed=0)
    optimizer, scheduler = make_optimizer(model, TrainConfig(), 10)
    rng = np.random.default_rng(0)
    with profiling.trace(str(tmp_path)) as prof:
        for i in range(2):
            with profiling.annotate(f"train_step_{i}"):
                out = train_step(model, optimizer, scheduler,
                                 _step_inputs(rng))
                profiling.force_sync(out)
    names = {e.key for e in prof.key_averages()}
    assert {"train_step_0", "train_step_1"} <= names
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    traced = {e.get("name") for e in events}
    assert {"train_step_0", "train_step_1"} <= traced


def test_force_sync_takes_trees():
    profiling.force_sync(torch.ones(3))
    profiling.force_sync({"loss": torch.zeros(()), "n": 3})
    profiling.force_sync([None, (torch.arange(4),)])
    profiling.force_sync({})


@pytest.mark.parametrize("mu", ["float32", "bfloat16"])
def test_async_save_reads_back_as_the_sync_save(tmp_path, mu):
    model = GraphVQAModel(CFG, device="cpu", seed=1)
    tcfg = TrainConfig(lr=1e-3, adam_mu_dtype=mu, adam_nu_dtype=mu)
    optimizer, scheduler = make_optimizer(model, tcfg, 4)
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(1)
    for _ in range(3):
        train_step(model, optimizer, scheduler, _step_inputs(rng))
    kw = dict(step=3, epoch=1, generator=gen, model_cfg=CFG, train_cfg=tcfg,
              extra={"accuracy": 12.5})
    sync, asyn = str(tmp_path / "sync.pt"), str(tmp_path / "async.pt")
    save_checkpoint(sync, model, optimizer, scheduler, **kw)
    async_save_checkpoint(asyn, model, optimizer, scheduler, **kw)
    # the training goes on at once; the save holds the state of its call
    train_step(model, optimizer, scheduler, _step_inputs(rng))
    wait_for_async_saves()
    _assert_same(torch.load(sync, weights_only=True),
                 torch.load(asyn, weights_only=True))
    # two saves to one path each write a temporary file of their own
    again = str(tmp_path / "again.pt")
    async_save_checkpoint(again, model, optimizer, scheduler, **kw)
    async_save_checkpoint(again, model, optimizer, scheduler, **kw)
    wait_for_async_saves()
    save_checkpoint(sync, model, optimizer, scheduler, **kw)
    _assert_same(torch.load(sync, weights_only=True),
                 torch.load(again, weights_only=True))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # the file loads as a port checkpoint with the configured dtypes
    fresh = GraphVQAModel(CFG, device="cpu", seed=9)
    opt2, sched2 = make_optimizer(fresh, tcfg, 4)
    payload = load_checkpoint(asyn, fresh, opt2, sched2)
    assert payload["step"] == 3 and payload["extra"] == {"accuracy": 12.5}
    for p in fresh.parameters():
        assert opt2.state[p]["exp_avg"].dtype == getattr(torch, mu)


def test_async_save_failure_is_raised(tmp_path):
    model = GraphVQAModel(CFG, device="cpu", seed=1)
    blocker = tmp_path / "file"
    blocker.write_text("")
    async_save_checkpoint(str(blocker / "sub" / "x.pt"), model)
    with pytest.raises(OSError):
        wait_for_async_saves()
    wait_for_async_saves()  # nothing left


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b
