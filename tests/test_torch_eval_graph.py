"""The resident eval epoch's forward as a CUDA graph (``train.steps``).

On the CPU (tier 1): ``eval_path``, the rule that picks eager, capture
or replay for a batch, as a function of what it observes; the eval graph
and the train step's graph of one model kept apart; ``eval_key``: the
same over two ``evaluate`` calls that each make a new image function,
another for another table, cache dtype, gather dtype, ``merged_block``,
batch shape or a moved parameter; a CPU ``eval_epoch`` that never
captures, counts ``eval.graphed`` 0 once a batch and equals the eager
loop written out; and the benchmark's reader ``eval.graph_share``.

On the card (marker ``cuda``; skipped without one; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_eval_graph.py``):
a graphed ``eval_epoch`` against an eager one, predictions and score bit
for bit, with their ``eval.graphed`` records and launch counts, for the
conditioned-graph model unmerged and merged and for MCAN; and across
calls with graphed train steps between them and after a
``load_state_dict`` in place, each call reading the new weights.
"""

import copy
import gc
import time
import weakref

import numpy as np
import pytest
import torch

from portbench.harness import cell as cellmod
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.data.feature_cache import (FeatureCache,
                                                      QuantizedFeatureCache)
from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.parallel.mesh import make_mesh
from vqa_project_tpu_torch.train import (build_model, loop,
                                         make_feature_cache, make_optimizer,
                                         train_step)
from vqa_project_tpu_torch.train import profiling, steps

BS, S_BATCHES, SEED = 8, 5, 20261018

# ---------------- the rule, on its own ----------------

# (cuda, hooked, seen, captured) -> path
RULE = [
    ((False, False, True, True), "eager"),     # off the card
    ((True, True, True, True), "eager"),       # a hook on the model
    ((True, True, True, False), "eager"),
    ((True, False, False, False), "eager"),    # a key's first batch
    ((True, False, False, True), "eager"),     # (an old graph)
    ((True, False, True, False), "capture"),   # its next
    ((True, False, True, True), "replay"),     # every later one
    ((False, True, False, False), "eager"),
]


@pytest.mark.parametrize("seen,want", RULE)
def test_eval_path(seen, want):
    assert steps.eval_path(*seen) == want


# ---------------- the key and the registry ----------------

GEN = dict(n_images=12, n_questions=240, n_obj=8, feat_dim=24, q_vocab=20,
           n_answers=8, seed=1000, max_qlen=10, emb_dim=16)
MODEL = dict(emb_dim=16, hid_dim=24, combined_dim=16, n_kernels=3,
             neighbourhood_size=4, dropout=0.1, max_qlen=10,
             compute_dtype="float32")


@pytest.fixture(scope="module")
def splits():
    return generate_synthetic_vqa(**GEN)


def _model(ds, **kw):
    return build_model(ModelConfig(**{**MODEL, **kw}), ds, device="cpu")


def _cache(ds, dtype="float32"):
    return make_feature_cache(ds, TrainConfig(batch_size=BS,
                                              feature_cache_dtype=dtype),
                              "float32", "cpu")


def _fields(b=BS, wi=20, wf=7):
    return {"ints": torch.zeros((b, wi), dtype=torch.int32),
            "floats": torch.zeros((b, wf), dtype=torch.float32)}


def test_eval_and_train_graphs_live_side_by_side(splits, monkeypatch):
    # every optimizer here is one that a train graph holds
    monkeypatch.setattr(steps, "adam_seen",
                        lambda opt: (True, True, False, False, True))
    model = _model(splits["val"])
    cache = _cache(splits["val"])
    fn = steps.make_image_fn(cache, "float32")
    opt, gen = object(), object()
    train, _ = steps._graph_entry(model, opt, gen, fn, _fields())
    key = steps.eval_key(model, fn, _fields())
    ev, seen = steps._eval_entry(model, key, cache)
    assert not seen and steps._eval_entry(model, key, cache) == (ev, True)
    assert steps._STEP_GRAPHS[model] is train
    # a new eval key takes the eval graph's place, not the train graph's
    other = steps.eval_key(model, fn, _fields(b=BS - 1))
    ev2, seen = steps._eval_entry(model, other, cache)
    assert not seen and ev2 is not ev
    assert steps._STEP_GRAPHS[model] is train
    assert steps._EVAL_GRAPHS[model] is ev2
    # and a new train key the train graph's, not the eval graph's
    train2, path = steps._graph_entry(model, object(), gen, fn, _fields())
    assert path == "eager" and train2 is not train
    assert steps._EVAL_GRAPHS[model] is ev2
    assert steps._eval_entry(model, other, cache) == (ev2, True)
    # both go with the model
    gone = weakref.ref(model)
    del model, train, train2, ev, ev2
    gc.collect()
    assert gone() is None


def test_two_evaluate_calls_give_one_key(splits, tmp_path, monkeypatch):
    ds = splits["val"]
    model, cache = _model(ds), _cache(ds)
    seen = []
    key_of = steps.eval_key

    def recorded(model_, image_fn, fields):
        key = key_of(model_, image_fn, fields)
        seen.append((image_fn, key))
        return key

    monkeypatch.setattr(steps, "eval_key", recorded)
    for _ in range(2):
        # a bare (features, boxes) pair, as the benchmark hands it in
        loop.evaluate(model, ds, BS, cache=tuple(cache), device="cpu",
                      result_path=str(tmp_path / "result.json"))
    (fn_a, key_a), (fn_b, key_b) = seen
    # each call makes its own image function and its own FeatureCache of
    # the same tensors; the key reads what the graph reads
    assert fn_a is not fn_b
    assert fn_a.feature_cache is not fn_b.feature_cache
    assert key_a == key_b
    # the table and the weights written in place keep their memory: the
    # same key
    with torch.no_grad():
        cache.features.mul_(1.0)
        for p in model.parameters():
            p.add_(0.0)
    loop.evaluate(model, ds, BS, cache=cache, device="cpu", result_path=None)
    assert seen[-1][1] == key_a


def _key_change(change, ds, model, cache):
    """(model, image_fn, fields) after ``change``."""
    fn = steps.make_image_fn(cache, "float32")
    fields = _fields()
    if change == "table":
        fn = steps.make_image_fn(FeatureCache(cache.features.clone(),
                                              cache.boxes), "float32")
    elif change == "cache dtype":
        fn = steps.make_image_fn(_cache(ds, "bfloat16"), "float32")
    elif change == "int8":
        fn = steps.make_image_fn(_cache(ds, "int8"), "float32")
        assert isinstance(fn.feature_cache, QuantizedFeatureCache)
    elif change == "gather dtype":
        fn = steps.make_image_fn(cache, "bfloat16")
    elif change == "merged_block":
        fn = steps.make_image_fn(cache, "float32", True)
    elif change == "batch shape":
        fields = _fields(b=BS * 2)
    elif change == "field width":
        fields = _fields(wi=21)
    elif change == "moved parameter":
        p = next(model.parameters())
        p.data = p.data.clone()
    elif change == "another model":
        model = _model(ds)
    return model, fn, fields


@pytest.mark.parametrize("change", [
    "none", "table", "cache dtype", "int8", "gather dtype", "merged_block",
    "batch shape", "field width", "moved parameter", "another model"])
def test_what_the_key_reads(splits, change):
    ds = splits["val"]
    model, cache = _model(ds), _cache(ds)
    base = steps.eval_key(model, steps.make_image_fn(cache, "float32"),
                          _fields())
    key = steps.eval_key(*_key_change(change, ds, model, cache))
    assert (key == base) is (change == "none")


def _epoch(ds, cache, model, n=S_BATCHES):
    image_fn, _, batcher = loop._feed(ds, cache, model.cfg,
                                      make_mesh(None, torch.device("cpu")),
                                      BS, shuffle=False)
    batches = [b for _, b in zip(range(n), batcher)]
    epoch, s = steps.stack_epoch_batches(batches, "cpu")
    assert s == n
    return epoch, image_fn


def _graphed(since):
    return [c[1] for c in profiling.recent_counts()
            if c[0] == "eval.graphed" and c[2] >= since]


def test_cpu_eval_epoch_is_eager_and_counts_each_batch(splits):
    ds = splits["val"]
    model, cache = _model(ds), _cache(ds)
    epoch, image_fn = _epoch(ds, cache, model)
    for _ in range(2):
        n0 = time.perf_counter_ns()
        total, preds = steps.eval_epoch(model, epoch, image_fn)
        assert _graphed(n0) == [0] * S_BATCHES
    assert model not in steps._EVAL_GRAPHS
    # the eager loop, written out
    want_total = torch.zeros((), dtype=torch.float32)
    for s in range(S_BATCHES):
        p, score, _ = steps._eval_forward(
            model, {"ints": epoch["ints"][s], "floats": epoch["floats"][s]},
            image_fn)
        assert torch.equal(preds[s], p)
        want_total += score
    assert torch.equal(total, want_total)


def test_the_graph_share_reader():
    reader = cellmod.load("vqa2.eval").reader("eval.graph_share")
    profiling.clear_spans()
    profiling.clear_counts()
    try:
        # a warm-up call (an eager batch and the capture), then two calls
        for values in ((0, 1), (1, 1, 1), (1, 1, 0)):
            with profiling.annotate("evaluate"):
                for v in values:
                    profiling.count("eval.graphed", v)
        rec = {"family": "eval", "units": 2}
        assert reader.read(rec) == pytest.approx(100.0 * 5 / 6)
        assert reader.read({**rec, "units": 3}) == pytest.approx(
            100.0 * 6 / 8)
        assert reader.read({**rec, "family": "train"}) is None
        assert reader.read({**rec, "units": 4}) is None
        profiling.clear_counts()
        assert reader.read(rec) is None
    finally:
        profiling.clear_spans()
        profiling.clear_counts()


# ---------------- on the card ----------------

CARD = dict(n_images=40, n_questions=480, n_obj=36, feat_dim=256,
            q_vocab=500, n_answers=256, seed=1000, max_qlen=8, emb_dim=64)
CARD_MODEL = {
    "graph": dict(hid_dim=256, combined_dim=128, n_kernels=8,
                  neighbourhood_size=16, dropout=0.5,
                  compute_dtype="bfloat16"),
    "mcan": dict(arch="mcan", hid_dim=64, dropout=0.1,
                 compute_dtype="bfloat16"),
}
CB = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_splits():
    return generate_synthetic_vqa(**CARD)


def _card_setup(dev, splits, arch="graph", merged=False, seed=SEED):
    kw = dict(CARD_MODEL[arch])
    if merged:
        kw["merged_block"] = True
    cfg = ModelConfig(**kw)
    ds = splits["val"]
    model = build_model(cfg, ds, device=dev, seed=seed)
    cache = make_feature_cache(ds, TrainConfig(batch_size=CB),
                               cfg.compute_dtype, dev, arch=cfg.arch)
    assert cache is not None
    mesh = make_mesh(None, dev)

    def epoch():
        """A resident epoch of S_BATCHES and a new image function, as
        each ``evaluate`` call makes them."""
        image_fn, _, batcher = loop._feed(ds, cache, model.cfg, mesh, CB,
                                          shuffle=False)
        batches = [b for _, b in zip(range(S_BATCHES), batcher)]
        return steps.stack_epoch_batches(batches, dev)[0], image_fn

    return model, cache, epoch


def _counts():
    return {f.__name__: f.launches for f in _build.COUNTED}


def _call(model, epoch_fn, *, eager=False):
    """(total, preds, eval.graphed records, launches by wrapper) of one
    ``eval_epoch`` call, eager (a forward hook on the model) or by the
    rule."""
    epoch, image_fn = epoch_fn()
    hook = (model.register_forward_hook(lambda *a: None) if eager
            else None)
    before = _counts()
    n0 = time.perf_counter_ns()
    try:
        total, preds = steps.eval_epoch(model, epoch, image_fn)
        torch.cuda.synchronize()
    finally:
        if hook is not None:
            hook.remove()
    after = _counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return total, preds, _graphed(n0), launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch,merged", [("graph", False), ("graph", True),
                                         ("mcan", False)])
def test_graphed_eval_epoch_equals_eager(card, card_splits, arch, merged):
    model, _, epoch = _card_setup(card, card_splits, arch, merged)
    want_total, want_preds, flags, want_launches = _call(model, epoch,
                                                         eager=True)
    assert flags == [0] * S_BATCHES and model not in steps._EVAL_GRAPHS
    assert want_launches, "the forward launches hand-written kernels"
    # the first call warms up, captures, replays; the second only replays
    for want_flags in ([0] + [1] * (S_BATCHES - 1), [1] * S_BATCHES):
        total, preds, flags, launches = _call(model, epoch)
        assert flags == want_flags
        assert torch.equal(total, want_total)
        assert torch.equal(preds, want_preds)
        # a replayed batch counts as the eager batch it replays
        assert launches == want_launches
        if want_flags[0] == 0:
            graph = steps._EVAL_GRAPHS[model].graph
    assert steps._EVAL_GRAPHS[model].graph is graph


@pytest.mark.cuda
def test_graphed_eval_reads_weights_updated_in_place(card, card_splits):
    model, cache, epoch = _card_setup(card, card_splits)
    train = card_splits["train"]
    optimizer, scheduler = make_optimizer(model, TrainConfig(lr=1e-3), 100)
    image_fn, _, batcher = loop._feed(train, cache, model.cfg,
                                      make_mesh(None, card), CB)
    batches = iter(batcher)
    gen = torch.Generator(device=card).manual_seed(SEED)

    def steps_(n):
        for _ in range(n):
            batch = {k: torch.from_numpy(v).to(card) for k, v in
                     steps.pack_index_batch(next(batches)).items()}
            train_step(model, optimizer, scheduler, batch, gen, image_fn)

    first = _call(model, epoch)
    eval_graph = steps._EVAL_GRAPHS[model].graph
    for n in (3, 2):
        # graphed train steps between two graphed eval calls, as fit's
        # mini-validation runs
        steps_(n)
        train_graph = steps._STEP_GRAPHS[model].graph
        got = _call(model, epoch)
        want = _call(model, epoch, eager=True)
        assert got[2] == [1] * S_BATCHES
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert steps._EVAL_GRAPHS[model].graph is eval_graph
        assert steps._STEP_GRAPHS[model].graph is train_graph
    assert train_graph is not None
    # another model's weights, loaded in place: the next replay reads them
    other = build_model(model.cfg, card_splits["val"], device=card,
                        seed=SEED + 1)
    state = copy.deepcopy(other.state_dict())
    model.load_state_dict(state)
    got = _call(model, epoch)
    want = _call(model, epoch, eager=True)
    assert got[2] == [1] * S_BATCHES
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[1], first[1])
    assert steps._EVAL_GRAPHS[model].graph is eval_graph
    assert np.isfinite(float(got[0]))
