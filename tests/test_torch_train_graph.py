"""The one-card train step as a CUDA graph (``train.steps``).

On the CPU (tier 1): ``step_path``, the rule that picks eager, capture or
replay, as a function of what it observes; the hooks it looks for; the
one key and graph a model keeps; the launch counters a replay adds; and
that a CPU ``train_step`` never captures, with its results and spans as
an eager step's.

On the card (marker ``cuda``; skipped without one; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py``):
six graphed steps against six eager ones from the same weights, batches
and dropout seeds, with a CUDA generator, with the default generator
and under the merged block; the capture with the prefetching loader
running; and the calls that must leave the graph.
"""

import collections
import gc
import importlib
import pkgutil
import socket
import time
import weakref

import numpy as np
import pytest
import torch

from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data.loader import (pack_index_batch,
                                               prefetch_to_device)
from vqa_project_tpu_torch.models import GraphVQAModel
from vqa_project_tpu_torch import ops
from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.losses import multilabel_soft_margin_loss
from vqa_project_tpu_torch.parallel.mesh import Mesh
from vqa_project_tpu_torch.train import make_optimizer, train_step
from vqa_project_tpu_torch.train import steps
from vqa_project_tpu_torch.train.profiling import recent_spans

B, T, S, K, N_IMAGES, SEED, LR = 16, 8, 6, 36, 40, 20261018, 1e-3

# ---------------- the rule, on its own ----------------

# (cuda, one_rank, hooked, seen, captured, grads_static) -> path
RULE = [
    ((False, True, False, True, True, True), "eager"),     # CPU
    ((True, False, False, True, True, True), "eager"),     # ranks
    ((True, True, True, True, True, True), "eager"),       # a hook
    ((True, True, False, False, False, False), "eager"),   # first call
    ((True, True, False, True, False, False), "capture"),  # second call
    ((True, True, False, True, True, True), "replay"),
    ((True, True, False, True, True, False), "capture"),   # grads moved
    ((False, False, True, False, False, False), "eager"),
]


@pytest.mark.parametrize("seen,want", RULE)
def test_step_path(seen, want):
    assert steps.step_path(*seen) == want


def _tiny(**kw):
    cfg = dict(vocab_size=50, emb_dim=16, feat_dim=12, hid_dim=16,
               out_dim=21, combined_dim=16, n_kernels=2,
               neighbourhood_size=4, n_obj=6, dropout=0.5, max_qlen=5,
               compute_dtype="float32")
    cfg.update(kw)
    return ModelConfig(**cfg)


def _hook_cases():
    def fwd(m):
        return m.out_1.register_forward_hook(lambda *a: None)

    def pre(m):
        return m.q_gru.register_forward_pre_hook(lambda *a: None)

    def bwd(m):
        return m.out_2.register_full_backward_hook(lambda *a: None)

    def param(m):
        return m.out_2.bias.register_hook(lambda g: g)

    def glob(m):
        return torch.nn.modules.module.register_module_forward_hook(
            lambda *a: None)
    return {"forward": fwd, "pre": pre, "backward": bwd, "param": param,
            "global": glob}


@pytest.mark.parametrize("case", ["none", *_hook_cases()])
def test_hooked(case):
    model = GraphVQAModel(_tiny(), device="cpu", seed=1)
    handle = None if case == "none" else _hook_cases()[case](model)
    try:
        assert steps._hooked(model) is (case != "none")
    finally:
        if handle is not None:
            handle.remove()
    assert not steps._hooked(model)


def _fields(b=4, width=7):
    return {"ints": torch.zeros((b, width), dtype=torch.int32),
            "floats": torch.zeros((b, 3), dtype=torch.float32)}


def test_a_model_keeps_one_graph_and_a_new_key_starts_over():
    model = GraphVQAModel(_tiny(), device="cpu", seed=1)
    opt, gen = object(), object()
    entry, path = steps._graph_entry(model, opt, gen, None, _fields())
    assert path == "eager"           # the first call warms up
    again, path = steps._graph_entry(model, opt, gen, None, _fields())
    assert again is entry and path == "capture"
    # another optimizer, generator, image_fn or shape is another key: it
    # takes the model's one place, and its first call warms up
    for other in ((object(), gen, None, _fields()),
                  (opt, object(), None, _fields()),
                  (opt, gen, len, _fields()),
                  (opt, gen, None, _fields(b=3))):
        new, path = steps._graph_entry(model, *other)
        assert path == "eager" and steps._STEP_GRAPHS[model] is new
        assert steps._graph_entry(model, *other) == (new, "capture")
    # so does the first key again
    assert steps._graph_entry(model, opt, gen, None, _fields())[1] == "eager"
    hook = model.out_1.register_forward_hook(lambda *a: None)
    assert steps._graph_entry(model, opt, gen, None, _fields())[1] == "eager"
    hook.remove()
    assert steps._graph_entry(model, opt, gen, None,
                              _fields())[1] == "capture"
    # graphs are kept per model, and go with it
    assert steps._graph_entry(GraphVQAModel(_tiny(), device="cpu", seed=1),
                              opt, gen, None, _fields())[1] == "eager"
    gone = weakref.ref(model)
    del model, entry, again, new
    gc.collect()
    assert gone() is None


@pytest.mark.parametrize("change", ["none", "grad_none", "grad_new",
                                    "storage"])
def test_grads_static(change):
    params = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    for p in params:
        p.grad = torch.zeros(3)
    entry = steps._StepGraph((), ())
    entry.params = [(p, p.grad, p.data_ptr()) for p in params]
    if change == "grad_none":
        params[1].grad = None
    elif change == "grad_new":
        params[0].grad = torch.zeros(3)
    elif change == "storage":
        params[1].data = torch.ones(3)
    assert entry.grads_static() is (change == "none")


def test_a_replay_adds_the_capture_launches():
    counters = _build.COUNTED
    names = {f.__name__ for f in counters}
    assert {"fused_sel_aggregate_act", "sel_aggregate_act_residuals",
            "sel_aggregate_act_vjp", "gru_scan", "gru_scan_bwd",
            "gru_wgrad", "gather_rows_packed", "gather_rows_blocked",
            "gather_image_rows", "graph_block_fwd", "graph_block_bwd",
            "tile_gemm", "wgmma_gemm"} <= names
    assert len(names) == len(counters)
    # every wrapper of the ops that counts its launches is in the registry
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{m.name}")
        for f in vars(mod).values():
            if callable(f) and hasattr(f, "launches"):
                assert any(f is c for c in counters), f
    a, b = counters[:2]
    a0, b0 = a.launches, b.launches
    entry = steps._StepGraph((), ())
    entry.launches = [(a, 2), (b, 1)]
    try:
        entry.count_launches()
        entry.count_launches()
        assert (a.launches - a0, b.launches - b0) == (4, 2)
    finally:
        a.launches, b.launches = a0, b0


def _host_batch(rng, cfg, b=B):
    return {"question": rng.integers(1, cfg.vocab_size,
                                     (b, cfg.max_qlen)).astype(np.int32),
            "image": rng.uniform(size=(b, cfg.n_obj, cfg.feat_dim)
                                 ).astype(np.float32),
            "qlen": rng.integers(1, cfg.max_qlen + 1, b).astype(np.int32),
            "answers": (rng.uniform(size=(b, cfg.out_dim))
                        * (rng.uniform(size=(b, cfg.out_dim)) < 0.2)
                        ).astype(np.float32),
            "votes": rng.integers(0, 4, (b, cfg.out_dim)).astype(np.float32),
            "mask": np.ones(b, np.float32)}


def _span_names(since):
    """The names of the spans opened since ``since`` (perf_counter_ns)."""
    return collections.Counter(s[0] for s in recent_spans() if s[4] >= since)


def _eager_step(model, opt, sched, batch, gen):
    """An eager step, written out: (loss, score, valid)."""
    question, image, qlen, mask, answers_fn, score_fn = \
        steps._assemble_inputs(steps.to_device(batch, torch.device("cpu")),
                               None, model.cfg.out_dim)
    logits, _, _ = model(question, image, qlen, train=True, generator=gen)
    loss = multilabel_soft_margin_loss(logits, answers_fn(), mask)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    sched.step()
    with torch.no_grad():
        return loss.detach(), score_fn(logits, mask), mask.sum()


def test_cpu_steps_never_capture_and_match_an_eager_step():
    cfg = _tiny()
    rng = np.random.default_rng(3)
    batches = [_host_batch(rng, cfg, 4) for _ in range(3)]
    model = GraphVQAModel(cfg, device="cpu", seed=2)
    twin = GraphVQAModel(cfg, device="cpu", seed=2)
    tcfg = TrainConfig(lr=LR)
    opt, sched = make_optimizer(model, tcfg, 10)
    opt2, sched2 = make_optimizer(twin, tcfg, 10)
    gen = torch.Generator().manual_seed(5)
    gen2 = torch.Generator().manual_seed(5)
    for batch in batches:
        n0 = time.perf_counter_ns()
        got = train_step(model, opt, sched, batch, gen)
        names = _span_names(n0)
        assert names == collections.Counter(
            ["train_step", "train_step.inputs", "train_step.forward",
             "train_step.backward", "train_step.optimizer"])
        want = _eager_step(twin, opt2, sched2, batch, gen2)
        for i, k in enumerate(("loss", "score", "valid")):
            assert torch.equal(got[k], want[i]), k
    assert model not in steps._STEP_GRAPHS
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n


# ---------------- on the card ----------------

CARD = dict(vocab_size=500, emb_dim=64, feat_dim=260, hid_dim=256,
            out_dim=257, combined_dim=128, n_kernels=8,
            neighbourhood_size=16, n_obj=K, dropout=0.5, max_qlen=T)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _index_batches(n, b=B, seed=SEED, cfg=None):
    cfg = cfg or ModelConfig(**CARD)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ans_idx = rng.integers(0, cfg.out_dim - 1, (b, S)).astype(np.int32)
        mask = np.ones(b, np.float32)
        mask[-1] = 0.0
        out.append({
            "question": rng.integers(1, cfg.vocab_size, (b, T)),
            "qlen": rng.integers(1, T + 1, b),
            "image_row": rng.integers(0, N_IMAGES, b),
            "ans_idx": ans_idx,
            "vote_idx": rng.integers(0, cfg.out_dim - 1, (b, S)),
            "ans_score": rng.uniform(size=(b, S)).astype(np.float32),
            "vote_val": rng.integers(0, 4, (b, S)).astype(np.float32),
            "mask": mask})
    return out


def _on_card(batch, dev):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in pack_index_batch(batch).items()}


def _table(dev, cfg):
    g = torch.Generator(device=dev).manual_seed(SEED)
    feats = torch.rand((N_IMAGES, K, cfg.feat_dim - 4), generator=g,
                       device=dev).to(torch.bfloat16)
    xy = torch.rand((N_IMAGES, K, 2), generator=g, device=dev) * 0.5
    wh = torch.rand((N_IMAGES, K, 2), generator=g, device=dev) * 0.5 + 0.01
    return feats, torch.cat([xy, xy + wh], dim=-1)


class Run:
    """One model, optimizer, schedule, generator and image gather, and
    what its steps returned, read once every step has run."""

    def __init__(self, dev, cfg, generator):
        self.model = GraphVQAModel(cfg, device=dev, seed=SEED)
        self.opt, self.sched = make_optimizer(self.model, TrainConfig(lr=LR),
                                              3)
        self.gen = (torch.Generator(device=dev).manual_seed(SEED + 1)
                    if generator == "cuda" else None)
        self.image_fn = steps.make_image_fn(_table(dev, cfg),
                                            cfg.compute_dtype,
                                            cfg.merged_block)
        self.results = []

    def step(self, batch):
        self.results.append(train_step(self.model, self.opt, self.sched,
                                       batch, self.gen, self.image_fn))

    def state(self):
        torch.cuda.synchronize()
        out = {f"out{i}.{k}": v for i, r in enumerate(self.results)
               for k, v in r.items()}
        out.update({n: p.detach() for n, p in self.model.named_parameters()})
        names = {p: n for n, p in self.model.named_parameters()}
        for p, st in self.opt.state.items():
            out[f"mu.{names[p]}"] = st["exp_avg"]
            out[f"nu.{names[p]}"] = st["exp_avg_sq"]
        return out


def _counts():
    return {f.__name__: f.launches for f in _build.COUNTED}


def _run(dev, cfg, generator, batches, *, eager, prefetch=False):
    if generator is None:
        torch.cuda.manual_seed(SEED + 1)
    run = Run(dev, cfg, generator)
    if eager:
        # a forward hook keeps every step on the eager path
        run.model.register_forward_hook(lambda *a: None)
    for f in _build.COUNTED:
        f.launches = 0
    n0 = time.perf_counter_ns()
    if prefetch:
        for _, batch in prefetch_to_device(iter(batches), dev, 2):
            run.step(batch)
    else:
        for batch in batches:
            run.step(_on_card(batch, dev))
    return run, _counts(), _span_names(n0)


def _compare(got, want):
    """"bitwise" where every tensor is equal, else the largest relative
    gap of a tensor's norm."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if not torch.equal(g, w):
            d = float((g.float() - w.float()).norm())
            worst = max(worst, d / max(float(w.float().norm()), 1e-30))
    return "bitwise" if worst == 0.0 else worst


@pytest.mark.cuda
@pytest.mark.parametrize("generator,merged,prefetch", [
    ("cuda", False, True), (None, False, False), ("cuda", True, False)])
def test_graphed_steps_equal_eager_steps(card, generator, merged, prefetch):
    cfg = ModelConfig(**CARD, merged_block=merged)
    batches = _index_batches(6)
    eager, eager_counts, eager_spans = _run(card, cfg, generator, batches,
                                            eager=True)
    graphed, counts, spans = _run(card, cfg, generator, batches,
                                  eager=False, prefetch=prefetch)
    # the first call warms up, the second captures (its step's spans
    # inside), four replay
    assert eager_spans["train_step.graph"] == 0
    assert spans["train_step.forward"] == 2
    assert spans["train_step.capture"] == 1
    assert spans["train_step.graph"] == 5
    # the capture counted the wrappers' calls of one eager step, and each
    # replay adds them
    entry = steps._STEP_GRAPHS[graphed.model]
    assert {f.__name__: n for f, n in entry.launches} == {
        k: v // 6 for k, v in eager_counts.items() if v}
    assert counts == eager_counts
    gap = _compare(graphed.state(), eager.state())
    print(f"graphed vs eager ({generator} generator, merged {merged}, "
          f"prefetch {prefetch}): {gap}")
    # cuBLAS may pick another algorithm on the capture stream: then 1e-5
    assert gap == "bitwise" or gap <= 1e-5, gap


def _paths(run, batches, dev):
    """The path of each call, as its spans show it; each loss is read
    as soon as its step has run."""
    out = []
    for batch in batches:
        n0 = time.perf_counter_ns()
        run.step(_on_card(batch, dev))
        run.read.append(float(run.results[-1]["loss"]))
        names = _span_names(n0)
        out.append("capture" if names["train_step.capture"]
                   else "replay" if names["train_step.graph"] else "eager")
    return out


@pytest.mark.cuda
def test_what_leaves_the_graph(card):
    cfg = ModelConfig(**CARD)
    run = Run(card, cfg, "cuda")
    run.read = []
    full, half = _index_batches(3), _index_batches(2, b=B // 2, seed=7)
    assert _paths(run, full, card) == ["eager", "capture", "replay"]
    # a new shape drops the graph, warms up, then captures; so does the
    # first shape again
    assert _paths(run, half, card) == ["eager", "capture"]
    assert _paths(run, full[:3], card) == ["eager", "capture", "replay"]
    # a forward hook runs eagerly; the graph then recaptures
    hook = run.model.out_1.register_forward_hook(lambda *a: None)
    assert _paths(run, full[:1], card) == ["eager"]
    hook.remove()
    assert _paths(run, full[:2], card) == ["capture", "replay"]
    # a gradient set to None elsewhere: recapture, not a silent skip
    run.opt.zero_grad(set_to_none=True)
    assert _paths(run, full[:2], card) == ["capture", "replay"]
    # inside a process group (one rank) every step is eager
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = Mesh(0, 1, card, "gloo")
        for batch in full[:2]:
            n0 = time.perf_counter_ns()
            train_step(run.model, run.opt, run.sched,
                       _on_card(batch, card),
                       run.gen, run.image_fn, mesh=mesh, n_valid=B - 1.0)
            names = _span_names(n0)
            assert names["train_step.forward"] == 1
            assert names["train_step.graph"] == 0
    finally:
        torch.distributed.destroy_process_group()
    # the graph's results are fresh tensors: later replays leave them
    assert [float(r["loss"]) for r in run.results[:len(run.read)]] \
        == run.read
