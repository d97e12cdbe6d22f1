"""The one-card train step as a CUDA graph (``train.steps``).

On the CPU (tier 1): ``step_path``, the rule that picks eager, capture or
replay, as a function of what it observes; the hooks it looks for; the
one key and graph a model keeps; the launch counters a replay adds; and
that a CPU ``train_step`` never captures, with its results and spans as
an eager step's.

On the CPU too: ``adam_path``, the rule that puts the port's Adam
inside the graph, and what it observes of an optimizer; the recapture
when a captured moment moves; one ``adam.graphed`` record a step.

On the card (marker ``cuda``; skipped without one; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py``):
six graphed steps against six eager ones from the same weights, batches
and dropout seeds, across an lr milestone with Adam inside the graph,
bit for bit, with a CUDA generator, with the default generator, under
the merged block and with bfloat16 moments; the capture with the
prefetching loader running; the calls that must leave the graph; a
checkpoint taken mid-run resumed bit for bit; and the fused Adam kernel
against the plain _foreach step bit for bit at VQA v2's and
MCAN-large's parameter lists and at unaligned shards, in every pair of
moment dtypes, and its refusal of a non-contiguous tensor.
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

import chip_smoke

from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data.loader import (pack_index_batch,
                                               prefetch_to_device)
from vqa_project_tpu_torch.models import GraphVQAModel
from vqa_project_tpu_torch import ops
from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.losses import multilabel_soft_margin_loss
from vqa_project_tpu_torch.parallel.mesh import Mesh
from vqa_project_tpu_torch.ops.adam import AdamTable, adam_fused_step
from vqa_project_tpu_torch.train import make_optimizer, train_step
from vqa_project_tpu_torch.train.state import (adam_step, load_checkpoint,
                                               save_checkpoint)
from vqa_project_tpu_torch.train import steps
from vqa_project_tpu_torch.train import profiling
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


# ---------------- Adam inside the graph: the rule ----------------

# (port_adam, own_step, step_hooks, sharded, on_card) -> path
ADAM_RULE = [
    ((True, True, False, False, True), "graph"),
    ((True, True, False, False, False), "eager"),   # parameters off the card
    ((True, False, False, False, True), "eager"),   # step replaced
    ((True, True, True, False, True), "eager"),     # a step hook
    ((True, True, False, True, True), "eager"),     # sharded (tensor parallel)
    ((False, False, False, False, True), "eager"),  # torch's Adam
]


@pytest.mark.parametrize("seen,want", ADAM_RULE)
def test_adam_path(seen, want):
    assert steps.adam_path(*seen) == want


def _adam_case(case):
    """An optimizer (and its schedule, kept alive) as ``case`` leaves it;
    its parameters on the CPU."""
    model = GraphVQAModel(_tiny(), device="cpu", seed=1)
    if case == "torch":
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        return opt, torch.optim.lr_scheduler.MultiStepLR(opt, [2])
    if case == "subclass":
        class Own(steps.Adam):
            def step(self, closure=None):
                return None
        opt = Own(model.parameters(), lr=LR)
        return opt, None
    opt, sched = make_optimizer(model, TrainConfig(lr=LR), 3)
    if case == "replaced":      # the harness's ``unchanged`` fault
        opt.step = lambda *a, **k: None
    elif case == "hook":
        opt.register_step_pre_hook(lambda *a: None)
    elif case == "sharded":     # what parallel.tp.shard_optimizer adds
        opt.shards = object()
    return opt, sched


# case -> (port_adam, own_step, step_hooks, sharded); on_card is False on
# the CPU
ADAM_CASES = {"port": (True, True, False, False),
              "replaced": (True, False, False, False),
              "hook": (True, True, True, False),
              "sharded": (True, True, False, True),
              "torch": (False, False, False, False),
              "subclass": (True, False, False, False)}


@pytest.mark.parametrize("case", ADAM_CASES)
def test_adam_seen(case):
    """The port's Adam under its MultiStepLR (which wraps its step on the
    instance) goes in where its parameters are on the card; a replaced
    step, a step hook, a sharded optimizer, torch's Adam and a subclass
    with a step of its own stay out."""
    opt, _ = _adam_case(case)
    seen = steps.adam_seen(opt)
    assert seen == (*ADAM_CASES[case], False)
    assert steps.adam_path(*seen[:4], True) == (
        "graph" if case == "port" else "eager")


@pytest.mark.parametrize("change", ["none", "replaced", "loaded", "moved",
                                    "rule"])
def test_a_moved_moment_recaptures(change):
    """A graph holding Adam recaptures where a captured moment is no
    longer its parameter's, or lies elsewhere, or the rule now leaves
    Adam out: ``adam_static`` is False and ``step_path`` says capture."""
    model = GraphVQAModel(_tiny(), device="cpu", seed=1)
    opt, _ = make_optimizer(model, TrainConfig(lr=LR), 3)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    params = list(model.parameters())
    entry = steps._StepGraph((), ())
    entry.adam_wanted = True
    entry.moments = [(p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"],
                      (opt.state[p]["exp_avg"].data_ptr(),
                       opt.state[p]["exp_avg_sq"].data_ptr()))
                     for p in params]
    adam = True
    if change == "replaced":
        opt.state[params[3]]["exp_avg"] = \
            opt.state[params[3]]["exp_avg"].clone()
    elif change == "loaded":    # a resume
        opt.load_state_dict(opt.state_dict())
    elif change == "moved":
        opt.state[params[1]]["exp_avg_sq"].set_(
            opt.state[params[1]]["exp_avg_sq"].clone())
    elif change == "rule":
        adam = False
    static = entry.adam_static(opt, adam)
    assert static is (change == "none")
    assert steps.step_path(True, True, False, True, True, static) == (
        "replay" if static else "capture")


def _graphed_counts(since):
    return [c[1] for c in profiling.recent_counts()
            if c[0] == "adam.graphed" and c[2] >= since]


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
        # one record of adam.graphed a step, 0 off the card
        assert _graphed_counts(n0) == [0]
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
    what its steps returned, read once every step has run. The schedule
    halves the lr after step 3 (a milestone at epoch 1 of 3 steps); both
    moments are stored in ``moments``."""

    def __init__(self, dev, cfg, generator, moments="float32"):
        self.model = GraphVQAModel(cfg, device=dev, seed=SEED)
        self.opt, self.sched = make_optimizer(self.model, TrainConfig(
            lr=LR, lr_milestones=(1,), adam_mu_dtype=moments,
            adam_nu_dtype=moments), 3)
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
            out[f"step.{names[p]}"] = st["step"]
        return out


def _counts():
    return {f.__name__: f.launches for f in _build.COUNTED}


def _run(dev, cfg, generator, batches, *, eager, prefetch=False,
         moments="float32"):
    if generator is None:
        torch.cuda.manual_seed(SEED + 1)
    run = Run(dev, cfg, generator, moments)
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
@pytest.mark.parametrize("generator,merged,prefetch,moments", [
    ("cuda", False, True, "float32"), (None, False, False, "float32"),
    ("cuda", True, False, "float32"), ("cuda", False, False, "bfloat16")])
def test_graphed_steps_equal_eager_steps(card, generator, merged, prefetch,
                                         moments):
    """Six steps across the lr milestone, Adam inside the graph from the
    capture on: the results, parameters, moments and counts of six eager
    steps."""
    cfg = ModelConfig(**CARD, merged_block=merged)
    batches = _index_batches(6)
    eager, eager_counts, eager_spans = _run(card, cfg, generator, batches,
                                            eager=True, moments=moments)
    n0 = time.perf_counter_ns()
    graphed, counts, spans = _run(card, cfg, generator, batches,
                                  eager=False, prefetch=prefetch,
                                  moments=moments)
    # the first call warms up, the second captures (its step's spans
    # inside), four replay; Adam is inside from the capture on
    assert eager_spans["train_step.graph"] == 0
    assert spans["train_step.forward"] == 2
    assert spans["train_step.capture"] == 1
    assert spans["train_step.graph"] == 5
    assert spans["train_step.optimizer"] == 6
    assert _graphed_counts(n0) == [0, 1, 1, 1, 1, 1]
    assert graphed.sched.get_last_lr() == [LR / 2]
    assert adam_step(graphed.opt) == adam_step(eager.opt) == 6
    # the capture counted the wrappers' calls of one eager step, and each
    # replay adds them
    entry = steps._STEP_GRAPHS[graphed.model]
    assert {f.__name__: n for f, n in entry.launches} == {
        k: v // 6 for k, v in eager_counts.items() if v}
    assert counts == eager_counts
    assert counts["adam_fused_step"] == 6
    gap = _compare(graphed.state(), eager.state())
    print(f"graphed vs eager ({generator} generator, merged {merged}, "
          f"prefetch {prefetch}, {moments} moments): {gap}")
    assert gap == "bitwise", gap


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
    # a resume's load_state_dict moves every moment: recapture
    run.opt.load_state_dict(run.opt.state_dict())
    assert _paths(run, full[:2], card) == ["capture", "replay"]
    # a step set on the instance leaves Adam out of the graph (it runs
    # after the replay), and back: a recapture each time
    wrapped = run.opt.step
    n0 = time.perf_counter_ns()
    run.opt.step = lambda *a, **k: None
    assert _paths(run, full[:2], card) == ["capture", "replay"]
    assert _graphed_counts(n0) == [0, 0]
    assert steps._STEP_GRAPHS[run.model].adam is None
    run.opt.step = wrapped
    n0 = time.perf_counter_ns()
    assert _paths(run, full[:2], card) == ["capture", "replay"]
    assert _graphed_counts(n0) == [1, 1]
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


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_a_checkpoint_mid_run_resumes_bit_for_bit(card, tmp_path, moments):
    """Three graphed steps (eager, capture, replay), a checkpoint, a
    fresh model, optimizer, schedule and generator loaded from it and
    three more: the parameters, moments and counts of six uninterrupted
    steps, bit for bit."""
    cfg = ModelConfig(**CARD)
    batches = [_on_card(b, card) for b in _index_batches(6)]
    whole = Run(card, cfg, "cuda", moments)
    for batch in batches:
        whole.step(batch)
    first = Run(card, cfg, "cuda", moments)
    for batch in batches[:3]:
        first.step(batch)
    path = str(tmp_path / "mid.ckpt")
    save_checkpoint(path, first.model, first.opt, first.sched, step=3,
                    generator=first.gen)
    assert adam_step(first.opt) == 3
    resumed = Run(card, cfg, "cuda", moments)
    load_checkpoint(path, resumed.model, resumed.opt, resumed.sched,
                    resumed.gen)
    for batch in batches[3:]:
        resumed.step(batch)
    want = {k: v for k, v in whole.state().items() if not k.startswith("out")}
    got = {k: v for k, v in resumed.state().items()
           if not k.startswith("out")}
    assert got.keys() == want.keys()
    assert _compare(got, want) == "bitwise"


# ---------------- the fused Adam kernel on the card ----------------

_SHAPES: dict = {}


def _adam_lists(which, mu, nu, dev):
    """chip_smoke's Adam lists: VQA v2's or MCAN-large's parameter shapes
    (made once), or unaligned shards."""
    if which != "shards" and which not in _SHAPES:
        cfg = ModelConfig(**(chip_smoke.FULL if which == "vqa2"
                             else chip_smoke.MCAN_LARGE))
        _SHAPES[which] = chip_smoke.param_shapes(cfg, dev)
    return chip_smoke.adam_lists(_SHAPES.get(which), getattr(torch, mu),
                                 getattr(torch, nu), dev, seed=SEED)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["vqa2", "mcan_large", "shards"])
@pytest.mark.parametrize("mu,nu", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_fused_adam_equals_the_foreach_step(card, which, mu, nu):
    """Five steps of adam_fused_step (one launch each) against five of
    the plain _foreach version on the card from the same tensors: the
    parameters and both moments bit for bit."""
    ps, gs, mus, nus = _adam_lists(which, mu, nu, card)
    table = AdamTable(ps, gs, mus, nus)
    table.upload()
    launches = adam_fused_step.launches
    # raises where a tensor's bits differ
    chip_smoke.check_adam(table, ps, gs, mus, nus, which, steps=5)
    assert adam_fused_step.launches - launches == 5


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["param", "grad", "mu", "nu"])
def test_fused_adam_refuses_a_non_contiguous_tensor(card, which):
    ps, gs, mus, nus = _adam_lists("shards", "float32", "float32", card)
    lists = {"param": ps, "grad": gs, "mu": mus, "nu": nus}
    x = lists[which]
    x[1] = torch.empty((x[1].numel(), 2), dtype=x[1].dtype,
                       device=card)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        AdamTable(ps, gs, mus, nus)
