"""Train and eval steps, in host mode and with a device feature cache.

Counterpart of ``vqa_project_tpu/train/steps.py``. Ingest modes:

- device-cache mode: the model's feature table lives on the device (one
  of the formats of ``data.feature_cache``); a batch carries token ids,
  lengths, image rows and SPARSE answer/vote entries
  (``data.loader.pack_index_batch``), and the step gathers its images
  in one launch (``make_image_fn``: the cache's ``gather_fn``) and
  densifies its labels on the device;
- host mode: the batch carries dense images, answers and votes.

One training step is forward, the model's masked loss (``model.loss``),
backward, Adam and the score;
``eval_epoch`` runs a whole resident eval epoch with no fetch inside its
loop, on the card as one CUDA graph of the eval forward replayed for
every batch once the model has seen a batch of its key (``eval_path``,
a rule of its own, and a graph apart from the train step's).

On one card, ``train_step`` with the port's own Adam replays its device
work (the inputs' unpack and image gather, the forward, the loss, the
backward, Adam's launch and the score) as one CUDA graph once it has
seen a batch of the same shapes: the first such call runs eagerly and
warms up, the second captures, every later one runs Adam's host part
(the counts, lr and the bias corrections) and the schedule, copies its
batch into the graph's inputs and replays. Any call that the graph
cannot hold runs wholly eagerly (``step_path``, the one rule).

Across data-parallel ranks (``parallel.Mesh``; the data axis of a
(data, model) grid under tensor parallelism) each rank steps on its
rows of the global batch: its loss is its masked sum over the GLOBAL
valid count, and the gradients are summed over the ranks before Adam
(``parallel.all_reduce_grads``, one flat buffer, f32 or bf16), so every
rank applies the global masked mean's gradient: JAX's rule
(``train/steps.py::_build_bf16_reduce_step``), which DDP's average of
per-rank means is not wherever the ranks' valid counts differ.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vqa_project_tpu_torch.config import device_guard
# QuantizedFeatureCache and RegionCache are imported from here as well
from vqa_project_tpu_torch.data.feature_cache import (  # noqa: F401
    QuantizedFeatureCache, RegionCache, as_feature_cache)
from vqa_project_tpu_torch.data.loader import DENSE_KEYS, pack_index_batch
from vqa_project_tpu_torch.ops._build import COUNTED
from vqa_project_tpu_torch.ops.losses import vqa_score
from vqa_project_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from vqa_project_tpu_torch.train.profiling import annotate, count
from vqa_project_tpu_torch.train.state import Adam


def densify_labels(idx: torch.Tensor, val: torch.Tensor,
                   n_classes: int) -> torch.Tensor:
    """Scatter sparse (B, S) index/value label entries into dense (B, C)
    float32. Pad entries point at column n_classes-1, which is cleared
    afterwards (the unused '+1' answer slot)."""
    dense = torch.zeros((idx.shape[0], n_classes), dtype=torch.float32,
                        device=idx.device)
    dense.scatter_(1, idx.long(), val.float())
    dense[:, n_classes - 1] = 0.0
    return dense


def sparse_vqa_score(logits: torch.Tensor, vote_idx: torch.Tensor,
                     vote_val: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Official VQA score from sparse vote entries, min(votes[pred]/3, 1)
    summed over the batch, without the dense (B, C) votes."""
    pred = torch.argmax(logits, dim=-1)
    hit = (vote_idx.long() == pred[:, None]).float()
    picked = (hit * vote_val.float()).sum(dim=-1)
    score = torch.clamp(picked / 3.0, max=1.0)
    if mask is not None:
        score = torch.where(mask > 0, score, torch.zeros_like(score))
    return score.sum()


def make_image_fn(feature_cache, compute_dtype: str,
                  merged_block: bool = False) -> Optional[Callable]:
    """``rows (B,) int32 -> the model's image`` for a device feature
    cache, or None in host mode (no cache): the cache's ``gather_fn``
    (``data.feature_cache``; a bare (features, boxes) pair is a
    ``FeatureCache``), one launch a call. A ``FeatureCache`` or an int8
    ``QuantizedFeatureCache`` gives a ``NodeImage``, the node rows
    feat||bbox in ``compute_dtype`` (padded for the merged block when
    ``merged_block``) and the f32 boxes; a ``RegionCache`` (MCAN) a
    ``RegionImage``. The function carries its cache as
    ``.feature_cache``, which ``train_step``'s bf16 refusal reads, and
    its two arguments as ``.gather``; ``eval_key`` reads both."""
    cache = as_feature_cache(feature_cache)
    if cache is None:
        return None
    image_fn = cache.gather_fn(compute_dtype, merged_block)
    image_fn.feature_cache = cache
    image_fn.gather = (str(compute_dtype), bool(merged_block))
    return image_fn


def supports_bf16_reduce(feature_cache, mesh: Optional[Mesh] = None
                         ) -> Tuple[bool, Optional[str]]:
    """(ok, why): the bf16 gradient all-reduce takes the 1-D data mesh
    (tp = 1) and a cache whose ``bf16_reduce`` allows it (every
    replicated one) or host mode; ``why`` names what it refuses. One
    rule for ``train_step``'s refusal and ``fit``'s degrade to float32
    (JAX's ``supports_bf16_reduce``)."""
    if mesh is not None and mesh.tp > 1:
        return False, "a model-parallel mesh"
    cache = as_feature_cache(feature_cache)
    if cache is not None and not cache.bf16_reduce:
        return False, f"a {type(cache).__name__} feature cache"
    return True, None


def unpack_index_batch(batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of ``data.loader.pack_index_batch``, on the device; every
    field contiguous."""
    ints, floats = batch["ints"], batch["floats"]
    s = (floats.shape[1] - 1) // 2
    t = ints.shape[1] - 2 - 2 * s
    fields = {
        "question": ints[:, :t],
        "qlen": ints[:, t],
        "image_row": ints[:, t + 1],
        "ans_idx": ints[:, t + 2:t + 2 + s],
        "vote_idx": ints[:, t + 2 + s:],
        "ans_score": floats[:, :s],
        "vote_val": floats[:, s:2 * s],
        "mask": floats[:, 2 * s],
    }
    return {k: v.contiguous() for k, v in fields.items()}


def _fields(batch: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """The fields a step reads, as tensors where they are: an index
    batch's packed pair (``ints``/``floats``; a host index batch is
    packed first) or a host batch's dense fields."""
    if "image_row" in batch:
        batch = pack_index_batch(batch)
    keys = ("ints", "floats") if "ints" in batch else DENSE_KEYS
    out = {}
    for k in keys:
        v = batch[k]
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v
    return out


def to_device(batch: Dict[str, object],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """The fields a step reads (``_fields``), as tensors on ``device``."""
    return {k: v.to(device) for k, v in _fields(batch).items()}


def _assemble_inputs(batch: Dict[str, torch.Tensor],
                     image_fn: Optional[Callable], n_answers: int):
    """(question, image, qlen, mask, answers_fn, score_fn) of a device
    batch: host mode reads the dense fields, cache mode gathers the
    images and densifies the labels on the device."""
    if "ints" in batch:
        batch = {**batch, **unpack_index_batch(batch)}
    if image_fn is None:
        if "image" not in batch:
            raise ValueError("an index batch needs a device feature cache")
        return (batch["question"], batch["image"], batch["qlen"],
                batch["mask"], lambda: batch["answers"],
                lambda logits, mask=None: vqa_score(logits, batch["votes"],
                                                    mask))
    image = image_fn(batch["image_row"])
    return (batch["question"], image, batch["qlen"], batch["mask"],
            lambda: densify_labels(batch["ans_idx"], batch["ans_score"],
                                   n_answers),
            lambda logits, mask=None: sparse_vqa_score(
                logits, batch["vote_idx"], batch["vote_val"], mask))


# ---------------- the one-card step as a CUDA graph ----------------

# each model's one graph (``_StepGraph``), of the key it last saw
_STEP_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# each model's one eval graph (``_EvalGraph``), of the key it last saw;
# a registry of its own, so that neither kind of key evicts the other
_EVAL_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def step_path(cuda: bool, one_rank: bool, hooked: bool,
              adam: Tuple[bool, bool, bool, bool, bool], seen: bool,
              captured: bool, static: bool) -> str:
    """How ``train_step`` runs a call, from what it observes: "eager" off
    a CUDA card, across ranks (a data-parallel mesh or a sharded
    optimizer), with a hook on the model, for an optimizer whose update
    a graph cannot hold, or for a key other than the model's last (that
    call is the key's warm-up); else "replay" of the key's graph while
    every parameter keeps the gradient tensor and the storage, and every
    moment the tensor and the storage, that its capture saw
    (``static``), and "capture" (then one replay) where there is no
    graph yet or they moved. ``adam`` is what ``adam_seen`` observes of
    the optimizer: a graph holds the port's ``Adam`` whose ``step`` is
    its class's own (not one set on the instance; the scheduler's
    counting wrapper of it is its own), with no step hook, not sharded
    over a model axis, over parameters all on the card."""
    port_adam, own_step, step_hooks, sharded, on_card = adam
    capturable = (port_adam and own_step and not step_hooks and not sharded
                  and on_card)
    if not (cuda and one_rank and capturable) or hooked or not seen:
        return "eager"
    return "replay" if captured and static else "capture"


def eval_path(cuda: bool, hooked: bool, seen: bool, captured: bool) -> str:
    """How ``eval_epoch`` runs a batch, from what it observes: "eager" off
    a CUDA card, with a hook on the model, or for the first batch of a
    key (``eval_key``) that the model has not seen (its warm-up); else
    "capture" (then one replay) where the key has no graph yet, and
    "replay" of its graph."""
    if not cuda or hooked or not seen:
        return "eager"
    return "replay" if captured else "capture"


def _own_step(optimizer) -> bool:
    cls_step = type(optimizer).step
    if cls_step is not Adam.step:
        return False
    step = vars(optimizer).get("step")
    # an LRScheduler wraps the step on the instance to count its calls
    return step is None or (getattr(step, "_wrapped_by_lr_sched", False)
                            and getattr(step, "__wrapped__", None)
                            is cls_step)


def adam_seen(optimizer) -> Tuple[bool, bool, bool, bool, bool]:
    """What ``step_path`` reads of ``optimizer``: (the port's Adam, its
    own step, a step hook, sharded, its parameters all on the card)."""
    from torch.optim import optimizer as torch_optimizer
    port = isinstance(optimizer, Adam)
    hooks = bool(getattr(optimizer, "_optimizer_step_pre_hooks", None)
                 or getattr(optimizer, "_optimizer_step_post_hooks", None)
                 or torch_optimizer._global_optimizer_pre_hooks
                 or torch_optimizer._global_optimizer_post_hooks)
    return (port, port and _own_step(optimizer), hooks,
            getattr(optimizer, "shards", None) is not None,
            port and all(p.is_cuda for g in optimizer.param_groups
                         for p in g["params"]))


def _hooked(model) -> bool:
    """A hook that a graph's replay would skip: a global module hook, a
    forward, pre- or backward hook on a module of the model, or a hook on
    a parameter."""
    from torch.nn.modules import module as mm
    if (mm._global_forward_hooks or mm._global_forward_pre_hooks
            or mm._global_backward_hooks or mm._global_backward_pre_hooks):
        return True
    if any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
           or m._backward_pre_hooks for m in model.modules()):
        return True
    return any(p._backward_hooks or p._post_accumulate_grad_hooks
               for p in model.parameters())


def _step_body(model, optimizer, fields: Dict[str, torch.Tensor],
               image_fn: Optional[Callable],
               generator: Optional[torch.Generator],
               n_valid: Optional[float] = None,
               reduce: Optional[Callable[[], None]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A step's work before the optimizer, which the eager step runs and
    the graph captures: the inputs on the model's device, the train-mode
    forward, the model's masked loss (``model.loss``; a mean over the
    global ``n_valid`` rows in a data-parallel step), the zeroing of the
    gradients, the backward and then ``reduce`` (the data-parallel sum,
    in its span ``train_step.allreduce``). Returns (loss, score,
    valid)."""
    dev = next(model.parameters()).device
    with annotate("train_step.inputs"):
        question, image, qlen, mask, answers_fn, score_fn = \
            _assemble_inputs({k: v.to(dev) for k, v in fields.items()},
                             image_fn, model.cfg.out_dim)
    with annotate("train_step.forward"):
        logits, _, _ = model(question, image, qlen, train=True,
                             generator=generator)
        # a fill, not a copy: the global count reaches the card as a
        # launch argument
        count = (None if n_valid is None else
                 torch.full((), float(n_valid), dtype=torch.float32,
                            device=dev))
        loss = model.loss(logits, answers_fn(), mask, count)
    with annotate("train_step.backward"):
        optimizer.zero_grad(set_to_none=True)
        if getattr(optimizer, "shards", None) is not None:
            # the sharded parameters' own
            model.zero_grad(set_to_none=True)
        loss.backward()
        if reduce is not None:
            with annotate("train_step.allreduce"):
                reduce()
    with torch.no_grad():
        return loss.detach(), score_fn(logits, mask), mask.sum()


class _Graph:
    """What a model's graphs share: the key, the graph, static inputs
    made at the first copy in, and each launch counter's count in the
    capture (``_build.COUNTED``), which every later replay adds."""

    def __init__(self, key: tuple):
        self.key = key
        self.graph = self.inputs = None
        self.launches = []

    def copy_in(self, fields: Dict[str, torch.Tensor], dev) -> None:
        if self.inputs is None:
            self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                           for k, v in fields.items()}
        for k, v in fields.items():
            self.inputs[k].copy_(v)

    def note_launches(self, before: list) -> None:
        self.launches = [(f, f.launches - n)
                         for f, n in zip(COUNTED, before) if f.launches != n]

    def count_launches(self) -> None:
        for f, n in self.launches:
            f.launches += n


class _StepGraph(_Graph):
    """A model's train-step graph for one key. ``refs`` (optimizer,
    generator, image_fn) keeps the objects whose ids the key holds
    alive. A capture makes the static inputs, the graph, its (3,) output
    and Adam's launches (``adam``: what ``Adam.capture_update``
    returned), and notes each parameter with the gradient tensor and the
    storage it saw, each captured parameter's moments, and the launch
    counts."""

    def __init__(self, key: tuple, refs: tuple):
        super().__init__(key)
        self.refs = refs
        self.out = self.adam = None
        self.params, self.moments = [], []

    def grads_static(self) -> bool:
        return all(p.grad is g and p.data_ptr() == ptr
                   for p, g, ptr in self.params)

    def adam_static(self, optimizer) -> bool:
        """Every captured moment is still its parameter's, where it
        was."""
        for p, mu, nu, ptrs in self.moments:
            st = optimizer.state.get(p)
            if (st is None or st.get("exp_avg") is not mu
                    or st.get("exp_avg_sq") is not nu
                    or (mu.data_ptr(), nu.data_ptr()) != ptrs):
                return False
        return True

    def capture(self, model, optimizer, generator, image_fn) -> None:
        # the old graph and its pool go first; the backward then writes
        # fresh gradients, which every replay overwrites in place
        self.graph = self.out = self.adam = None
        optimizer.zero_grad(set_to_none=True)
        before = [f.launches for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            # every replay advances it by what an eager step draws (the
            # default generator is registered by the capture itself)
            graph.register_generator_state(generator)
        buffers = optimizer.capture_buffers()
        # the loader's thread may pin memory while the capture runs
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.out = torch.stack(_step_body(model, optimizer, self.inputs,
                                              image_fn, generator))
            self.adam = optimizer.capture_update(buffers)
        self.graph = graph
        # the tables' one copy each, which a capture cannot hold
        for _, _, table in self.adam:
            table.upload()
        self.note_launches(before)
        self.params = [(p, p.grad, p.data_ptr()) for p in model.parameters()]
        self.moments = [(p, m, v, (m.data_ptr(), v.data_ptr()))
                        for _, _, table in self.adam
                        for p, m, v in zip(table.params, table.mus,
                                           table.nus)]

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.out.clone()


def _graph_entry(model, optimizer, generator, image_fn,
                 fields: Dict[str, torch.Tensor]):
    """(the model's ``_StepGraph``, ``step_path``'s answer) of a one-card
    call on the card. The key: every input's shape and dtype and the
    identity of the optimizer, the generator and ``image_fn``. A model
    keeps one graph: a key other than its last drops it, and the call
    runs eagerly as the new key's first. A graph recaptures where a
    gradient or a captured moment moved."""
    key = (tuple((k, tuple(v.shape), v.dtype) for k, v in fields.items()),
           id(optimizer), id(generator), id(image_fn))
    entry = _STEP_GRAPHS.get(model)
    seen = entry is not None and entry.key == key
    if not seen:
        entry = _STEP_GRAPHS[model] = _StepGraph(
            key, (optimizer, generator, image_fn))
    captured = entry.graph is not None
    path = step_path(True, True, _hooked(model), adam_seen(optimizer), seen,
                     captured, captured and entry.grads_static()
                     and entry.adam_static(optimizer))
    return entry, path


def _graphed_step(entry: _StepGraph, path: str, model, optimizer, scheduler,
                  fields, generator, image_fn,
                  dev) -> Dict[str, torch.Tensor]:
    with annotate("train_step.inputs"):
        entry.copy_in(fields, dev)
    if path == "capture":
        with annotate("train_step.capture"):
            entry.capture(model, optimizer, generator, image_fn)
    # the counts and this step's lr and bias corrections reach the card
    # before the replay that reads them
    _optimize(optimizer, scheduler, captured=entry.adam)
    with annotate("train_step.graph"):
        out = entry.replay()
        if path == "replay":
            # the capture ran the wrappers once; a replay runs none
            entry.count_launches()
    count("adam.graphed", 1)
    return {"loss": out[0], "score": out[1], "valid": out[2]}


def _optimize(optimizer, scheduler, captured: Optional[list] = None,
              shards=None) -> None:
    """The optimizer's part of a step, then the schedule's (which moves
    the lr on for the next step), in span ``train_step.optimizer``: with
    ``captured`` Adam's host part for its launch inside the graph
    (``Adam.graph_host_step``), else the optimizer's step, around which a
    sharded optimizer takes its rows of the gradients and gathers its
    rows of the parameters."""
    with annotate("train_step.optimizer"):
        if captured is not None:
            optimizer.graph_host_step(captured)
        else:
            if shards is not None:
                shards.load_grads()
            optimizer.step()
            if shards is not None:
                shards.gather()
        if scheduler is not None:
            scheduler.step()


def train_step(model, optimizer, scheduler, batch: Dict[str, object],
               generator: Optional[torch.Generator] = None,
               image_fn: Optional[Callable] = None,
               mesh: Optional[Mesh] = None, n_valid: Optional[float] = None,
               grad_reduce_dtype: str = "float32"
               ) -> Dict[str, torch.Tensor]:
    """One step: train-mode forward (dropout from ``generator``), the
    model's masked loss (``model.loss``: the conditioned-graph model's
    soft-margin mean, MCAN's summed BCE), backward, the optimizer and the
    scheduler.

    ``batch`` is a host batch (numpy or tensors) or, with ``image_fn``
    from ``make_image_fn``, an index batch (packed or not). Returns 0-d
    tensors on the model's device (reading them waits for the step):
    loss, score (the summed VQA score of the train-mode logits, padded
    rows 0) and valid (the count of unpadded rows).

    Inside a process group (``mesh.distributed``) ``batch`` is this
    rank's rows and ``n_valid`` the global batch's valid count: the loss
    is this rank's share of the global masked mean, and the gradients are
    summed over the data group in ``grad_reduce_dtype`` before the
    optimizer (bf16 only at world > 1, refused for a sharded cache or a
    model axis by the caller); the returned loss, score and valid are
    this rank's shares. On a (data, model) mesh the optimizer is
    ``parallel.tp.shard_optimizer``'s: it steps this rank's shards, and
    one all-gather over the model group then writes them into the whole
    parameters (``parallel/tp.py``).

    On one card (no process group, no sharded optimizer) with no hook on
    the model and the port's own Adam over parameters on the card, a
    call with the key (``_graph_entry``) of the call before runs as one
    CUDA graph: its device work (``_step_body``) and, after the
    backward, Adam's launch; the second call of a key captures, later
    ones replay, each after Adam's host part and the schedule. Every
    other call runs wholly eagerly (``step_path``). The graph's results,
    gradients, dropout draws, parameters, moments and counts are an
    eager step's, and each wrapper's ``.launches`` counts a replay as the
    step it replays. Every call counts ``adam.graphed``
    (``train.profiling.count``): 1 where it replayed the graph, else 0.

    Its spans (``train.profiling.annotate``): ``train_step`` around the
    call, and inside it ``train_step.inputs`` (the copy in, the unpack,
    the image gather; on the graph path the copy into the graph's
    inputs), ``.forward`` (the model, the loss and its labels),
    ``.backward`` (the zeroing, autograd's backward and, inside it,
    ``.allreduce``: the data-parallel sum) and ``.optimizer`` (the
    optimizer and the schedule; on the graph path Adam's host part and
    the schedule, before ``.graph``). On the
    graph path ``.graph`` (the replay and the copy of its results) takes
    the place of ``.forward`` and ``.backward``; a capture runs them,
    with a second ``.inputs``, inside ``.capture``.
    """
    dp = mesh is not None and mesh.distributed
    shards = getattr(optimizer, "shards", None)
    if dp and n_valid is None:
        raise ValueError("a data-parallel step needs the global batch's "
                         "valid count (n_valid)")
    if mesh is not None and mesh.tp > 1 and shards is None:
        raise ValueError("a tensor-parallel step needs the optimizer of "
                         "parallel.tp.shard_optimizer")
    if dp and mesh.world > 1 and grad_reduce_dtype == "bfloat16":
        ok, why = supports_bf16_reduce(getattr(image_fn, "feature_cache",
                                               None), mesh)
        if not ok:
            raise ValueError(
                f"grad_reduce_dtype=bfloat16 does not support {why}: it "
                "needs a replicated device feature cache or host-mode "
                "batches")
    with annotate("train_step"):
        dev = next(model.parameters()).device
        fields = _fields(batch)
        if dev.type == "cuda" and not dp and shards is None:
            entry, path = _graph_entry(model, optimizer, generator,
                                       image_fn, fields)
            if path != "eager":
                return _graphed_step(entry, path, model, optimizer,
                                     scheduler, fields, generator, image_fn,
                                     dev)
        loss, score, valid = _step_body(
            model, optimizer, fields, image_fn, generator,
            n_valid if dp else None,
            (lambda: all_reduce_grads(model, mesh, grad_reduce_dtype,
                                      mesh.data_group)) if dp else None)
        _optimize(optimizer, scheduler, shards=shards)
        count("adam.graphed", 0)
        return {"loss": loss, "score": score, "valid": valid}


def _eval_forward(model, b, image_fn):
    question, image, qlen, mask, _, score_fn = _assemble_inputs(
        b, image_fn, model.cfg.out_dim)
    logits, adjacency, _ = model(question, image, qlen)
    if model.pad_logit:
        # the last column, the answer vocabulary's pad slot, never wins:
        # it has no word and is never a label
        logits[:, -1] = float("-inf")
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    return preds, score_fn(logits, mask), adjacency


def eval_step(model, batch: Dict[str, object],
              image_fn: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eval forward of a host batch, or of an index batch with
    ``image_fn``: (preds (B,) int32, summed VQA score, adjacency
    (B, K, K) f32, None for MCAN), on the model's device."""
    dev = next(model.parameters()).device
    return _eval_forward(model, to_device(batch, dev), image_fn)


def stack_epoch_batches(batches: Sequence[Dict[str, np.ndarray]],
                        device) -> Tuple[Dict[str, torch.Tensor], int]:
    """Index batches as one resident epoch: each is packed
    (``pack_index_batch``), the (S, B, ...) stack of ints and float bits
    goes to ``device`` in ONE copy, and the result is the pair of views
    ``{"ints": (S, B, Wi) int32, "floats": (S, B, Wf) float32}`` with
    S = the number of batches."""
    if not batches:
        raise ValueError("an empty epoch")
    if "image_row" not in batches[0]:
        raise ValueError("a resident epoch needs index batches "
                         "(a device feature cache)")
    packed = [pack_index_batch(b) for b in batches]
    ints = np.stack([p["ints"] for p in packed])
    floats = np.ascontiguousarray(np.stack([p["floats"] for p in packed]))
    buf = torch.from_numpy(np.concatenate(
        [ints, floats.view(np.int32)], axis=-1)).to(device)
    wi = ints.shape[-1]
    return ({"ints": buf[..., :wi],
             "floats": buf[..., wi:].view(torch.float32)}, len(batches))


def eval_key(model, image_fn: Callable,
             fields: Dict[str, torch.Tensor]) -> tuple:
    """What the eval graph of one batch reads: each field's shape and
    dtype; the table of ``image_fn`` (``make_image_fn``'s), its
    ``.feature_cache`` (its type, and each of its fields, a tensor as its
    pointer, shape and dtype), and the gather's compute dtype and
    ``merged_block`` (``.gather``); every parameter's and buffer's
    pointer, so that a moved one recaptures. Never an object's id:
    ``evaluate`` makes a new image function every call, and a dead
    function's id may be reused."""
    cache = image_fn.feature_cache
    parts = cache if isinstance(cache, tuple) else vars(cache).values()
    table = tuple((v.data_ptr(), tuple(v.shape), v.dtype)
                  if torch.is_tensor(v) else v for v in parts)
    weights = tuple(t.data_ptr() for t in model.parameters())
    weights += tuple(t.data_ptr() for t in model.buffers())
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in fields.items()),
            type(cache), table, image_fn.gather, weights)


class _EvalGraph(_Graph):
    """A model's eval graph for one key. ``table`` (the image function's
    cache) keeps the tensors whose pointers the key holds alive. A
    capture makes the static inputs' graph of ``_eval_forward`` and its
    outputs, the predictions (B,) int32 and the summed score, and notes
    the launch counts."""

    def __init__(self, key: tuple, table):
        super().__init__(key)
        self.table = table
        self.preds = self.score = None

    def capture(self, model, image_fn) -> None:
        before = [f.launches for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        # a training loader's thread may pin memory while the capture runs
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.preds, self.score, _ = _eval_forward(model, self.inputs,
                                                      image_fn)
        self.graph = graph
        self.note_launches(before)


def _eval_entry(model, key: tuple, table) -> Tuple[_EvalGraph, bool]:
    """(the model's ``_EvalGraph`` of ``key``, whether the model had it):
    a model keeps one eval graph, and a key other than its last takes its
    place (``_EVAL_GRAPHS``, apart from the train step's graphs)."""
    entry = _EVAL_GRAPHS.get(model)
    if entry is not None and entry.key == key:
        return entry, True
    entry = _EVAL_GRAPHS[model] = _EvalGraph(key, table)
    return entry, False


def eval_epoch(model, epoch: Dict[str, torch.Tensor],
               image_fn: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward over every batch of a resident epoch
    (``stack_epoch_batches``): (summed VQA score, 0-d f32; preds (S, B)
    int32), both on the device. The loop over steps fetches nothing; the
    caller fetches the two results once.

    On a CUDA card with no hook on the model, a batch's forward
    (``_eval_forward``) runs as the CUDA graph of its key (``eval_key``),
    one graph a model: the first batch of a key that the model has not
    seen runs eagerly and warms up, the next captures, and every later
    one, across calls, copies its fields into the graph's inputs and
    replays (``eval_path``, the one rule). The graph reads the weights
    where they are, so an update in place (Adam, ``load_state_dict``)
    reaches the next replay. A replay's predictions and score are the
    eager forward's, and each wrapper's ``.launches`` counts it as the
    batch it replays. Every batch counts ``eval.graphed``
    (``train.profiling.count``): 1 where it replayed (the capture's
    included), else 0."""
    if image_fn is None:
        raise ValueError("a resident eval epoch needs a device feature "
                         "cache")
    ints, floats = epoch["ints"], epoch["floats"]
    s_steps, b = ints.shape[:2]
    dev = next(model.parameters()).device
    total = torch.zeros((), dtype=torch.float32, device=ints.device)
    preds = torch.empty((s_steps, b), dtype=torch.int32, device=ints.device)
    cuda, hooked = dev.type == "cuda", _hooked(model)
    key = eval_key(model, image_fn, {"ints": ints[0], "floats": floats[0]})
    entry, seen = None, False
    if cuda and not hooked:
        entry, seen = _eval_entry(model, key, image_fn.feature_cache)
    with device_guard(dev):
        for s in range(s_steps):
            fields = {"ints": ints[s], "floats": floats[s]}
            path = eval_path(cuda, hooked, seen,
                             seen and entry.graph is not None)
            if path == "eager":
                p, score, _ = _eval_forward(model, fields, image_fn)
            else:
                entry.copy_in(fields, dev)
                if path == "capture":
                    entry.capture(model, image_fn)
                entry.graph.replay()
                if path == "replay":
                    # the capture ran the wrappers once; a replay runs none
                    entry.count_launches()
                p, score = entry.preds, entry.score
            preds[s] = p
            total += score
            count("eval.graphed", int(path != "eager"))
            seen = entry is not None
    return total, preds
