"""Train and eval steps, in host mode and with a device feature cache.

Counterpart of ``vqa_project_tpu/train/steps.py``. Ingest modes:

- device-cache mode: region features and boxes live on the device
  (a ``(features, boxes)`` pair or a ``QuantizedFeatureCache``); a batch
  carries token ids, lengths, image rows and SPARSE answer/vote entries
  (``data.loader.pack_index_batch``), and the step gathers its images
  as the model's node rows in one launch (``make_image_fn``, a
  ``NodeImage``; for MCAN a ``RegionCache`` of feature-only rows and
  region counts, a ``RegionImage``) and densifies its labels on the
  device;
- host mode: the batch carries dense images, answers and votes.

One training step is forward, the model's masked loss (``model.loss``),
backward, Adam and the score;
``eval_epoch`` runs a whole resident eval epoch with no fetch inside its
loop.

On one card, ``train_step`` replays its device work (the inputs' unpack
and image gather, the forward, the loss, the backward and the score) as
one CUDA graph once it has seen a batch of the same shapes: the first
such call runs eagerly and warms up, the second captures, every later
one copies its batch into the graph's inputs and replays
(``step_path``). The port's own Adam over parameters on the card is
captured too, after the backward (``adam_path``), with its host part
(the counts, lr and the bias corrections) and the schedule run before
each replay; any other optimizer runs eagerly after it.

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
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vqa_project_tpu_torch.config import device_guard, torch_dtype
from vqa_project_tpu_torch.data.loader import DENSE_KEYS, pack_index_batch
from vqa_project_tpu_torch.ops._build import COUNTED
from vqa_project_tpu_torch.ops.gather_rows import (NodeImage,
                                                   gather_image_rows,
                                                   gather_region_rows)
from vqa_project_tpu_torch.ops.losses import vqa_score
from vqa_project_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from vqa_project_tpu_torch.parallel.sharded_cache import ShardedFeatureCache
from vqa_project_tpu_torch.train.profiling import annotate, count
from vqa_project_tpu_torch.train.state import Adam


class QuantizedFeatureCache(NamedTuple):
    """int8 device feature table with per-box dequantization scales
    (``ops.quant.quantize_feature_table``): a quarter of the f32 table's
    memory, half of bf16's. The gather dequantizes the rows to
    ``out_dtype``, which must be the model's compute dtype; the model is
    unchanged."""

    features: torch.Tensor   # (N, K, F) int8
    scales: torch.Tensor     # (N, K) float32
    boxes: torch.Tensor      # (N, K, 4) float32
    out_dtype: str           # dequantization target


class RegionCache(NamedTuple):
    """MCAN's device feature table: the region rows (N, K, F) in the
    cache dtype, and each image's count of live regions (N,) int32, its
    rows past the count zero (``data.store.region_counts``)."""

    features: torch.Tensor
    counts: torch.Tensor


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
    """``rows (B,) int32 -> NodeImage`` for a device feature cache, or
    None in host mode (no cache).

    One launch of ``gather_image_rows`` writes the model's input: the
    node rows feat||bbox in ``compute_dtype`` (an int8 cache dequantized
    there), in rows padded for the merged block when ``merged_block``,
    and the f32 boxes. An int8 cache must dequantize to ``compute_dtype``.
    A ``RegionCache`` (MCAN) gives ``rows -> RegionImage`` instead: the
    rows as the table holds them, by one launch of ``gather_region_rows``,
    with their region counts.
    """
    if feature_cache is None:
        return None
    if isinstance(feature_cache, RegionCache):
        features, counts = feature_cache

        def region_fn(rows):
            with device_guard(rows.device):
                return gather_region_rows(features, counts, rows)

        return region_fn
    if isinstance(feature_cache, ShardedFeatureCache):
        return feature_cache.gather_fn(compute_dtype, merged_block)
    node_dtype = torch_dtype(compute_dtype)
    if isinstance(feature_cache, QuantizedFeatureCache):
        features, scales, boxes, out = feature_cache
        if torch_dtype(out) != node_dtype:
            raise ValueError(f"the int8 cache dequantizes to {out}, the "
                             f"model computes in {compute_dtype}")
    else:
        (features, boxes), scales = feature_cache, None

    def image_fn(rows) -> NodeImage:
        with device_guard(rows.device):
            return gather_image_rows(features, boxes, rows, scales,
                                     node_dtype, padded=merged_block)

    return image_fn


def supports_bf16_reduce(feature_cache, mesh: Optional[Mesh] = None
                         ) -> Tuple[bool, Optional[str]]:
    """(ok, why): the bf16 gradient all-reduce takes the 1-D data mesh
    (tp = 1) and a replicated device cache or host mode; ``why`` names
    what it refuses. One rule for ``train_step``'s refusal and ``fit``'s
    degrade to float32 (JAX's ``supports_bf16_reduce``)."""
    if mesh is not None and mesh.tp > 1:
        return False, "a model-parallel mesh"
    if isinstance(feature_cache, ShardedFeatureCache):
        return False, f"a {type(feature_cache).__name__} feature cache"
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


def step_path(cuda: bool, one_rank: bool, hooked: bool, seen: bool,
              captured: bool, grads_static: bool) -> str:
    """How ``train_step`` runs a call, from what it observes: "eager" off
    a CUDA card, across ranks (a data-parallel mesh or a sharded
    optimizer), with a hook on the model, or for a key other than the
    model's last (that call is the key's warm-up); else "replay" of the
    key's graph while every parameter keeps the gradient tensor and the
    storage that its capture saw, and "capture" (then one replay) where
    there is no graph yet or they moved."""
    if not (cuda and one_rank) or hooked or not seen:
        return "eager"
    return "replay" if captured and grads_static else "capture"


def adam_path(port_adam: bool, own_step: bool, step_hooks: bool,
              sharded: bool, on_card: bool) -> str:
    """Where a graphed step runs its optimizer, from what it observes:
    "graph" (its launch captured after the backward, its host part run
    before each replay) for the port's ``Adam`` whose ``step`` is its
    class's own (not one set on the instance; the scheduler's counting
    wrapper of it is its own), with no step hook, not sharded over a
    model axis, over parameters all on the card; else "eager", after the
    replay."""
    ok = port_adam and own_step and not step_hooks and not sharded
    return "graph" if ok and on_card else "eager"


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
    """What ``adam_path`` reads of ``optimizer``."""
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


class _StepGraph:
    """A model's graph for one key. ``refs`` (optimizer, generator,
    image_fn) keeps the objects whose ids the key holds alive. A capture
    makes the static inputs, the graph and its (3,) output, and notes
    each parameter with the gradient tensor and the storage it saw, and
    each launch counter's count in the step (``_build.COUNTED``), which
    every later replay adds. With Adam inside (``adam``: what
    ``Adam.capture_update`` returned, None for an optimizer left out) it
    notes each captured parameter's moments too."""

    def __init__(self, key: tuple, refs: tuple):
        self.key, self.refs = key, refs
        self.graph = self.inputs = self.out = self.adam = None
        self.adam_wanted = False
        self.params, self.moments, self.launches = [], [], []

    def grads_static(self) -> bool:
        return all(p.grad is g and p.data_ptr() == ptr
                   for p, g, ptr in self.params)

    def adam_static(self, optimizer, adam: bool) -> bool:
        """The capture asked for Adam as ``adam`` does now, and every
        captured moment is still its parameter's, where it was."""
        if adam != self.adam_wanted:
            return False
        for p, mu, nu, ptrs in self.moments:
            st = optimizer.state.get(p)
            if (st is None or st.get("exp_avg") is not mu
                    or st.get("exp_avg_sq") is not nu
                    or (mu.data_ptr(), nu.data_ptr()) != ptrs):
                return False
        return True

    def copy_in(self, fields: Dict[str, torch.Tensor], dev) -> None:
        if self.inputs is None:
            self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                           for k, v in fields.items()}
        for k, v in fields.items():
            self.inputs[k].copy_(v)

    def capture(self, model, optimizer, generator, image_fn,
                adam: bool) -> None:
        # the old graph and its pool go first; the backward then writes
        # fresh gradients, which every replay overwrites in place
        self.graph = self.out = self.adam = None
        self.adam_wanted = adam
        optimizer.zero_grad(set_to_none=True)
        before = [f.launches for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            # every replay advances it by what an eager step draws (the
            # default generator is registered by the capture itself)
            graph.register_generator_state(generator)
        buffers = optimizer.capture_buffers() if adam else None
        # the loader's thread may pin memory while the capture runs
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.out = torch.stack(_step_body(model, optimizer, self.inputs,
                                              image_fn, generator))
            if adam:
                self.adam = optimizer.capture_update(buffers)
        self.graph = graph
        # the tables' one copy each, which a capture cannot hold
        for _, _, table in self.adam or ():
            table.upload()
        self.launches = [(f, f.launches - n)
                         for f, n in zip(COUNTED, before) if f.launches != n]
        self.params = [(p, p.grad, p.data_ptr()) for p in model.parameters()]
        self.moments = [(p, m, v, (m.data_ptr(), v.data_ptr()))
                        for _, _, table in self.adam or ()
                        for p, m, v in zip(table.params, table.mus,
                                           table.nus)]

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.out.clone()

    def count_launches(self) -> None:
        for f, n in self.launches:
            f.launches += n


def _graph_entry(model, optimizer, generator, image_fn,
                 fields: Dict[str, torch.Tensor], adam: bool = False):
    """(the model's ``_StepGraph``, ``step_path``'s answer) of a one-card
    call on the card, whose optimizer ``adam_path`` puts inside the graph
    where ``adam``. The key: every input's shape and dtype and the
    identity of the optimizer, the generator and ``image_fn``. A model
    keeps one graph: a key other than its last drops it, and the call
    runs eagerly as the new key's first. A graph recaptures where a
    gradient or a captured moment moved, or ``adam`` changed."""
    key = (tuple((k, tuple(v.shape), v.dtype) for k, v in fields.items()),
           id(optimizer), id(generator), id(image_fn))
    entry = _STEP_GRAPHS.get(model)
    seen = entry is not None and entry.key == key
    if not seen:
        entry = _STEP_GRAPHS[model] = _StepGraph(
            key, (optimizer, generator, image_fn))
    captured = entry.graph is not None
    path = step_path(True, True, _hooked(model), seen, captured,
                     captured and entry.grads_static()
                     and entry.adam_static(optimizer, adam))
    return entry, path


def _graphed_step(entry: _StepGraph, path: str, adam: bool, model, optimizer,
                  scheduler, fields, generator, image_fn,
                  dev) -> Dict[str, torch.Tensor]:
    with annotate("train_step.inputs"):
        entry.copy_in(fields, dev)
    if path == "capture":
        with annotate("train_step.capture"):
            entry.capture(model, optimizer, generator, image_fn, adam)
    inside = entry.adam is not None
    if inside:
        # the counts and this step's lr and bias corrections reach the
        # card before the replay that reads them
        _optimize(optimizer, scheduler, captured=entry.adam)
    with annotate("train_step.graph"):
        out = entry.replay()
        if path == "replay":
            # the capture ran the wrappers once; a replay runs none
            entry.count_launches()
    if not inside:
        _optimize(optimizer, scheduler)
    count("adam.graphed", int(inside))
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
    the model, a call with the key (``_graph_entry``) of the call before
    runs its device work before the optimizer (``_step_body``) as one
    CUDA graph: the second call of a key captures, later ones replay
    (``step_path``). The port's own Adam on the card is captured with it,
    after the backward; its host part and the schedule run before each
    replay (``adam_path``); another optimizer steps after the replay. Its
    results, gradients, dropout draws, parameters, moments and counts are
    an eager step's, and each wrapper's ``.launches`` counts a replay as
    the step it replays. Every call counts ``adam.graphed``
    (``train.profiling.count``): 1 where its Adam ran inside the replayed
    graph, else 0.

    Its spans (``train.profiling.annotate``): ``train_step`` around the
    call, and inside it ``train_step.inputs`` (the copy in, the unpack,
    the image gather; on the graph path the copy into the graph's
    inputs), ``.forward`` (the model, the loss and its labels),
    ``.backward`` (the zeroing, autograd's backward and, inside it,
    ``.allreduce``: the data-parallel sum) and ``.optimizer`` (the
    optimizer and the schedule; with Adam inside the graph its host part
    and the schedule, before ``.graph``). On the
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
            adam = adam_path(*adam_seen(optimizer)) == "graph"
            entry, path = _graph_entry(model, optimizer, generator,
                                       image_fn, fields, adam)
            if path != "eager":
                return _graphed_step(entry, path, adam, model, optimizer,
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


def eval_epoch(model, epoch: Dict[str, torch.Tensor],
               image_fn: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward over every batch of a resident epoch
    (``stack_epoch_batches``): (summed VQA score, 0-d f32; preds (S, B)
    int32), both on the device. The loop over steps fetches nothing; the
    caller fetches the two results once."""
    if image_fn is None:
        raise ValueError("a resident eval epoch needs a device feature "
                         "cache")
    ints, floats = epoch["ints"], epoch["floats"]
    s_steps, b = ints.shape[:2]
    total = torch.zeros((), dtype=torch.float32, device=ints.device)
    preds = torch.empty((s_steps, b), dtype=torch.int32, device=ints.device)
    for s in range(s_steps):
        p, score, _ = _eval_forward(
            model, {"ints": ints[s], "floats": floats[s]}, image_fn)
        preds[s] = p
        total += score
    return total, preds
